"""qt_raytracer_tpu_torch — the path tracer in PyTorch, with CUDA kernels
written by hand for Hopper (sm_90a).

A port of ``qt_raytracer_tpu`` (JAX + Pallas for TPU), which stays the
reference: the same layout and names, held against it by the
``tests/test_torch_*.py`` modules. This package imports neither JAX nor
``qt_raytracer_tpu``.

Public API:
    render(scene, camera, config, seed) -> uint8 image [H, W, 3]
    render_linear(...)                  -> f32 linear radiance sum [H, W, 3]
    RenderConfig, make_camera, SceneBuilder, SphereScene
    models.scenes — three_sphere, four_sphere_gpu, random, glossy_dof, cornell

The render runs on the device of the scene's tensors: build a scene and its
camera, move both with ``.to("cuda")``, and render.
"""

from .core.camera import Camera, make_camera
from .core.config import RenderConfig
from .core.render import render, render_linear
from .core.scene import (DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL,
                         SceneBuilder, SphereScene)
from .models import scenes

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "make_camera",
    "RenderConfig",
    "render",
    "render_linear",
    "SceneBuilder",
    "SphereScene",
    "LAMBERTIAN",
    "METAL",
    "DIELECTRIC",
    "EMISSIVE",
    "scenes",
]
