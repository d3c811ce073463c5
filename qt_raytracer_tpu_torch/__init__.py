"""qt_raytracer_tpu_torch — the path tracer in PyTorch, with CUDA kernels
written by hand for Hopper (sm_90a).

A port of ``qt_raytracer_tpu`` (JAX + Pallas for TPU), which stays the
reference: the same layout and names, held against it by the
``tests/test_torch_*.py`` modules. This package imports neither JAX nor
``qt_raytracer_tpu``.

Public API:
    render(scene, camera, config, seed) -> uint8 image [H, W, 3]
    render_linear(...)                  -> f32 linear radiance sum [H, W, 3]
    render_sample_batch(...)            -> the sum of a run of samples
    RenderConfig, AA_PRESETS, make_camera, SceneBuilder, SphereScene,
    World, as_world, TriangleMesh, MeshBuilder, build_mesh, tonemap
    models.scenes — three_sphere, four_sphere_gpu, random, glossy_dof,
    cornell, and the mesh worlds terrain, icosphere, cornell_mesh
    app — progressive and checkpointed renders, preview, the interactive
    viewer, stats, profiling and the CLI
    (``python -m qt_raytracer_tpu_torch.app.cli``)

Every constructor (``scenes.get_scene``, ``SceneBuilder.build``,
``make_camera``, ``build_mesh``, the converters of ``utils.convert``) builds
on the CUDA card and raises when there is none; ``device="cpu"`` asks for the
CPU, as the tests do. The render runs on the device of the scene's tensors.
"""

from .accel.mesh import MeshBuilder, TriangleMesh, build_mesh
from .core.camera import Camera, make_camera
from .core.config import AA_PRESETS, RenderConfig
from .core.render import render, render_linear, render_sample_batch
from .core.scene import (DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL,
                         SceneBuilder, SphereScene)
from .core.world import World, as_world
from .core import tonemap
from .models import scenes

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "make_camera",
    "RenderConfig",
    "AA_PRESETS",
    "render",
    "render_linear",
    "render_sample_batch",
    "SceneBuilder",
    "SphereScene",
    "World",
    "as_world",
    "TriangleMesh",
    "MeshBuilder",
    "build_mesh",
    "LAMBERTIAN",
    "METAL",
    "DIELECTRIC",
    "EMISSIVE",
    "scenes",
    "tonemap",
]
