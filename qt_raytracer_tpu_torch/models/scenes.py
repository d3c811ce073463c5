"""Sphere scenes and their cameras (counterpart of
``qt_raytracer_tpu.models.scenes``; the same constructions, so the same
tensors bit for bit). Scenes are built on the CPU: move them with
``.to(device)``.

  - three_sphere_scene: BASELINE config 1 (3 spheres + ground, diffuse).
  - four_sphere_gpu_scene: the scene the reference's GPU kernels hardcode.
  - random_scene: the book-cover scene (RayTracer.h:599-643).
  - glossy_dof_scene: BASELINE config 3.
  - cornell_box_spheres: Cornell-style box of spheres (BASELINE config 2).
"""

from __future__ import annotations

import numpy as np

from ..core.camera import Camera, make_camera
from ..core.scene import SceneBuilder, SphereScene


def three_sphere_scene(pad_to: int | None = 128) -> SphereScene:
    """Three diffuse spheres + ground."""
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.lambertian((0.0, 1.0, 0.0), 1.0, (0.7, 0.3, 0.3))
    b.lambertian((-2.5, 1.0, 0.0), 1.0, (0.3, 0.7, 0.3))
    b.lambertian((2.5, 1.0, 0.0), 1.0, (0.3, 0.3, 0.7))
    return b.build(pad_to=pad_to)


def three_sphere_camera(aspect_ratio: float) -> Camera:
    return make_camera(
        lookfrom=(0.0, 2.0, 8.0), lookat=(0.0, 1.0, 0.0), vup=(0.0, 1.0, 0.0),
        vfov=30.0, aspect_ratio=aspect_ratio, aperture=0.0, focus_dist=8.0,
    )


def four_sphere_gpu_scene(pad_to: int | None = 128) -> SphereScene:
    """The 4-sphere scene of GpuPathTracer.cpp:217-240."""
    b = SceneBuilder()
    b.lambertian((0.0, -100.5, -1.0), 100.5, (0.8, 0.8, 0.8))
    b.lambertian((0.0, 0.0, -1.0), 0.5, (0.9, 0.35, 0.3))
    b.lambertian((1.05, -0.05, -1.2), 0.45, (0.3, 0.6, 0.9))
    b.lambertian((-1.1, -0.1, -0.8), 0.4, (0.9, 0.8, 0.3))
    return b.build(pad_to=pad_to)


def four_sphere_gpu_camera(aspect_ratio: float) -> Camera:
    return make_camera(
        lookfrom=(0.0, 0.3, 1.2), lookat=(0.0, 0.0, -1.0), vup=(0.0, 1.0, 0.0),
        vfov=55.0, aspect_ratio=aspect_ratio, aperture=0.0, focus_dist=1.0,
    )


def random_scene(seed: int = 0, pad_to: int | None = 128) -> SphereScene:
    """Book-cover scene (RayTracer.h:599-643), 484 spheres from a seeded
    numpy Generator."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))

    for a in range(-11, 11):
        for c in range(-11, 11):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.random(3) * rng.random(3)
                b.lambertian(center, 0.2, albedo)
            elif choose_mat < 0.95:
                albedo = 0.5 + 0.5 * rng.random(3)
                fuzz = 0.5 * rng.random()
                b.metal(center, 0.2, albedo, fuzz)
            else:
                b.dielectric(center, 0.2, 1.5)

    b.dielectric((0.0, 1.0, 0.0), 1.0, 1.5)
    b.lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
    b.metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)
    return b.build(pad_to=pad_to)


def random_scene_camera(aspect_ratio: float) -> Camera:
    """The CPU RenderWorker camera (RayTracerFboItem.cpp:49-56)."""
    return make_camera(
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0),
        vfov=20.0, aspect_ratio=aspect_ratio, aperture=0.1, focus_dist=10.0,
    )


def glossy_dof_scene(pad_to: int | None = 128) -> SphereScene:
    """BASELINE config 3: glossy metal + dielectric + depth of field."""
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.dielectric((0.0, 1.0, 0.0), 1.0, 1.5)
    b.metal((-2.2, 1.0, -1.0), 1.0, (0.8, 0.6, 0.2), 0.15)
    b.metal((2.2, 1.0, 1.0), 1.0, (0.7, 0.7, 0.8), 0.0)
    b.lambertian((0.8, 0.4, 2.0), 0.4, (0.2, 0.4, 0.8))
    return b.build(pad_to=pad_to)


def glossy_dof_camera(aspect_ratio: float) -> Camera:
    return make_camera(
        lookfrom=(6.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0), vup=(0.0, 1.0, 0.0),
        vfov=25.0, aspect_ratio=aspect_ratio, aperture=0.4, focus_dist=8.5,
    )


def cornell_box_spheres(pad_to: int | None = 128) -> SphereScene:
    """Cornell-style enclosure of huge spheres + an emissive sphere light."""
    R = 1000.0
    b = SceneBuilder()
    b.lambertian((0.0, -R, 0.0), R, (0.73, 0.73, 0.73))          # floor
    b.lambertian((0.0, R + 2.0, 0.0), R, (0.73, 0.73, 0.73))     # ceiling
    b.lambertian((0.0, 1.0, -R - 2.0), R, (0.73, 0.73, 0.73))    # back
    b.lambertian((-R - 2.0, 1.0, 0.0), R, (0.65, 0.05, 0.05))    # left red
    b.lambertian((R + 2.0, 1.0, 0.0), R, (0.12, 0.45, 0.15))     # right green
    b.emissive((0.0, 2.2, 0.0), 0.4, (15.0, 15.0, 15.0))         # light
    b.lambertian((-0.7, 0.5, -0.5), 0.5, (0.73, 0.73, 0.73))
    b.metal((0.8, 0.45, 0.3), 0.45, (0.8, 0.85, 0.88), 0.0)
    return b.build(pad_to=pad_to)


def cornell_box_camera(aspect_ratio: float) -> Camera:
    return make_camera(
        lookfrom=(0.0, 1.0, 4.5), lookat=(0.0, 1.0, 0.0), vup=(0.0, 1.0, 0.0),
        vfov=40.0, aspect_ratio=aspect_ratio, aperture=0.0, focus_dist=4.5,
    )


SCENES = {
    "three_sphere": (three_sphere_scene, three_sphere_camera),
    "four_sphere_gpu": (four_sphere_gpu_scene, four_sphere_gpu_camera),
    "random": (random_scene, random_scene_camera),
    "glossy_dof": (glossy_dof_scene, glossy_dof_camera),
    "cornell": (cornell_box_spheres, cornell_box_camera),
}

MESH_SCENES = ("terrain", "icosphere", "cornell_mesh")


def get_scene(name: str, aspect_ratio: float, **kwargs):
    """Look up (scene, camera) by name, both on the CPU."""
    if name in MESH_SCENES:
        raise NotImplementedError(
            f"mesh scene {name!r} is not ported yet: ROADMAP Queue A item 5 "
            "(mesh worlds, kernel A3)")
    if name not in SCENES:
        raise KeyError(
            f"unknown scene {name!r}; choices: "
            f"{sorted(SCENES) + sorted(MESH_SCENES)}")
    build, cam = SCENES[name]
    return build(**kwargs), cam(aspect_ratio)
