"""Procedural mesh generators and mesh worlds (counterpart of
``qt_raytracer_tpu.models.meshes``; the same constructions, so the same
tensors bit for bit for the same BVH builder). Every world and camera
function takes ``device``: None is the CUDA card (and raises without one).

  - terrain_world: BASELINE config 4, a sine-displaced 224x224 grid (99,458
    triangles) over a ground sphere, with metal and glass hero spheres.
  - icosphere_world: a small mesh smoke scene.
  - cornell_box_world: BASELINE config 2, the true Cornell box: quad walls
    with per-face materials, an emissive ceiling quad (area light) and two
    rotated boxes, plus a small metal sphere.
"""

from __future__ import annotations

import numpy as np

from ..accel.mesh import MeshBuilder, build_mesh
from ..core.camera import make_camera
from ..core.scene import EMISSIVE, LAMBERTIAN, SceneBuilder
from ..core.world import World


def terrain_grid(nx: int = 224, nz: int = 224, size: float = 8.0,
                 amp: float = 0.55, seed: int = 0):
    """Sine+noise displaced height field: (nx-1)*(nz-1)*2 triangles.
    224x224 -> 99,458 tris."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-size / 2, size / 2, nx)
    zs = np.linspace(-size / 2, size / 2, nz)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    y = amp * (np.sin(1.7 * x) * np.cos(1.3 * z)
               + 0.45 * np.sin(3.1 * x + 1.0) * np.sin(2.3 * z + 0.5))
    y += 0.05 * rng.standard_normal(y.shape)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    ij = np.arange(nx * nz).reshape(nx, nz)
    a = ij[:-1, :-1].ravel()
    b = ij[1:, :-1].ravel()
    c = ij[:-1, 1:].ravel()
    d = ij[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)])
    return verts, faces


def icosphere(subdiv: int = 3, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Subdivided icosahedron: 20 * 4^subdiv triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    for _ in range(subdiv):
        cache: dict = {}
        verts = list(map(np.asarray, verts))

        def midpoint(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                cache[k] = len(verts)
                verts.append((verts[i] + verts[j]) / 2.0)
            return cache[k]

        new_faces = []
        for f in faces:
            m01 = midpoint(f[0], f[1])
            m12 = midpoint(f[1], f[2])
            m20 = midpoint(f[2], f[0])
            new_faces += [[f[0], m01, m20], [f[1], m12, m01],
                          [f[2], m20, m12], [m01, m12, m20]]
        faces = np.array(new_faces)
        verts = np.stack(verts)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return verts * radius + np.asarray(center), faces


def terrain_world(nx: int = 224, nz: int = 224, seed: int = 0,
                  builder: str = "auto", device=None) -> World:
    """~100k-tri terrain over a ground sphere with metal + glass heroes."""
    verts, faces = terrain_grid(nx, nz, seed=seed)
    mesh = build_mesh(verts, faces, mat_type=LAMBERTIAN,
                      albedo=(0.45, 0.55, 0.35), builder=builder, device=device)
    b = SceneBuilder()
    b.lambertian((0.0, -1001.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.metal((-2.0, 1.6, -2.0), 0.8, (0.8, 0.75, 0.65), 0.05)
    b.dielectric((2.2, 1.4, 1.0), 0.7, 1.5)
    return World(spheres=b.build(pad_to=128, device=device), mesh=mesh)


def terrain_camera(aspect_ratio: float, device=None):
    return make_camera(
        lookfrom=(6.5, 4.2, 7.5), lookat=(0.0, 0.2, 0.0), vup=(0, 1, 0),
        vfov=35.0, aspect_ratio=aspect_ratio, aperture=0.0, focus_dist=10.0,
        device=device)


def icosphere_world(subdiv: int = 3, builder: str = "auto",
                    device=None) -> World:
    """Small mesh smoke scene: icosphere over ground."""
    verts, faces = icosphere(subdiv, radius=1.0, center=(0.0, 1.0, 0.0))
    mesh = build_mesh(verts, faces, mat_type=LAMBERTIAN,
                      albedo=(0.75, 0.3, 0.25), builder=builder, device=device)
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.metal((2.2, 1.0, -0.5), 1.0, (0.7, 0.7, 0.8), 0.0)
    return World(spheres=b.build(pad_to=128, device=device), mesh=mesh)


def icosphere_camera(aspect_ratio: float, device=None):
    return make_camera(
        lookfrom=(0.0, 2.2, 7.0), lookat=(0.0, 1.0, 0.0), vup=(0, 1, 0),
        vfov=30.0, aspect_ratio=aspect_ratio, aperture=0.0, focus_dist=7.0,
        device=device)


def cornell_box_world(light_emission=(15.0, 15.0, 15.0),
                      builder: str = "auto", device=None) -> World:
    """The true Cornell box (BASELINE config 2), one TriangleMesh: quad walls
    with per-face materials, an emissive ceiling quad (the area light) and
    two rotated boxes; a small metal sphere sits on the short box.
    Interior: x,z in [-1,1], y in [0,2]; open front at z=+1."""
    white = (0.73, 0.73, 0.73)
    m = MeshBuilder()
    m.add_quad((-1, 0, -1), (0, 0, 2), (2, 0, 0), albedo=white)       # floor
    m.add_quad((-1, 2, -1), (2, 0, 0), (0, 0, 2), albedo=white)       # ceiling
    m.add_quad((-1, 0, -1), (2, 0, 0), (0, 2, 0), albedo=white)       # back
    m.add_quad((-1, 0, -1), (0, 2, 0), (0, 0, 2),
               albedo=(0.65, 0.05, 0.05))                             # left red
    m.add_quad((1, 0, -1), (0, 0, 2), (0, 2, 0),
               albedo=(0.12, 0.45, 0.15))                             # right green
    # Area light: ceiling quad, slightly below the ceiling plane.
    m.add_quad((-0.3, 1.995, -0.3), (0.6, 0, 0), (0, 0, 0.6),
               mat_type=EMISSIVE, emission=light_emission)
    m.add_box((-0.35, 0.6, -0.30), (0.6, 1.2, 0.6), rotate_y=18.0,
              albedo=white)
    m.add_box((0.40, 0.3, 0.35), (0.6, 0.6, 0.6), rotate_y=-15.0,
              albedo=white)
    mesh = m.build(builder=builder, device=device)

    b = SceneBuilder()
    b.metal((0.40, 0.78, 0.35), 0.18, (0.8, 0.85, 0.88), 0.0)
    return World(spheres=b.build(pad_to=128, device=device), mesh=mesh)


def cornell_box_mesh_camera(aspect_ratio: float, device=None):
    return make_camera(
        lookfrom=(0.0, 1.0, 3.6), lookat=(0.0, 1.0, 0.0), vup=(0, 1, 0),
        vfov=38.0, aspect_ratio=aspect_ratio, aperture=0.0, focus_dist=3.6,
        device=device)
