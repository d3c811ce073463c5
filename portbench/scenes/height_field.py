"""Scene kind "height_field": a displaced nx x nz grid of (nx-1)(nz-1)*2
triangles of one Lambertian material (a sine terrain with seeded noise),
over the spheres listed as in "sphere_list"."""

from __future__ import annotations

import numpy as np

from . import sphere_list


def grid(nx: int, nz: int, size: float, amp: float, seed: int):
    rng = np.random.default_rng(seed)
    xs = np.linspace(-size / 2, size / 2, nx)
    zs = np.linspace(-size / 2, size / 2, nz)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    y = amp * (np.sin(1.7 * x) * np.cos(1.3 * z)
               + 0.45 * np.sin(3.1 * x + 1.0) * np.sin(2.3 * z + 0.5))
    y += 0.05 * rng.standard_normal(y.shape)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    ij = np.arange(nx * nz).reshape(nx, nz)
    a, b = ij[:-1, :-1].ravel(), ij[1:, :-1].ravel()
    c, d = ij[:-1, 1:].ravel(), ij[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)])
    return verts, faces


def build(params: dict) -> dict:
    verts, faces = grid(int(params["nx"]), int(params["nz"]),
                        float(params["size"]), float(params["amp"]),
                        int(params["seed"]))
    f = len(faces)
    mesh = {"vertices": verts, "faces": faces,
            "mat": np.zeros(f, np.int64),
            "albedo": np.broadcast_to(np.asarray(params["albedo"], float),
                                      (f, 3)),
            "fuzz": np.zeros(f), "ior": np.full(f, 1.5),
            "emission": np.zeros((f, 3))}
    return {"spheres": sphere_list.rows(params["spheres"]), "mesh": mesh}
