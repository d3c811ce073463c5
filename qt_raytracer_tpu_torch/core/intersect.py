"""Ray-sphere intersection of the gradient integrator (counterpart of
``qt_raytracer_tpu.core.intersect``).

Two searches pick the winner. Under ``backend="pallas"`` it is the kernel
(A5, or A6 from 1,024 slots on, both in ``kernels.sphere_intersect``),
detached; under ``backend="xla"`` it is the JAX package's portable [N, S]
search, ``sphere_hit_ts`` and an argmin, in PyTorch ops. Every
differentiable quantity is re-derived from the winner's row of
``packed_param_table(scene)`` with the well-conditioned oc form and stable
(Citardauq) roots; under "xla" the search's own t also keeps its gradient
where the refinement falls back to it, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import vecmath as vm
from .scene import SphereScene

# +inf stand-in, f32-exact (the kernels' BIG).
BIG = float(np.float32(3.0e38))


class Hits(NamedTuple):
    """SoA hit record batch (HitRecord, RayTracer.h:208-219), with the
    winning primitive's material parameters riding along."""

    t: torch.Tensor           # [N] hit distance (BIG when miss)
    prim_idx: torch.Tensor    # [N] i32 nearest primitive (0 if miss)
    hit: torch.Tensor         # [N] bool
    point: torch.Tensor       # [N,3] hit point
    normal: torch.Tensor      # [N,3] forward-facing normal
    front_face: torch.Tensor  # [N] bool
    mat_type: torch.Tensor    # [N] i32 material tag of the winner
    albedo: torch.Tensor      # [N,3]
    fuzz: torch.Tensor        # [N]
    ior: torch.Tensor         # [N]
    emission: torch.Tensor    # [N,3]
    radius: torch.Tensor      # [N] winner sphere radius (0 for triangles)
    area: torch.Tensor        # [N] winner face area (0 for spheres)


def packed_param_table(scene: SphereScene) -> torch.Tensor:
    """[S,16] f32 row table: cx cy cz r | ax ay az fuzz | ior mat ex ey | ez pad."""
    s = scene.num_spheres
    return torch.cat([
        scene.center,                                   # 0,1,2
        scene.radius[:, None],                          # 3
        scene.albedo,                                   # 4,5,6
        scene.fuzz[:, None],                            # 7
        scene.ior[:, None],                             # 8
        scene.mat_type[:, None].to(torch.float32),      # 9
        scene.emission,                                 # 10,11,12
        torch.zeros((s, 3), dtype=torch.float32, device=scene.device),
    ], dim=1)


def sphere_hit_ts(scene: SphereScene, origins, directions, t_min,
                  t_max=BIG, exclude=None) -> torch.Tensor:
    """Per-(ray, sphere) nearest valid root, [N, S]; BIG where no valid hit
    (Sphere::hit root selection, RayTracer.h:289-305): the near root
    (-half_b - sqrtd) / a, else the far one, in [t_min, t_max].

    The cross terms d.c and o.c are the JAX package's two [N,3] @ [3,S]
    products, written out over the three components and summed left to
    right: full float32 whatever the global TF32 switch of the card's
    matrix products says (reduced-precision products make phantom hits on
    small spheres). exclude: optional [N] integer sphere id whose column is
    masked for that ray (-1 for none), the edge-aware background re-trace.
    """
    o, d = origins, directions
    c, r = scene.center, scene.radius
    dot_c = lambda x: (x[:, 0:1] * c[:, 0] + x[:, 1:2] * c[:, 1]) \
        + x[:, 2:3] * c[:, 2]                              # [N,S]
    a = vm.length_squared(d)[:, None]
    half_b = vm.dot(o, d)[:, None] - dot_c(d)
    cterm = (vm.length_squared(o)[:, None] - 2.0 * dot_c(o)
             + (vm.length_squared(c) - r * r)[None, :])
    disc = half_b * half_b - a * cterm
    sqrtd = vm.safe_sqrt(disc)
    inv_a = 1.0 / a
    root_near = (-half_b - sqrtd) * inv_a
    root_far = (-half_b + sqrtd) * inv_a
    in_range = lambda t: (t >= t_min) & (t <= t_max)
    near_ok = in_range(root_near)
    root = torch.where(near_ok, root_near, root_far)
    valid = (disc >= 0.0) & (near_ok | in_range(root_far)) \
        & scene.active[None, :]
    if exclude is not None:
        ids = torch.arange(c.shape[0], device=c.device)
        valid = valid & (ids[None, :] != exclude[:, None])
    return torch.where(valid, root, BIG)


def intersect_spheres(scene: SphereScene, origins, directions, t_min,
                      t_max=BIG, backend: str = "pallas", alive=None,
                      exclude=None) -> Hits:
    """Closest hit over all spheres (HitableList::hit, RayTracer.h:339-353).

    backend: "pallas" (kernel A5 on CUDA tensors, its plain version on CPU
    tensors), "pallas_interpret" (the plain version on any device) or
    "xla" (the [N, S] search of sphere_hit_ts and an argmin, on any device;
    it ignores alive, as in JAX). The kernel search is detached; t, point
    and normal are re-derived differentiably. Ties resolve to the lowest
    sphere index. exclude: optional [N] integer sphere id left out of each
    lane's search (-1 for none; under "pallas", scenes below 1,024 slots
    only: the clustered sweep raises ValueError)."""
    if backend == "xla":
        ts = sphere_hit_ts(scene, origins, directions, t_min, t_max,
                           exclude=exclude)                       # [N,S]
        prim_idx = torch.argmin(ts, dim=1).to(torch.int32)        # [N]
        t_coarse = torch.gather(ts, 1, prim_idx[:, None].long())[:, 0]
    elif backend in ("pallas", "pallas_interpret"):
        from ..kernels.sphere_intersect import sphere_search

        t_coarse, prim_idx = sphere_search(
            scene, origins, directions, float(t_min),
            interpret=backend == "pallas_interpret", alive=alive,
            exclude=exclude)
    else:
        raise ValueError(f"unknown intersect_spheres backend {backend!r}")
    hit = t_coarse < BIG

    params = vm.gather_rows(packed_param_table(scene), prim_idx)  # [N,16]
    c_sel = params[:, 0:3]
    r_sel = params[:, 3]

    # Refinement in the well-conditioned oc = o - c form (Sphere::hit,
    # RayTracer.h:289-305) with the stable roots: q carries the
    # non-cancelling sum, the other root is c1/q.
    oc = origins - c_sel
    a1 = vm.length_squared(directions)
    half_b1 = vm.dot(oc, directions)
    c1 = vm.length_squared(oc) - r_sel * r_sel
    disc1 = half_b1 * half_b1 - a1 * c1
    sqrtd1 = vm.safe_sqrt(disc1)
    sq_signed = torch.where(half_b1 >= 0.0, sqrtd1, -sqrtd1)
    q1 = -half_b1 - sq_signed
    q1_safe = torch.where(q1 == 0.0, 1.0, q1)
    root_a = q1 / a1
    root_b = torch.where(q1 == 0.0, 0.0, c1 / q1_safe)
    near1 = torch.where(half_b1 >= 0.0, root_a, root_b)
    far1 = torch.where(half_b1 >= 0.0, root_b, root_a)
    near_ok1 = (near1 >= t_min) & (near1 <= t_max)
    t_fine = torch.where(near_ok1, near1, far1)
    fine_ok = (disc1 >= 0.0) & (near_ok1 | ((far1 >= t_min)
                                            & (far1 <= t_max)))
    t = torch.where(hit & fine_ok, t_fine, t_coarse)

    # Miss lanes carry t = BIG; o + BIG*d overflows, and inf in the untaken
    # branch of a where turns the backward pass into NaN (inf * 0). The
    # geometry of a miss lane is masked anyway: use t = 1 there.
    t_safe = torch.where(hit, t, 1.0)
    point = origins + t_safe[:, None] * directions
    outward = (point - c_sel) / torch.where(r_sel == 0.0, 1.0, r_sel)[:, None]
    front_face = vm.dot(directions, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return Hits(t=t, prim_idx=prim_idx, hit=hit, point=point, normal=normal,
                front_face=front_face,
                mat_type=params[:, 9].to(torch.int32),
                albedo=params[:, 4:7], fuzz=params[:, 7], ior=params[:, 8],
                emission=params[:, 10:13], radius=r_sel,
                area=torch.zeros_like(t))
