"""BVH traversal: the portable mesh search of ``intersector="xla"``
(counterpart of ``qt_raytracer_tpu.accel.traverse``).

Every ray carries one node pointer through the escape-index layout
(``accel/bvh.py``): hit an inner box -> step to i + 1; miss, or finish a
leaf -> jump to escape[i]. On CUDA tensors ``intersect_mesh`` launches the
walk kernel (``kernels.bvh_walk``, one thread a ray); on CPU tensors it runs
the kernel's plain version, the JAX package's lockstep masked walk, built
from ``_slab_test`` and ``_tri_hit_one`` below. Outputs are detached:
callers re-derive differentiable quantities from ``tri_idx``
(``core.world._tri_t_diff``). ``intersect_mesh_brute`` is the brute-force
reference of the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import vecmath as vm
from ..runtime.spans import HIT_MESH, spanned
from .mesh import TriangleMesh, TriHit, _dot3, moller_trumbore

BIG = float(np.float32(3.0e38))


def _slab_test(bmin, bmax, o, inv_d, t_min: float, t_max):
    """Batched AABB slab test (RayTracer.h:229-244 semantics): exit > enter
    of boxes [N,3] against rays [N,3] (inv_d their slab reciprocals) under
    t_min and the per-lane cap t_max [N]."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    enter = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), t_min)
    exit_ = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), t_max)
    return exit_ > enter


def _tri_hit_one(mesh: TriangleMesh, tri_idx, o, d, t_min: float, t_max):
    """Moller-Trumbore of ONE (per-lane different) triangle per ray: t [N],
    BIG where the hit is not valid under [t_min, t_max] (both inclusive).
    Single rounded op by op, cross products in jnp.cross's component order
    (vecmath.cross) and dots summed left to right, as the walk kernel
    computes it."""
    tri = tri_idx.long()
    v0, e1, e2 = mesh.v0[tri], mesh.e1[tri], mesh.e2[tri]
    p = vm.cross(d, e2)
    det = _dot3(p, e1)
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    s = o - v0
    u = _dot3(s, p) * inv_det
    q = vm.cross(s, e1)
    v = _dot3(q, d) * inv_det
    t = _dot3(q, e2) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t <= t_max))
    return torch.where(ok, t, BIG)


@spanned(HIT_MESH)
def intersect_mesh(mesh: TriangleMesh, origins, directions, t_min,
                   t_max=BIG, max_leaf: int = 4, alive=None,
                   exclude=None) -> TriHit:
    """Closest triangle hit for N rays, detached (the walk picks the winner;
    callers re-derive differentiable quantities from tri_idx). t_max: a
    float cap, inclusive. Ties go to the first triangle the walk visits.

    exclude: optional [N] integer triangle index masked out of each ray's
    search (-1 = none): the mesh-silhouette boundary term's background
    re-trace (diff/edge.py). Raises ValueError when a leaf of the mesh holds
    more than max_leaf triangles (the JAX package skips the rest)."""
    from ..kernels.bvh_walk import bvh_walk

    t, idx = bvh_walk(mesh, origins.detach(), directions.detach(),
                      float(t_min), float(t_max), max_leaf=max_leaf,
                      alive=alive, exclude=exclude)
    return TriHit(t=t, tri_idx=idx, hit=t < BIG)


def intersect_mesh_brute(mesh: TriangleMesh, origins, directions, t_min,
                         t_max=BIG) -> TriHit:
    """Reference brute force over all triangles (tests and small meshes):
    the lowest id wins a tie."""
    with torch.no_grad():
        ts = moller_trumbore(mesh.v0, mesh.e1, mesh.e2, origins.detach(),
                             directions.detach(), t_min, t_max)
        idx = torch.argmin(ts, dim=1).to(torch.int32)
        t = torch.gather(ts, 1, idx[:, None].long())[:, 0]
    return TriHit(t=t, tri_idx=idx, hit=t < BIG)
