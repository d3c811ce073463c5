"""The escape-index BVH walk: the CUDA kernel's wrapper and its plain
version (counterpart of ``qt_raytracer_tpu.accel.traverse.intersect_mesh``,
the JAX package's portable mesh search; it has no TPU kernel).

Per ray, the closest triangle of a ``TriangleMesh`` found by walking its
flattened BVH with one node pointer (``accel/bvh.py``'s layout: a hit on an
inner box steps to i + 1, a miss or a finished leaf jumps to escape[i]):
``t`` (BIG on a miss) and the BVH-order triangle id ``idx`` (0 on a miss).
Each leaf tests its first ``max_leaf`` triangles under the inclusive cap
min(t_best, t_max), and a triangle wins on a strict t < t_best, so a tie
goes to the first triangle the walk visits, where the clustered search (A3)
gives it to the lowest id. ``exclude``: an optional [N] triangle id each lane
never accepts (-1 for none), the edge-aware background re-trace.

``bvh_walk`` launches ``qtrt_bvh_walk`` (``csrc/bvh_walk.cu``) for CUDA
tensors and takes ``bvh_walk_plain`` only for CPU tensors or with
``interpret=True``; on a CUDA tensor it launches the kernel or raises. Dead
lanes read (BIG, 0). Outputs are detached.

The JAX package walks a mesh with ``max_leaf=4`` whatever leaf size the mesh
was built with, and so silently skips the triangles of a larger leaf. The
port refuses such a mesh instead: ``bvh_walk`` raises ValueError when a leaf
holds more than ``max_leaf`` triangles. Its largest leaf is read once per
mesh and remembered.
"""

from __future__ import annotations

import weakref

import torch

from ..accel.mesh import TriangleMesh
from ..accel.traverse import BIG, _slab_test, _tri_hit_one
from ..runtime import cuda_build
from .fused_hit import check_exclude, excl_ptr, launch_counts
from .mesh_intersect import slab_inv

# id(bvh_count) -> (a weak reference to it, its largest leaf).
_leaf_sizes: dict[int, tuple] = {}


def largest_leaf(mesh: TriangleMesh) -> int:
    """The most triangles a leaf of mesh's BVH holds (read once per mesh)."""
    cnt = mesh.bvh_count
    hit = _leaf_sizes.get(id(cnt))
    if hit is not None and hit[0]() is cnt:
        return hit[1]
    size = int(cnt.max())
    if len(_leaf_sizes) > 64:
        _leaf_sizes.clear()
    _leaf_sizes[id(cnt)] = (weakref.ref(cnt), size)
    return size


def _check(mesh: TriangleMesh, origins, directions, alive, max_leaf):
    n = origins.shape[0]
    dev = origins.device
    for x in (origins, directions):
        if x.dtype != torch.float32 or x.shape != (n, 3) or x.device != dev:
            raise ValueError("origins and directions must be [N, 3] float32 "
                             "tensors on one device")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"the walk takes 0 < N < 2^31 rays, got {n}")
    if alive is not None and (alive.dtype != torch.bool or alive.shape != (n,)
                              or alive.device != dev):
        raise ValueError("alive must be an [N] bool tensor on the rays' "
                         "device")
    m, tris = mesh.bvh_escape.shape[0], mesh.v0.shape[0]
    for names, dtype, shape in (
            (("bvh_min", "bvh_max"), torch.float32, (m, 3)),
            (("bvh_escape", "bvh_start", "bvh_count"), torch.int32, (m,)),
            (("v0", "e1", "e2"), torch.float32, (tris, 3))):
        for name in names:
            x = getattr(mesh, name)
            if x.dtype != dtype or x.shape != shape:
                raise ValueError(
                    f"mesh.{name} must be {list(shape)} {dtype}, got "
                    f"{list(x.shape)} {x.dtype}")
            if x.device != dev:
                raise ValueError("the mesh must lie on the rays' device")
    if m == 0 or tris == 0:
        raise ValueError("the mesh has no nodes or no triangles")
    if not isinstance(max_leaf, int) or max_leaf < 1:
        raise ValueError(f"max_leaf must be a positive int, got {max_leaf!r}")
    leaf = largest_leaf(mesh)
    if leaf > max_leaf:
        raise ValueError(
            f"the mesh has a leaf of {leaf} triangles and the walk tests "
            f"{max_leaf} a leaf: build it with max_leaf <= {max_leaf} or walk "
            f"it with max_leaf >= {leaf}")


def bvh_walk(mesh: TriangleMesh, origins: torch.Tensor,
             directions: torch.Tensor, t_min: float, t_max: float = BIG, *,
             max_leaf: int = 4, alive=None, exclude=None,
             interpret: bool = False):
    """Closest triangle hit of rays origins/directions [N, 3] with t in
    [t_min, t_max] (a float): (t [N] f32, BIG = miss; idx [N] i32),
    detached. alive: optional [N] bool; dead lanes read (BIG, 0). exclude:
    optional [N] integer BVH-order triangle id left out of each lane's walk
    (-1 for none)."""
    dev = origins.device
    kernel = cuda_build.use_kernel(dev, interpret, "bvh_walk")
    _check(mesh, origins, directions, alive, max_leaf)
    exclude = check_exclude(exclude, origins[:, 0])
    if not kernel:
        return bvh_walk_plain(mesh, origins, directions, t_min, t_max,
                              max_leaf=max_leaf, alive=alive, exclude=exclude)
    if alive is None:
        alive = torch.ones(origins.shape[0], dtype=torch.bool, device=dev)
    return _launch(mesh, origins.detach().contiguous(),
                   directions.detach().contiguous(), alive.contiguous(),
                   exclude, float(t_min), float(t_max), max_leaf)


def _launch(mesh: TriangleMesh, o, d, alive, exclude, t_min: float,
            t_max: float, max_leaf: int):
    """The kernel on checked operands: (t, idx)."""
    dev = o.device
    bmin, bmax, esc, start, count, v0, e1, e2 = (
        x.detach().contiguous() for x in (
            mesh.bvh_min, mesh.bvh_max, mesh.bvh_escape, mesh.bvh_start,
            mesh.bvh_count, mesh.v0, mesh.e1, mesh.e2))
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    cuda_build.launch(
        "qtrt_bvh_walk", o.data_ptr(), d.data_ptr(), alive.data_ptr(),
        excl_ptr(exclude), bmin.data_ptr(), bmax.data_ptr(), esc.data_ptr(),
        start.data_ptr(), count.data_ptr(), esc.shape[0], v0.data_ptr(),
        e1.data_ptr(), e2.data_ptr(), v0.shape[0], max_leaf, t_min, t_max,
        n, t.data_ptr(), idx.data_ptr(), device=dev,
        counted=launch_counts("bvh_walk", exclude))
    return t, idx


def bvh_walk_plain(mesh: TriangleMesh, origins, directions, t_min: float,
                   t_max: float = BIG, *, max_leaf: int = 4, alive=None,
                   exclude=None, count: bool = False):
    """The kernel's walk in plain PyTorch: every lane steps through the tree
    in lockstep under masks (JAX traverse.py:88-122), the lanes still
    walking gathered at each step; the box and triangle tests are
    ``accel.traverse``'s. (t, idx); with count=True, (t, idx,
    boxes, tris): the node boxes and the triangles the live lanes tested,
    summed, for the kernel's bound."""
    with torch.no_grad():
        o, d = origins.detach(), directions.detach()
        n = o.shape[0]
        dev = o.device
        m = mesh.bvh_escape.shape[0]
        last = mesh.num_triangles - 1
        inv = slab_inv(d)
        t_best = torch.full((n,), BIG, dtype=torch.float32, device=dev)
        best = torch.zeros(n, dtype=torch.int32, device=dev)
        ptr = torch.zeros(n, dtype=torch.int64, device=dev)
        if alive is not None:
            ptr = torch.where(alive, ptr, m)
        lanes = torch.nonzero(ptr < m).squeeze(1)
        boxes = tris = 0
        while lanes.numel():
            p = ptr[lanes]
            ol, il = o[lanes], inv[lanes]
            tb, ib = t_best[lanes], best[lanes]
            box_ok = _slab_test(mesh.bvh_min[p], mesh.bvh_max[p], ol, il,
                                float(t_min),
                                torch.clamp_max(tb, float(t_max)))
            cnt = mesh.bvh_count[p]
            leaf = cnt > 0
            at_leaf = torch.nonzero(box_ok & leaf).squeeze(1)
            if at_leaf.numel():
                ll = lanes[at_leaf]
                ol, dl = o[ll], d[ll]
                ex = None if exclude is None else exclude[ll]
                start, c = mesh.bvh_start[p[at_leaf]], cnt[at_leaf]
                tl, il_ = tb[at_leaf], ib[at_leaf]
                for k in range(max_leaf):
                    tri = torch.clamp_max(start + k, last)
                    t_k = _tri_hit_one(mesh, tri, ol, dl, float(t_min),
                                       torch.clamp_max(tl, float(t_max)))
                    take = (k < c) & (t_k < tl)
                    if ex is not None:
                        take = take & (tri != ex)
                    tl = torch.where(take, t_k, tl)
                    il_ = torch.where(take, tri, il_)
                tb[at_leaf], ib[at_leaf] = tl, il_
                if count:
                    tris += int(torch.clamp_max(c, max_leaf).sum())
            if count:
                boxes += lanes.numel()
            nxt = torch.where(box_ok & ~leaf, p + 1,
                              mesh.bvh_escape[p].long())
            ptr[lanes] = nxt
            t_best[lanes], best[lanes] = tb, ib
            lanes = lanes[nxt < m]
    if count:
        return t_best, best, boxes, tris
    return t_best, best
