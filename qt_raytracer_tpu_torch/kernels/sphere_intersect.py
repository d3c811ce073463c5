"""Sphere closest-hit search of the gradient integrator: the CUDA kernels'
wrapper and their plain versions (counterpart of
``qt_raytracer_tpu.kernels.sphere_intersect``, kernels A5 and A6).

Per ray, the closest valid root over every sphere slot: ``t`` is the
unrefined sweep minimum (BIG on a miss) and ``idx`` the lowest winning id (0
on a miss). The table is the TPU kernel's: inactive slots biased by +BIG,
padded to a multiple of 64 slots parked at 1e9. Both outputs are detached:
``core.intersect.intersect_spheres`` re-derives every differentiable
quantity from ``idx``.

Below 16 chunks of 64 slots the search is the monolithic sweep (A5,
``qtrt_sphere_search`` in ``csrc/fused_hit.cu``, the A2 sweep behind its own
entry), with an optional per-lane ``exclude`` operand: the slot id each lane
leaves out of its sweep (-1 for none; a slot id equals the scene's sphere
id), masked before the minimum. From 16 chunks (1,024 slots) on it is the
cluster-culled sweep (A6, ``qtrt_sphere_search_clustered``): spheres are
Morton-ordered at scene build, so each chunk of 64 consecutive slots is a
tight cluster behind an AABB, and a 128-ray row sweeps a chunk only when
some live lane's slab test crosses its box; inside an opened chunk the
kernel runs A5's group gate, which drops no candidate
(``sphere_search_clustered_gated_plain`` runs both gates). The clustered
sweep takes no exclude operand and raises ValueError when given one, as
the TPU wrapper does.

``sphere_search`` launches the kernels for CUDA tensors, and takes
``sphere_search_plain`` / ``sphere_search_clustered_plain`` only for CPU
tensors or with ``interpret=True``; on a CUDA tensor it launches the kernel
or raises. Dead lanes read (BIG, 0): the kernels gate each lane, where the
TPU kernels skip whole dead 128-ray rows and search the dead lanes of live
rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import vecmath as vm
from ..core.scene import SphereScene
from ..runtime import cuda_build
from .fused_hit import (BIG, GROUP_S, PLAIN_SLICE, _sweep, check_exclude,
                        excl_ptr, group_gate, launch_counts, min_then_match,
                        sweep_boxes, sweep_candidates)
from .mesh_intersect import slab_inv

CHUNK_S = 64                 # the table is padded to a multiple of this
MIN_CHUNKS_FOR_CULLING = 16  # from 16 chunks (1,024 slots) the TPU takes A6
ROW = 128                    # rays per row: the unit of A6's chunk gate
BOX_PAD = 8                  # the box table is padded to a multiple of this


class SearchSpheres(NamedTuple):
    """Kernel-layout sphere rows, built once per query."""

    spheres: torch.Tensor  # [S_pad, 4] f32: cx cy cz |c|^2-r^2
    num_spheres: int
    # The group boxes of both sweeps' group gate, [S_pad / GROUP_S, 8] f32
    # (fused_hit.sweep_boxes: c -+ |r| of the active spheres).
    boxes: torch.Tensor
    num_chunks: int = 0
    # num_chunks > 0: the clustered sweep's chunk AABBs, [6, K_pad] f32 (lo
    # xyz, hi xyz: c -+ r of the active spheres, r signed as the TPU kernel
    # takes it; BIG/-BIG for a chunk without one and in the padding
    # columns); None for the monolithic sweep. A sphere of negative radius
    # (a hollow sphere's inner surface) gives an inverted box: alone in its
    # chunk, no row opens the chunk and the clustered sweep never hits it,
    # as on the TPU, where the monolithic sweep (group boxes from |r|) and
    # the f64 oracle do (tests/test_torch_hollow_chunk.py).
    chunk_boxes: Optional[torch.Tensor] = None


def prep_sphere_search(scene: SphereScene,
                       min_chunks: int = MIN_CHUNKS_FOR_CULLING
                       ) -> SearchSpheres:
    """The TPU kernel's sweep columns (prep_spheres), as float4 rows and
    detached: inactive slots get a +BIG cterm bias (never hit); padding
    slots sit at 1e9 with a BIG cterm. The group boxes of the kernels'
    group gate; with at least min_chunks chunks of 64 slots, also the chunk
    AABBs of the clustered sweep."""
    with torch.no_grad():
        c = scene.center
        s = c.shape[0]
        c2r2 = (vm.length_squared(c) - scene.radius * scene.radius
                + torch.where(scene.active, 0.0, BIG))
        s_pad = max(-(-s // CHUNK_S) * CHUNK_S, CHUNK_S)
        pad = lambda x, v: torch.nn.functional.pad(x, (0, s_pad - s), value=v)
        rows = torch.stack([pad(c[:, 0], 1.0e9), pad(c[:, 1], 1.0e9),
                            pad(c[:, 2], 1.0e9), pad(c2r2, BIG)], dim=1)
        groups = sweep_boxes(c, scene.radius, scene.active, s_pad, GROUP_S)
        k = s_pad // CHUNK_S
        if k < min_chunks:
            return SearchSpheres(rows.contiguous(), s, groups)
        act = scene.active[:, None]
        r_eff = torch.where(scene.active, scene.radius, 0.0)[:, None]
        pad_rows = lambda x, v: torch.nn.functional.pad(
            x, (0, 0, 0, s_pad - s), value=v)
        lo = pad_rows(torch.where(act, c - r_eff, BIG), BIG)
        hi = pad_rows(torch.where(act, c + r_eff, -BIG), -BIG)
        clo = lo.reshape(k, CHUNK_S, 3).amin(1)               # [k, 3]
        chi = hi.reshape(k, CHUNK_S, 3).amax(1)
        k_pad = max(-(-k // BOX_PAD) * BOX_PAD, BOX_PAD)
        pad_k = lambda x, v: torch.nn.functional.pad(
            x, (0, 0, 0, k_pad - k), value=v)
        chunk_boxes = torch.cat([pad_k(clo, BIG).T, pad_k(chi, -BIG).T])
    return SearchSpheres(rows.contiguous(), s, groups, k,
                         chunk_boxes.contiguous())


def sphere_search(scene: SphereScene, origins: torch.Tensor,
                  directions: torch.Tensor, t_min: float, *,
                  interpret: bool = False, alive=None, exclude=None,
                  min_chunks: int = MIN_CHUNKS_FOR_CULLING):
    """Closest-hit search of rays origins/directions [N, 3]: (t [N] f32,
    BIG = miss; idx [N] i32), detached. alive: optional [N] bool; dead
    lanes read (BIG, 0). exclude: optional [N] integer sphere id left out of
    each lane's sweep (-1 for none), on the monolithic sweep only.
    min_chunks: the chunk count from which the clustered sweep runs (the
    tests lower it to reach that sweep with a small scene)."""
    with torch.no_grad():
        n = origins.shape[0]
        dev = origins.device
        if origins.shape != (n, 3) or directions.shape != (n, 3):
            raise ValueError("origins and directions must be [N, 3]")
        if origins.dtype != torch.float32 or \
                directions.dtype != torch.float32:
            raise ValueError("origins and directions must be float32")
        rays = tuple(x[:, k].contiguous()
                     for x in (origins, directions) for k in range(3))
        if alive is None:
            alive = torch.ones(n, dtype=torch.bool, device=dev)
        alive = alive.contiguous()
        if alive.dtype != torch.bool or alive.shape != (n,) or \
                alive.device != dev:
            raise ValueError("alive must be an [N] bool tensor on the rays' "
                             "device")
        if n == 0 or n >= 2 ** 31:
            raise ValueError(f"sphere_search takes 0 < N < 2^31 rays, got {n}")
        return sphere_search_flat(prep_sphere_search(scene, min_chunks),
                                  *rays, alive, t_min, interpret=interpret,
                                  exclude=exclude)


@torch.no_grad()
def sphere_search_flat(tables: SearchSpheres, ox, oy, oz, dx, dy, dz, alive,
                       t_min: float, *, interpret: bool = False,
                       exclude=None):
    """The search on prepared rows and flat contiguous [N] f32 ray
    components with an [N] bool alive mask: the kernel for CUDA tensors,
    the plain version for CPU tensors or with interpret=True. Tables with
    chunk boxes take the clustered sweep (A6), the others the monolithic
    one (A5)."""
    dev = ox.device
    if tables.spheres.device != dev:
        raise ValueError(f"scene is on {tables.spheres.device}, rays on "
                         f"{dev}")
    clustered = tables.num_chunks > 0
    if clustered and exclude is not None:
        raise ValueError("per-lane exclusion is not implemented for the "
                         "clustered (S >= 1024) sphere sweep")
    exclude = check_exclude(exclude, ox)
    rays = (ox, oy, oz, dx, dy, dz)
    if not cuda_build.use_kernel(dev, interpret, "sphere_search"):
        if clustered:
            return sphere_search_clustered_plain(tables, *rays, alive, t_min)
        return sphere_search_plain(tables, *rays, alive, t_min,
                                   exclude=exclude)
    return _launch(tables, rays, alive, float(t_min), exclude)


def _launch(tables: SearchSpheres, rays, alive, t_min: float, exclude):
    dev = rays[0].device
    n = rays[0].shape[0]
    if not all(x.is_contiguous() for x in (*rays, alive)):
        raise ValueError("kernel operands must be contiguous")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    if tables.spheres.data_ptr() % 16 or tables.boxes.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    if tables.boxes.shape != (tables.spheres.shape[0] // GROUP_S, 8):
        raise ValueError("tables must come from prep_sphere_search")
    ray_ptrs = [x.data_ptr() for x in rays]
    outs = (t.data_ptr(), idx.data_ptr())
    if tables.num_chunks > 0:
        cuda_build.launch(
            "qtrt_sphere_search_clustered", *ray_ptrs, alive.data_ptr(),
            tables.spheres.data_ptr(), tables.boxes.data_ptr(), GROUP_S,
            tables.chunk_boxes.data_ptr(), tables.num_chunks,
            tables.chunk_boxes.shape[1], tables.num_spheres, t_min, n, *outs,
            device=dev, counted=("sphere_search_clustered",))
    else:
        cuda_build.launch(
            "qtrt_sphere_search", *ray_ptrs, alive.data_ptr(),
            excl_ptr(exclude), tables.spheres.data_ptr(),
            tables.boxes.data_ptr(), tables.spheres.shape[0], GROUP_S,
            tables.num_spheres, t_min, n, *outs, device=dev,
            counted=launch_counts("sphere_search", exclude))
    return t, idx


def sphere_search_plain(tables: SearchSpheres, ox, oy, oz, dx, dy, dz,
                        alive, t_min: float, slice_rays: int = PLAIN_SLICE,
                        exclude=None):
    """Plain PyTorch version of A5: the A2 sweep (``fused_hit._sweep``, the
    expanded-form quadratic and min-then-match, the excluded slot masked
    before the minimum) over the padded table, in [slice_rays, S_pad]
    blocks; padding ids read back as 0."""
    n = ox.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=ox.device)
    idx = torch.empty(n, dtype=torch.int32, device=ox.device)
    for lo in range(0, n, slice_rays):
        sl = slice(lo, min(n, lo + slice_rays))
        t_best, best, _ = _sweep(tables.spheres, ox[sl], oy[sl], oz[sl],
                                 dx[sl], dy[sl], dz[sl], float(t_min),
                                 None if exclude is None else exclude[sl])
        best = torch.where(best >= tables.num_spheres, 0, best)
        t[sl] = torch.where(alive[sl], t_best, BIG)
        idx[sl] = torch.where(alive[sl], best, 0)
    return t, idx


def chunk_gate(tables: SearchSpheres, ox, oy, oz, dx, dy, dz, alive,
               t_min: float) -> torch.Tensor:
    """[rows, K] bool: the chunks each 128-ray row sweeps. A chunk opens for
    a row when some live lane's slab test of the chunk's AABB passes (enter
    clamped at t_min, exit > enter strict), with the TPU kernel's
    arithmetic. N must be a multiple of 128."""
    k = tables.num_chunks
    box = tables.chunk_boxes[:, :k]                              # [6, K]
    o = (ox[:, None], oy[:, None], oz[:, None])
    inv = tuple(slab_inv(d)[:, None] for d in (dx, dy, dz))
    t0 = [(box[a] - o[a]) * inv[a] for a in range(3)]            # [n, K]
    t1 = [(box[3 + a] - o[a]) * inv[a] for a in range(3)]
    near = [torch.minimum(t0[a], t1[a]) for a in range(3)]
    far = [torch.maximum(t0[a], t1[a]) for a in range(3)]
    enter = torch.maximum(torch.maximum(near[0], near[1]),
                          torch.clamp_min(near[2], t_min))
    exit_ = torch.minimum(torch.minimum(far[0], far[1]), far[2])
    cross = (exit_ > enter) & alive[:, None]
    return cross.reshape(-1, ROW, k).any(dim=1)


def sphere_search_clustered_plain(tables: SearchSpheres, ox, oy, oz, dx, dy,
                                  dz, alive, t_min: float,
                                  slice_rays: int = PLAIN_SLICE):
    """Plain PyTorch version of A6, in [slice_rays, S_pad] blocks of whole
    128-ray rows: the candidates of the monolithic sweep, kept only in the
    chunks the lane's row opens (``chunk_gate``), then the minimum and the
    lowest slot id reaching it. That is the kernel's strict '<' across
    ascending chunks of each chunk's min-then-match. Padding ids read back
    as 0, dead lanes (BIG, 0)."""
    if slice_rays % ROW:
        raise ValueError(f"slice_rays must be a multiple of {ROW}")
    n = ox.shape[0]
    k = tables.num_chunks
    t = torch.empty(n, dtype=torch.float32, device=ox.device)
    idx = torch.empty(n, dtype=torch.int32, device=ox.device)
    padn = lambda x, m, v: torch.nn.functional.pad(x, (0, m), value=v)
    for lo in range(0, n, slice_rays):
        sl = slice(lo, min(n, lo + slice_rays))
        m = sl.stop - lo
        extra = (-m) % ROW       # complete the last row with dead lanes
        rays = [padn(c[sl], extra, 1.0 if j == 5 else 0.0)
                for j, c in enumerate((ox, oy, oz, dx, dy, dz))]
        live = padn(alive[sl], extra, False)
        gate = chunk_gate(tables, *rays, live, float(t_min))   # [rows, K]
        tcand, _ = sweep_candidates(tables.spheres[:k * CHUNK_S], *rays,
                                    float(t_min))
        lane_gate = gate.repeat_interleave(ROW, dim=0) \
            .repeat_interleave(CHUNK_S, dim=1)                  # [m, S_pad]
        t_best, best = min_then_match(torch.where(lane_gate, tcand, BIG))
        best = torch.where(best >= tables.num_spheres, 0, best)
        t[sl] = torch.where(live, t_best, BIG)[:m]
        idx[sl] = torch.where(live, best, 0)[:m]
    return t, idx


def sphere_search_clustered_gated_plain(tables: SearchSpheres, ox, oy, oz,
                                        dx, dy, dz, alive, t_min: float):
    """The kernel's gated sweep (A6) in plain PyTorch, group by group, with
    a count of its work: (t, idx, group visits [N] i32). A lane sweeps a
    group of GROUP_S slots only when its 128-ray row opens the group's
    chunk (``chunk_gate``) and its own group gate (``fused_hit.group_gate``
    on the group boxes) passes under its running minimum; within a group
    the minimum, then the lowest id reaching it, and a strict '<' update
    across groups. The group gate keeps every candidate below the running
    minimum, so (t, idx) equal sphere_search_clustered_plain's on every
    lane. A measuring aid and the subject of the CPU tests; no path runs
    it."""
    n = ox.shape[0]
    dev = ox.device
    extra = (-n) % ROW       # complete the last row with dead lanes
    padn = lambda x, v: torch.nn.functional.pad(x, (0, extra), value=v)
    rays = [padn(c, 1.0 if j == 5 else 0.0)
            for j, c in enumerate((ox, oy, oz, dx, dy, dz))]
    live = padn(alive, False)
    rows = chunk_gate(tables, *rays, live, float(t_min))       # [rows, K]
    per_chunk = CHUNK_S // GROUP_S
    m = live.shape[0]
    t_best = torch.full((m,), BIG, dtype=torch.float32, device=dev)
    best = torch.zeros(m, dtype=torch.int32, device=dev)
    visits = torch.zeros(m, dtype=torch.int32, device=dev)
    for gi in range(tables.num_chunks * per_chunk):
        row_open = rows[:, gi // per_chunk].repeat_interleave(ROW)
        opened = row_open & live & group_gate(tables.boxes[gi], *rays,
                                              float(t_min), t_best)
        visits += opened
        ids = torch.nonzero(opened).squeeze(1)
        if not ids.shape[0]:
            continue
        base = gi * GROUP_S
        tcand, _ = sweep_candidates(tables.spheres[base:base + GROUP_S],
                                    *(c[ids] for c in rays), float(t_min))
        t_g, i_g = min_then_match(tcand)
        better = t_g < t_best[ids]
        t_best[ids] = torch.where(better, t_g, t_best[ids])
        best[ids] = torch.where(better, i_g + base, best[ids])
    best = torch.where(best >= tables.num_spheres, 0, best)
    return (torch.where(live, t_best, BIG)[:n],
            torch.where(live, best, 0)[:n], visits[:n])
