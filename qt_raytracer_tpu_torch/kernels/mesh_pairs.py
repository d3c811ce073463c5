"""Pair-wavefront triangle-mesh closest hit (counterpart of
``qt_raytracer_tpu.kernels.mesh_pairs``): the wrappers of CUDA kernels A7 and
A8 (``csrc/mesh_pairs.cu``), their plain versions, and the pipeline around
them.

The clustered search (``mesh_intersect.mesh_search``) makes a warp run the
union of its lanes' cluster visits. This module turns the traversal inside
out, as a ray queue does:

  1. A7, ``crossing_lists``: per ray the ascending list of the first C
     cluster ids whose slacked, capped slab test passes (the gate of A4 and
     of A3's first look at a cluster, on the same epsilon-padded boxes), and
     the count of all of them.
  2. One stable ``torch.sort`` of the N*C (cluster, ray) records groups the
     pairs by cluster, ray-ascending within a cluster. Each cluster's run is
     padded to a multiple of 128 slots; a slot's cluster is the last one
     whose padded start does not lie beyond it.
  3. A8, ``pair_hits``: every 128-slot tile belongs to one cluster
     (``gmap``); each thread fetches its slot's ray (the JAX package hands
     its kernel a packed [N, 8] row gather) and Moller-Trumbore runs over
     just that cluster's triangles. Every visit is productive and there is
     no gate inside.
  4. Per ray, the minimum t over its pairs and, among the pairs that reach
     it, the lowest triangle id: the winner of A3's ascending strict-'<'
     sweep.

A ray with more than C crossings has an incomplete list and is searched
again by the clustered kernel through its alive mask (sorted, so those rays
pack into a few blocks). So the budget trades speed, never the result:
``mesh_search_pairs`` equals ``mesh_search`` bit for bit on live lanes, and
gives (BIG, 0) on dead ones. Steps 2 and 4 are library calls, as they are
XLA glue in the JAX package. Outputs are detached.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors or with ``interpret=True``; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..runtime import cuda_build
from .fused_hit import BIG
from .mesh_intersect import (LANE, PLAIN_SLICE_CLUSTERS, PLAIN_SLICE_RAYS,
                             MeshClusters, _check, _check_tables, _defaults,
                             _moller_trumbore, check_search_options,
                             crossing_mask, mesh_search, slab_boxes,
                             slab_inv)

GROUPS = 8                # the slot count is a multiple of GROUPS * LANE
PLAIN_SLICE_TILES = 16    # 128-pair tiles per block of the plain A8
REDUCE_DUMP = 4096        # scatter targets of the slots that hold no hit


def cluster_bounds(mc: MeshClusters):
    """(lo [k,3], hi [k,3], k): the epsilon-padded cluster boxes that
    prep_mesh_clusters packed, unpadded, so that the emission gate and the
    clustered kernel's gate test the same geometry."""
    return mc.box_planes[0:3, :mc.k].T, mc.box_planes[3:6, :mc.k].T, mc.k


# --------------------------------------------------------------- A7
def crossing_lists(mc: MeshClusters, ox, oy, oz, dx, dy, dz, t_min: float,
                   alive=None, t_cap=None, c_max: int = 4, *,
                   interpret: bool = False):
    """([N, c_max] i32, [N] i32): per ray the ascending ids of the first
    c_max clusters whose slab test passes with an entry at most
    min(t_cap * 1.0001 + 1e-4, 1e37), filled with k; and the count of all
    such clusters, which may exceed c_max. Dead lanes: all k, count 0. The
    list is a transposed view of plane-major storage. The kernel walks the
    group boxes first (mesh_intersect.crossing_walk_gated_plain), which
    changes no id and no count."""
    rays = (ox, oy, oz, dx, dy, dz)
    alive, t_cap = _defaults(ox, alive, t_cap)
    _check(mc, rays, alive, t_cap)
    if not 1 <= c_max <= mc.k:
        raise ValueError(f"c_max must lie in [1, {mc.k}] (the cluster "
                         f"count), got {c_max}")
    dev = ox.device
    if not cuda_build.use_kernel(dev, interpret, "crossing_lists"):
        return crossing_lists_plain(mc, *rays, t_min, alive, t_cap, c_max)
    n = ox.shape[0]
    lists = torch.empty((c_max, n), dtype=torch.int32, device=dev)
    ncross = torch.empty(n, dtype=torch.int32, device=dev)
    cuda_build.launch(
        "qtrt_mesh_crossing_lists", *(x.data_ptr() for x in rays),
        alive.data_ptr(), t_cap.data_ptr(), mc.box_planes.data_ptr(), mc.k,
        mc.box_planes.shape[1], mc.group_boxes.data_ptr(),
        mc.group_boxes.shape[1], float(t_min), n, c_max, lists.data_ptr(),
        ncross.data_ptr(), device=dev, counted=("mesh_crossing_lists",))
    return lists.T, ncross


def crossing_lists_plain(mc: MeshClusters, ox, oy, oz, dx, dy, dz,
                         t_min: float, alive, t_cap, c_max: int,
                         slice_rays: int = PLAIN_SLICE_RAYS):
    """Plain PyTorch version of A7, in [slice_rays, clusters] blocks: the
    id-or-k table of each block of rays, its c_max smallest entries and its
    count of ids."""
    n, k = ox.shape[0], mc.k
    dev = ox.device
    lists = torch.empty((c_max, n), dtype=torch.int32, device=dev)
    ncross = torch.empty(n, dtype=torch.int32, device=dev)
    cap_all = torch.clamp_max(t_cap * 1.0001 + 1e-4, 1e37)
    for lo in range(0, n, slice_rays):
        sl = slice(lo, min(n, lo + slice_rays))
        o = (ox[sl], oy[sl], oz[sl])
        inv = tuple(slab_inv(d) for d in (dx[sl], dy[sl], dz[sl]))
        stored = []
        for c0 in range(0, k, PLAIN_SLICE_CLUSTERS):
            c_hi = min(k, c0 + PLAIN_SLICE_CLUSTERS)
            mask = crossing_mask(mc, o, inv, cap_all[sl], alive[sl], c0,
                                 c_hi, t_min)
            cid = torch.arange(c0, c_hi, dtype=torch.int32, device=dev)
            stored.append(torch.where(mask, cid, k))
        stored = torch.cat(stored, dim=1)                       # [m, k]
        ncross[sl] = (stored < k).sum(dim=1).to(torch.int32)
        # Ids ascend along a row, so the c_max smallest are the list.
        lists[:, sl] = torch.sort(stored, dim=1).values[:, :c_max].T
    return lists.T, ncross


# --------------------------------------------------------------- A8
def _check_slots(rays, ray_buf, gmap) -> None:
    b = ray_buf.shape[0]
    dev = rays[0].device
    if b == 0 or b % LANE != 0:
        raise ValueError(f"the pair kernel takes a positive multiple of "
                         f"{LANE} slots, got {b}")
    if (ray_buf.dtype != torch.int64 or ray_buf.dim() != 1
            or ray_buf.device != dev or not ray_buf.is_contiguous()):
        raise ValueError("ray_buf must be a contiguous [B] int64 tensor on "
                         "the rays' device")
    if (gmap.dtype != torch.int32 or gmap.shape != (b // LANE,)
            or gmap.device != dev or not gmap.is_contiguous()):
        raise ValueError("gmap must be a contiguous [B / 128] int32 tensor "
                         "on the rays' device")


def pair_hits(mc: MeshClusters, ox, oy, oz, dx, dy, dz, t_cap, ray_buf, gmap,
              t_min: float, *, interpret: bool = False):
    """Kernel A8: (t [B] f32, idx [B] i32) of B (ray, cluster) slots in
    tiles of 128 slots of one cluster. ray_buf: [B] i64, each slot's ray id
    in [0, N), negative on a padding slot; gmap: [B / 128] i32, each tile's
    cluster id in [0, k). Per valid slot the closest triangle of the tile's
    cluster strictly below the ray's cap, ties to the lowest BVH-order id;
    (BIG, 0) where none beats the cap and on padding slots. The kernel
    sweeps a 128-triangle row of the cluster only where the pair's row gate
    passes (pair_hits_gated_plain), which drops no winner."""
    rays = (ox, oy, oz, dx, dy, dz)
    _check(mc, rays, None, t_cap)
    _check_tables(mc, "vpu", "rowgate")
    _check_slots(rays, ray_buf, gmap)
    dev = ox.device
    if not cuda_build.use_kernel(dev, interpret, "pair_hits"):
        return pair_hits_plain(mc, *rays, t_cap, ray_buf, gmap, t_min)
    b = ray_buf.shape[0]
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    cuda_build.launch(
        "qtrt_mesh_pairs", *(x.data_ptr() for x in rays), t_cap.data_ptr(),
        ray_buf.data_ptr(), gmap.data_ptr(), mc.tri_planes.data_ptr(),
        mc.tri_planes.shape[1], mc.row_boxes.data_ptr(),
        mc.row_boxes.shape[1], mc.tris_per_cluster, float(t_min),
        ox.shape[0], b, t.data_ptr(), idx.data_ptr(), device=dev,
        counted=("mesh_pairs",))
    return t, idx


def pair_hits_plain(mc: MeshClusters, ox, oy, oz, dx, dy, dz, t_cap, ray_buf,
                    gmap, t_min: float,
                    slice_tiles: int = PLAIN_SLICE_TILES):
    """Plain PyTorch version of A8, in blocks of slice_tiles tiles that hold
    a valid slot: one packed row gather of the slots' rays, then [tiles,
    128 slots, triangles of the tile's cluster], the minimum t below the
    cap, then the lowest id reaching it."""
    b = ray_buf.shape[0]
    dev = ox.device
    g = mc.tris_per_cluster
    t_out = torch.full((b,), BIG, dtype=torch.float32, device=dev)
    idx_out = torch.zeros(b, dtype=torch.int32, device=dev)
    table = torch.stack([ox, oy, oz, dx, dy, dz, t_cap], dim=1)     # [N, 7]
    ray_rows = ray_buf.view(-1, LANE)
    live_tiles = torch.nonzero((ray_rows >= 0).any(dim=1)).squeeze(1)
    tris = mc.tri_planes[:, :mc.k * g].view(9, mc.k, g)
    lanes = torch.arange(g, dtype=torch.int32, device=dev)
    for lo in range(0, live_tiles.shape[0], slice_tiles):
        tiles = live_tiles[lo:lo + slice_tiles]
        ray = ray_rows[tiles]                                # [T, 128]
        ok_pair = ray >= 0
        r = table[torch.clamp_min(ray, 0)]                   # [T, 128, 7]
        c = gmap[tiles].long()
        tri = tris[:, c][:, :, None, :]                      # [9, T, 1, g]
        o = tuple(r[:, :, a, None] for a in range(3))        # [T, 128, 1]
        d = tuple(r[:, :, 3 + a, None] for a in range(3))
        cap = r[:, :, 6]
        t, ok = _moller_trumbore(o, d, tuple(tri[0:3]), tuple(tri[3:6]),
                                 tuple(tri[6:9]), float(t_min))
        tcand = torch.where(ok & (t < cap[:, :, None]), t, BIG)
        tmin_c = tcand.amin(dim=2)
        gid = (c.to(torch.int32) * g)[:, None, None] + lanes
        idx_c = torch.where(tcand == tmin_c[:, :, None], gid,
                            mc.k * g).amin(dim=2)
        won = ok_pair & (tmin_c < cap)   # a padding slot sweeps nothing
        slots = (tiles[:, None] * LANE
                 + torch.arange(LANE, device=dev)).reshape(-1)
        t_out[slots] = torch.where(won, tmin_c, BIG).reshape(-1)
        idx_out[slots] = torch.where(won, idx_c, 0).reshape(-1)
    return t_out, idx_out


def pair_hits_gated_plain(mc: MeshClusters, ox, oy, oz, dx, dy, dz, t_cap,
                          ray_buf, gmap, t_min: float,
                          slice_tiles: int = PLAIN_SLICE_TILES):
    """The kernel's row-gated sweep (A8) in plain PyTorch, with a count of
    its work: (t [B], idx [B], rows [B] i32). A valid slot sweeps row r of
    its tile's cluster (128 triangles, in ascending r) only when the slab
    test of the row's box (``MeshClusters.row_boxes``) passes with an entry
    at most min(t_best * 1.0001 + 1e-4, 1e37) of its running hit, which
    starts at the ray's cap; within a row the minimum below the running
    hit, then the lowest id reaching it, and a strict '<' update. t_best
    only shrinks, so a row that fails its gate at its turn holds no winner:
    (t, idx) equal pair_hits_plain's on every slot. rows counts the rows
    each slot swept (0 on padding slots). A measuring aid and the subject
    of the CPU tests; no path runs it."""
    _check_tables(mc, "vpu", "rowgate")
    b = ray_buf.shape[0]
    dev = ox.device
    g = mc.tris_per_cluster
    nrows = g // LANE
    t_out = torch.full((b,), BIG, dtype=torch.float32, device=dev)
    idx_out = torch.zeros(b, dtype=torch.int32, device=dev)
    rows_out = torch.zeros(b, dtype=torch.int32, device=dev)
    table = torch.stack([ox, oy, oz, dx, dy, dz, t_cap], dim=1)     # [N, 7]
    ray_rows = ray_buf.view(-1, LANE)
    live_tiles = torch.nonzero((ray_rows >= 0).any(dim=1)).squeeze(1)
    tris = mc.tri_planes[:, :mc.k * g].view(9, mc.k * nrows, LANE)
    lanes = torch.arange(LANE, dtype=torch.int32, device=dev)
    for lo in range(0, live_tiles.shape[0], slice_tiles):
        tiles = live_tiles[lo:lo + slice_tiles]
        ray = ray_rows[tiles]                                # [T, 128]
        ok_pair = ray >= 0
        r = table[torch.clamp_min(ray, 0)]                   # [T, 128, 7]
        o = tuple(r[:, :, a] for a in range(3))              # [T, 128]
        d = tuple(r[:, :, 3 + a] for a in range(3))
        inv = tuple(slab_inv(x) for x in d)
        cap = r[:, :, 6]
        t_best = cap.clone()
        best = torch.zeros_like(ray, dtype=torch.int32)
        swept = torch.zeros_like(ray, dtype=torch.int32)
        for k in range(nrows):
            row = gmap[tiles].long() * nrows + k             # [T]
            enter, exit_ = slab_boxes(mc.row_boxes[:, row][:, :, None], o,
                                      inv, float(t_min))    # [T, 128]
            slack = torch.clamp_max(t_best * 1.0001 + 1e-4, 1e37)
            opened = ok_pair & (exit_ > enter) & (enter <= slack)
            swept += opened
            tri = tris[:, row][:, :, None, :]                # [9, T, 1, 128]
            t, ok = _moller_trumbore(
                tuple(x[:, :, None] for x in o),
                tuple(x[:, :, None] for x in d), tuple(tri[0:3]),
                tuple(tri[3:6]), tuple(tri[6:9]), float(t_min))
            tcand = torch.where(ok & (t < t_best[:, :, None]), t, BIG)
            tmin_r = tcand.amin(dim=2)
            gid = (row.to(torch.int32) * LANE)[:, None, None] + lanes
            idx_r = torch.where(tcand == tmin_r[:, :, None], gid,
                                mc.k * g).amin(dim=2)
            better = opened & (tmin_r < t_best)
            t_best = torch.where(better, tmin_r, t_best)
            best = torch.where(better, idx_r, best)
        won = ok_pair & (t_best < cap)
        slots = (tiles[:, None] * LANE
                 + torch.arange(LANE, device=dev)).reshape(-1)
        t_out[slots] = torch.where(won, t_best, BIG).reshape(-1)
        idx_out[slots] = torch.where(won, best, 0).reshape(-1)
        rows_out[slots] = swept.reshape(-1)
    return t_out, idx_out, rows_out


# --------------------------------------------------------------- pipeline
class PairTables(NamedTuple):
    """The padded, cluster-major pair slots of one wavefront."""

    ray_buf: torch.Tensor   # [B] i64: each slot's ray id, -1 on padding
    gmap: torch.Tensor      # [B / 128] i32: each 128-slot tile's cluster id


def pair_list_width(mc: MeshClusters, n: int, pair_budget: int = 0,
                    pair_c: int = 6) -> int:
    """The per-ray crossing-list width C: pair_budget // n pairs per ray
    (0: pair_c of them), at least 1 and at most the cluster count."""
    if pair_c < 1:
        raise ValueError(f"pair_c must be >= 1, got {pair_c}")
    if pair_budget <= 0:
        pair_budget = pair_c * n
    return min(max(pair_budget // n, 1), mc.k)


def pair_slots(lists: torch.Tensor, k: int) -> PairTables:
    """Group the [N, C] crossing lists by cluster into padded slots.

    One stable sort of the N*C ids in ray-major order, so within a cluster
    the pairs stay ray-ascending; entries equal to k sort last and belong to
    no cluster. Cluster c's run starts at the slot pstart[c], a multiple of
    128, and is padded to the next one. A slot belongs to the last cluster
    whose start is at or before it: an empty cluster's start coincides with
    the next cluster's, and the larger id wins. (The JAX package scatters
    the ids at their starts and takes a running maximum, which gives the
    same map; torch.cummax takes milliseconds on a card where a binary
    search over the k starts takes microseconds.)"""
    n, c_max = lists.shape
    dev = lists.device
    m_tot = n * c_max
    clus_s, order = torch.sort(lists.reshape(-1), stable=True)
    rid_s = order // c_max
    qs = torch.arange(k + 1, dtype=clus_s.dtype, device=dev)
    bounds = torch.searchsorted(clus_s, qs)                  # [k + 1] i64
    cum = bounds[:-1]
    counts = bounds[1:] - cum
    padded = -(-counts // LANE) * LANE
    pstart = torch.cumsum(padded, 0) - padded
    tile = GROUPS * LANE
    b_tot = -(-(m_tot + LANE * k) // tile) * tile
    slots = torch.arange(b_tot, device=dev)
    cmap = torch.searchsorted(pstart, slots, right=True) - 1
    off = slots - pstart[cmap]
    src = torch.clamp(cum[cmap] + off, 0, m_tot - 1)
    ray_buf = torch.where(off < counts[cmap], rid_s[src], -1)
    gmap = cmap.view(-1, LANE)[:, 0].to(torch.int32).contiguous()
    return PairTables(ray_buf, gmap)


def reduce_pairs(ray_buf, t_pair, idx_pair, n: int, num_tris: int):
    """(t [n], idx [n]) from the per-pair results: per ray the minimum t,
    then the lowest triangle id among the pairs that reach it, which is the
    winner of an ascending strict-'<' sweep; (BIG, 0) for a ray no pair of
    which hit. What belongs to no ray goes to REDUCE_DUMP entries behind the
    rays, spread by slot: most slots hold no hit, and one shared entry
    would take all their atomic updates in turn."""
    dev = t_pair.device
    pvalid = (ray_buf >= 0) & (t_pair < BIG)
    dump = n + torch.arange(t_pair.shape[0], device=dev) % REDUCE_DUMP
    rid = torch.where(pvalid, ray_buf, dump)
    tmin = torch.full((n + REDUCE_DUMP,), BIG, dtype=torch.float32,
                      device=dev)
    tmin.scatter_reduce_(0, rid, torch.where(pvalid, t_pair, BIG), "amin")
    tie = pvalid & (t_pair == tmin[rid])
    imin = torch.full((n + REDUCE_DUMP,), num_tris, dtype=torch.int32,
                      device=dev)
    imin.scatter_reduce_(0, rid, torch.where(tie, idx_pair, num_tris), "amin")
    return tmin[:n], torch.where(imin[:n] < num_tris, imin[:n], 0)


@torch.no_grad()
def mesh_search_pairs(mc: MeshClusters, ox, oy, oz, dx, dy, dz, t_min: float,
                      alive=None, t_cap=None, *, pair_budget: int = 0,
                      pair_c: int = 6, sort_mode: str = "crossing",
                      interpret: bool = False, mt: str = "vpu",
                      visit: str = "full"):
    """Closest hit over the mesh by the pair-wavefront search: (t [N] f32,
    BIG = miss; idx [N] i32), a drop-in for mesh_search with the same cap
    semantics (a lane reports a hit only when a triangle strictly beats
    t_cap) and, on live lanes, the same bits. It takes no exclude operand.

    pair_budget: the total (ray, cluster) pair capacity, read as a per-ray
    list width C = pair_budget // N clamped to [1, k]; 0 means pair_c pairs
    per ray. Rays with more than C crossings go through the clustered
    search instead (under sort_mode, mt and visit, which reach that
    fallback alone: A8 has the one Moller-Trumbore, as in the JAX package),
    which is launched every time: asking whether any ray overflowed would
    stall the host on the device. With mt="mxu" the fallback's rays round
    as the bilinear form does, so the bits may differ from mesh_search's
    there."""
    check_search_options(mt, visit)
    rays = (ox, oy, oz, dx, dy, dz)
    alive, t_cap = _defaults(ox, alive, t_cap)
    _check(mc, rays, alive, t_cap)
    n = ox.shape[0]
    c_max = pair_list_width(mc, n, pair_budget, pair_c)

    lists, ncross = crossing_lists(mc, *rays, t_min, alive, t_cap, c_max,
                                   interpret=interpret)
    unsafe = ncross > c_max

    ray_buf, gmap = pair_slots(lists, mc.k)
    t_pair, idx_pair = pair_hits(mc, *rays, t_cap, ray_buf, gmap, t_min,
                                 interpret=interpret)
    t_res, i_res = reduce_pairs(ray_buf, t_pair, idx_pair, n,
                                mc.k * mc.tris_per_cluster)

    # Overflow rays: the clustered search, sorted, so that they pack into a
    # few blocks and the rest of the wavefront costs next to nothing.
    t_fb, i_fb = mesh_search(mc, *rays, t_min, alive=unsafe, t_cap=t_cap,
                             sort=True, sort_mode=sort_mode,
                             interpret=interpret, mt=mt, visit=visit)
    return torch.where(unsafe, t_fb, t_res), torch.where(unsafe, i_fb, i_res)
