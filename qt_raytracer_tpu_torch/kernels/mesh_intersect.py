"""Clustered triangle-mesh closest hit: the CUDA kernels' wrappers, their
plain versions, and the wavefront sort around them (counterpart of
``qt_raytracer_tpu.kernels.mesh_intersect``).

Triangles are BVH-ordered (spatially coherent) and packed into clusters of
``cluster_rows_for(P) * 128`` consecutive triangles, each behind an
epsilon-padded AABB (``prep_mesh_clusters``). Two kernels, both in
``csrc/mesh_intersect.cu``:

  - A4, ``first_crossed_cluster``: per ray, the lowest id of a cluster whose
    slacked, capped slab test passes (k when none), and with ``pair=True``
    also the lowest such id above it. It keys the sort. Like A7
    (``mesh_pairs.crossing_lists``) it walks the clusters through a
    two-level gate: the box of each run of ``GROUP_C`` consecutive clusters
    first (``prep_group_boxes``, the exact union of their boxes), their own
    boxes only when it passes. A member that passes makes its group pass,
    so the walk finds every id the ungated test finds
    (``crossing_walk_gated_plain``).
  - A3, ``mesh_hits``: per ray, the closest triangle hit strictly below a
    per-lane cap ``t_cap``, ties to the lowest triangle id; (BIG, 0) where
    no triangle beats the cap, and on dead lanes. An optional per-lane
    ``exclude`` operand names one BVH-order triangle id that the lane never
    accepts (-1 for none): the edge-aware background re-trace.

A3 has the TPU kernel's bodies as template instances, chosen as the JAX
package chooses them (``mt`` first, then ``visit``):

  - ``mt="vpu"``, ``visit="full"``: Moller-Trumbore on the triangle planes.
  - ``visit="rowgate"``: inside a gated cluster, each 128-triangle row is
    slab-tested against its own epsilon-padded box (``prep_row_boxes``) and
    skipped when no hit in it could beat the lane's running cap. The same
    bits as "full": the row gate is as conservative as the cluster gate.
  - ``mt="mxu"``: Moller-Trumbore as bilinear forms of ray features (d,
    o x d, o, 1) and 19 per-triangle factors (``build_mt_features``). The
    candidates round differently, so it agrees with "vpu" without being
    bitwise equal to it. On the card a block of 64 rays stages each visited
    cluster's factors in shared memory and takes det, u det and v det on the
    tensor cores in TF32 as a filter (``mxu_filter_plain``); the pairs it
    cannot reject take the scalar bilinear form, which decides, so the bits
    are those of the scalar form whatever block a ray lands in.
  - ``visit="subtile"`` and ``"sliced"`` re-tile the TPU's (128 rays, 128
    triangles) visit into (``SUBTILE_ROWS``, 128) slices with the same
    expression tree, "sliced" also skipping slices whose gate popcount is 0;
    both are bitwise equal to "full" there. On the card one warp runs one
    ray and gates every cluster on that ray's own cap, which is at least as
    fine as any slice, with the same expression tree: both launch the
    "full" instance. Neither is a fallback: they are the same function.

``mesh_search`` is the pipeline of ``mesh_search_pallas``: for n >= 2048
rays and more than one cluster, a stable sort of the wavefront by the
crossing key ``c1 * 2^18 + (octant << 15 | morton)`` (dead rays keyed
``1 << 30`` sort last), A3 on the sorted rays, and the inverse permutation.
``sort_mode`` picks the key: "crossing" (that one), "crossing2" (the first
two crossed clusters, from A4 with ``pair=True``) or "morton" (octant and
Morton cell alone, no A4 launch); ``sort=False`` leaves the rays as they
come. The operands ride the permutation by one gather each, the results
come back by one scatter each. ``pipe`` takes the JAX package's names for
that step, "gather" and "fused" (there one packed row gather and scatter);
both name this one step, which gives the same bits either way.
Each lane's result does not depend on its neighbours, so the sort changes
only how much work a warp shares, never a live lane's result. Every per-ray
operand (alive, the cap, the exclude id) rides through the sort with its
ray.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors or with ``interpret=True``; on a CUDA tensor it
launches the instance its options name or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..accel.mesh import TriangleMesh
from ..runtime import cuda_build
from .fused_hit import (BIG, check_exclude, check_rays, excl_ptr,
                        launch_counts)

LANE = 128
CLUSTER_ROWS = 4          # 128-triangle rows per cluster (multi-cluster)
SUBTILE_ROWS = 32         # rays per slice of visit "subtile"/"sliced" (TPU)
SORT_MIN_RAYS = 2048      # the sort runs from this many rays on
PLAIN_SLICE_RAYS = 2048   # rays per block of the plain versions
PLAIN_SLICE_TRIS = 4096   # triangles per block of the plain A3
PLAIN_SLICE_CLUSTERS = 256
GROUP_C = 16              # clusters per group box of A4's and A7's gate
                          # (csrc/mesh_common.cuh's GROUP_C)
SORT_MODES = ("crossing", "crossing2", "morton")   # the wavefront sort keys
MT_MODES = ("vpu", "mxu")                          # Moller-Trumbore engines
VISIT_MODES = ("full", "subtile", "sliced", "rowgate")
SORT_PIPES = ("gather", "fused")
MT_FEATURES = 19          # bilinear-form factors per triangle (mt="mxu")
# The filter of A3's bilinear-form instance, as csrc/mesh_intersect.cu sets
# it (a CPU test holds these equal to the source's): rays a warp and a
# block, the margin's scale, floors and start, the underflow floor of u and
# v, the det threshold and the u + v slack, and the bound taken on the
# tensor core's accumulation error.
MXU_RAYS = 16
MXU_BLOCK_RAYS = 64
MXU_C = 2.0 ** -9
MXU_FLOOR = 2.0 ** -116
MXU_ABS = 2.0 ** -125
MXU_TAU = 2.0 ** -100
DET_LO = float(np.float32(1e-12) * np.float32(1.0 - 2.0 ** -20))
K_UV = 1.0 + 2.0 ** -19
MXU_ACC = 2.0 ** -19
# A3's template instances (csrc/mesh_intersect.cu, enum SearchMode).
_VPU, _ROWGATE, _MXU = 0, 1, 2

CROSSING2_MAX_K = 254  # (c1 * (k + 1) + c2) << 15 fits int32 up to here


def check_search_options(mt: str = "vpu", visit: str = "full",
                         pipe: str = "gather") -> None:
    """Raise ValueError on an unknown Moller-Trumbore engine, visit mode or
    sort pipe (the JAX package validates none of them)."""
    for name, value, allowed in (("mt", mt, MT_MODES),
                                 ("visit", visit, VISIT_MODES),
                                 ("pipe", pipe, SORT_PIPES)):
        if value not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got "
                             f"{value!r}")


def check_cluster_rows(cluster_rows) -> int:
    """cluster_rows as a positive int, else ValueError."""
    if isinstance(cluster_rows, bool) or not isinstance(cluster_rows, int) \
            or cluster_rows < 1:
        raise ValueError(f"cluster_rows must be a positive int, got "
                         f"{cluster_rows!r}")
    return cluster_rows


def _instance(mt: str, visit: str) -> int:
    """A3's instance for (mt, visit), with the JAX package's precedence:
    mt="mxu" takes the bilinear-form body whatever visit says."""
    if mt == "mxu":
        return _MXU
    return _ROWGATE if visit == "rowgate" else _VPU


def num_clusters(num_tris: int, cluster_rows: int = CLUSTER_ROWS) -> int:
    """Cluster count of a mesh of num_tris triangles."""
    return max(-(-num_tris // (check_cluster_rows(cluster_rows) * LANE)), 1)


def cluster_rows_for(num_tris: int, cluster_rows: int = CLUSTER_ROWS) -> int:
    """128-triangle rows per cluster: cluster_rows for multi-cluster
    meshes; a single-cluster mesh shrinks to ceil(P / 128) rows so it does
    not sweep rows of padding (the JAX package's QTRT_CLUSTER_ROWS, with
    QTRT_SMALL_MESH_ROWS at its default)."""
    check_cluster_rows(cluster_rows)
    if num_tris > cluster_rows * LANE:
        return cluster_rows
    return max(-(-num_tris // LANE), 1)


class MeshClusters(NamedTuple):
    """Kernel-layout mesh data (prep_mesh_clusters; the flat world path
    builds it once per forward render call, or once per trace call under
    autograd: integrator_flat.build_tables). group_boxes must hold
    box_planes: A4 and A7 on the card skip the members of a group whose box
    a ray misses, so a cluster box that leaves its group's box loses its
    crossings there, while the ungated plain versions on the CPU still find
    them. Change the cluster boxes only through with_cluster_boxes, which
    rebuilds the group boxes."""

    tri_planes: torch.Tensor  # [9, P_pad] f32: v0 xyz, e1 xyz, e2 xyz
    box_planes: torch.Tensor  # [6, K_pad] f32: lo xyz, hi xyz (pad BIG/-BIG)
    k: int                    # clusters
    tris_per_cluster: int
    num_tris: int
    root_lo: torch.Tensor     # [3] f32 BVH root box (sort keys)
    root_hi: torch.Tensor     # [3] f32
    row_boxes: torch.Tensor   # [6, P_pad / 128] f32 (prep_row_boxes)
    group_boxes: torch.Tensor  # [6, num_groups(k)] f32 (prep_group_boxes)
    # mt="mxu": [19, P_pad] f32 bilinear-form factors (build_mt_features).
    mt_planes: Optional[torch.Tensor] = None


def num_groups(k: int) -> int:
    """Group boxes of k clusters: one per GROUP_C, the last maybe shorter."""
    return -(-k // GROUP_C)


def prep_group_boxes(box_planes: torch.Tensor, k: int) -> torch.Tensor:
    """[6, num_groups(k)] f32: per run of GROUP_C consecutive clusters (the
    last run may be shorter), the exact union of their boxes, the minimum of
    lo and the maximum of hi on each axis. Only the k real columns of
    box_planes take part; their BIG/-BIG padding enters no union. Each sub
    and mul of the slab test rounds monotonically, so a ray whose capped
    slab test passes on a member box passes on its group box too."""
    ng = num_groups(k)
    fill = ng * GROUP_C - k
    lo = torch.nn.functional.pad(box_planes[0:3, :k], (0, fill), value=BIG)
    hi = torch.nn.functional.pad(box_planes[3:6, :k], (0, fill), value=-BIG)
    return torch.cat([lo.view(3, ng, GROUP_C).amin(2),
                      hi.view(3, ng, GROUP_C).amax(2)]).contiguous()


def with_cluster_boxes(mc: MeshClusters,
                       box_planes: torch.Tensor) -> MeshClusters:
    """mc with new cluster boxes ([6, K_pad], padding columns BIG/-BIG) and
    the group boxes rebuilt from them."""
    return mc._replace(box_planes=box_planes,
                       group_boxes=prep_group_boxes(box_planes, mc.k))


def _padded_tris(mesh: TriangleMesh, p_pad: int, v0_fill: float):
    """v0, e1, e2 [p_pad, 3], padded with degenerate triangles: v0 at
    v0_fill, zero edges (det == 0: never hit)."""
    pad = lambda x, fill: torch.nn.functional.pad(
        x, (0, 0, 0, p_pad - mesh.num_triangles), value=fill)
    return pad(mesh.v0, v0_fill), pad(mesh.e1, 0.0), pad(mesh.e2, 0.0)


def _padded_boxes(v0, e1, e2, groups: int, eps):
    """(lo, hi) [groups, 3]: the AABB of each run of consecutive triangles,
    widened by eps."""
    va = v0.reshape(groups, -1, 3)
    vb = (v0 + e1).reshape(groups, -1, 3)
    vc = (v0 + e2).reshape(groups, -1, 3)
    lo = torch.minimum(torch.minimum(va.amin(1), vb.amin(1)), vc.amin(1))
    hi = torch.maximum(torch.maximum(va.amax(1), vb.amax(1)), vc.amax(1))
    return lo - eps, hi + eps


def _box_eps(mesh: TriangleMesh):
    """The boxes' padding, a scale taken from the real vertices: coplanar
    axis-aligned clusters are zero-thickness, which the strict slab test
    never passes."""
    span = (mesh.v0.amax(0) - mesh.v0.amin(0)).amax()
    return 1e-5 * torch.clamp_min(span, 1e-3)


def prep_mesh_clusters(mesh: TriangleMesh, *,
                       cluster_rows: int = CLUSTER_ROWS,
                       mt: str = "vpu") -> MeshClusters:
    """Padded triangle planes, epsilon-padded cluster boxes and row boxes,
    with the JAX package's operation order (bit for bit), and the group
    boxes of A4's and A7's gate (prep_group_boxes). cluster_rows
    sizes the clusters (cluster_rows_for); triangle ids stay the BVH-order
    index whatever the size. mt="mxu" adds the bilinear-form factors that
    that search reads (76 bytes a triangle)."""
    check_search_options(mt)
    p = mesh.num_triangles
    g = cluster_rows_for(p, cluster_rows) * LANE
    k = num_clusters(p, cluster_rows)
    p_pad = k * g
    k_pad = max(-(-k // LANE) * LANE, LANE)

    # Degenerate padding triangles: far away, zero edges -> det == 0 -> miss.
    v0, e1, e2 = _padded_tris(mesh, p_pad, 1.0e9)
    lo, hi = _padded_boxes(v0, e1, e2, k, _box_eps(mesh))
    lo_p = torch.nn.functional.pad(lo, (0, 0, 0, k_pad - k), value=BIG)
    hi_p = torch.nn.functional.pad(hi, (0, 0, 0, k_pad - k), value=-BIG)
    tri_planes = torch.cat([v0.T, e1.T, e2.T]).contiguous()
    box_planes = torch.cat([lo_p.T, hi_p.T]).contiguous()
    return MeshClusters(
        tri_planes, box_planes, k, g, p, mesh.bvh_min[0].clone(),
        mesh.bvh_max[0].clone(), prep_row_boxes(mesh, p_pad),
        prep_group_boxes(box_planes, k),
        build_mt_features(mesh, p_pad) if mt == "mxu" else None)


def prep_row_boxes(mesh: TriangleMesh, p_pad: int) -> torch.Tensor:
    """[6, p_pad / 128] f32: per 128-triangle row of the padded triangles,
    its AABB (rows lo x, y, z, hi x, y, z: the JAX function's six arrays),
    with the cluster boxes' epsilon padding; rows of padding triangles sit
    at 1e9 (counterpart of prep_row_boxes, bit for bit)."""
    v0, e1, e2 = _padded_tris(mesh, p_pad, 1.0e9)
    lo, hi = _padded_boxes(v0, e1, e2, p_pad // LANE, _box_eps(mesh))
    return torch.cat([lo.T, hi.T]).contiguous()


def _fma_cross(a, b):
    """a x b [P, 3] as XLA:CPU computes jnp.cross: each component
    fma(a1, b2, -(a2 * b1)) with the second product rounded to f32, the
    fused multiply-add emulated in float64 (the product a1 * b2 is exact
    there; one double rounding in about 2^29 results could differ)."""
    def fms(i, j):
        return (a[:, i].double() * b[:, j].double()
                - (a[:, j] * b[:, i]).double()).float()
    return torch.stack([fms(1, 2), fms(2, 0), fms(0, 1)], dim=1)


def build_mt_features(mesh: TriangleMesh, p_pad: int) -> torch.Tensor:
    """[19, p_pad] f32: the per-triangle factors of the bilinear-form
    Moller-Trumbore (counterpart of build_mt_features, each factor bit for
    bit). With m = o x d, n = e1 x e2, c1 = v0 x e1, c2 = v0 x e2:

        det = d . (-n),  det * u = (m, d) . (e2, c2),
        det * v = (m, d) . (-e1, -c1),  det * t = (o, 1) . (n, -v0 . n).

    Stored plane-major, one [p_pad] row per factor in the order -n | e2,
    c2 | -e1, -c1 | n, -v0 . n, where the TPU interleaves them by 128-lane
    row ([PR * q, 128]). The padding triangles are zero here, not 1e9, so
    n = 0, det = 0, and they are rejected. The cross products round as
    XLA:CPU's contracted jnp.cross (_fma_cross); v0 . n sums its three
    products left to right onto +0.0, as XLA:CPU's jnp.sum does (so a sum
    of zeros is +0.0)."""
    v0, e1, e2 = _padded_tris(mesh, p_pad, 0.0)
    n = _fma_cross(e1, e2)
    c1 = _fma_cross(v0, e1)
    c2 = _fma_cross(v0, e2)
    w = v0 * n
    v0n = ((0.0 + w[:, 0]) + w[:, 1]) + w[:, 2]
    return torch.cat([-n, e2, c2, -e1, -c1, n, -v0n[:, None]],
                     dim=1).T.contiguous()


def _part1by2(x):
    """Spread the low 10 bits of x to every 3rd bit (Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def sort_keys(ox, oy, oz, dx, dy, dz, alive, lo, hi):
    """[N] i32 wavefront coherence key: direction octant, then the origin's
    Morton cell in the scene box lo/hi (the BVH root box); dead rays get
    1 << 30 and sort last."""
    ext = torch.clamp_min(hi - lo, 1e-6)
    cell = [torch.clamp(((c - lo[a]) / ext[a] * 32.0).to(torch.int32), 0, 31)
            for a, c in enumerate((ox, oy, oz))]
    morton = (_part1by2(cell[0]) << 2) | (_part1by2(cell[1]) << 1) \
        | _part1by2(cell[2])
    key = (_octant(dx, dy, dz) << 15) | morton
    if alive is not None:
        key = torch.where(alive, key, 1 << 30)
    return key


def _check(mc: MeshClusters, rays, alive, t_cap) -> None:
    check_rays((*rays, t_cap), alive)
    dev = rays[0].device
    for x, rows in ((mc.tri_planes, 9), (mc.box_planes, 6)):
        if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != rows
                or not x.is_contiguous() or x.device != dev):
            raise ValueError("mesh tables must come from prep_mesh_clusters "
                             "on the rays' device")
    if mc.box_planes.shape[1] < mc.k or \
            mc.tri_planes.shape[1] < mc.k * mc.tris_per_cluster:
        raise ValueError("mesh tables are smaller than their cluster count")
    gb, ng = mc.group_boxes, num_groups(mc.k)
    if (gb.dtype != torch.float32 or gb.shape != (6, ng)
            or not gb.is_contiguous() or gb.device != dev):
        raise ValueError(f"group_boxes must be the [6, {ng}] float32 "
                         f"prep_group_boxes of the {mc.k} clusters, on the "
                         f"rays' device")


def _defaults(ox, alive, t_cap):
    if alive is None:
        alive = torch.ones(ox.shape[0], dtype=torch.bool, device=ox.device)
    if t_cap is None:
        t_cap = torch.full_like(ox, BIG)
    return alive, t_cap


# --------------------------------------------------------------- A4
def first_crossed_cluster(mc: MeshClusters, ox, oy, oz, dx, dy, dz,
                          t_min: float, alive=None, t_cap=None, *,
                          interpret: bool = False, pair: bool = False):
    """[N] i32: the lowest id of a cluster whose slab test passes with an
    entry at most min(t_cap * 1.0001 + 1e-4, 1e37); k when none and on dead
    lanes. pair=True returns (c1, c2): also the lowest such id above c1, k
    when none. The kernel walks the group boxes first
    (crossing_walk_gated_plain), which changes no id."""
    rays = (ox, oy, oz, dx, dy, dz)
    alive, t_cap = _defaults(ox, alive, t_cap)
    _check(mc, rays, alive, t_cap)
    dev = ox.device
    if not cuda_build.use_kernel(dev, interpret, "first_crossed_cluster"):
        return first_crossed_cluster_plain(mc, *rays, t_min, alive, t_cap,
                                           pair=pair)
    n = ox.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    out2 = torch.empty(n, dtype=torch.int32, device=dev) if pair else None
    cuda_build.launch(
        "qtrt_mesh_first_cluster", *(x.data_ptr() for x in rays),
        alive.data_ptr(), t_cap.data_ptr(), mc.box_planes.data_ptr(), mc.k,
        mc.box_planes.shape[1], mc.group_boxes.data_ptr(),
        mc.group_boxes.shape[1], float(t_min), n, out.data_ptr(),
        out2.data_ptr() if pair else None, device=dev,
        counted=("mesh_first_cluster[pair]",) if pair
        else ("mesh_first_cluster",))
    return (out, out2) if pair else out


def slab_inv(d):
    """Slab reciprocal of a direction component, as the TPU kernels take it:
    1 / (|d| < 1e-30 ? (d < 0 ? -1e-30 : 1e-30) : d)."""
    return torch.reciprocal(torch.where(
        torch.abs(d) < 1e-30, torch.where(d < 0, -1e-30, 1e-30), d))


def slab_boxes(box, o, inv, t_min):
    """(enter, exit) of rays against boxes, broadcast: box is a sequence of
    the six planes (lo x, y, z, hi x, y, z), o and inv the rays' three
    components each, all broadcastable to one shape; the TPU kernels' axis
    order."""
    enter = exit_ = None
    for a in range(3):
        t0 = (box[a] - o[a]) * inv[a]
        t1 = (box[3 + a] - o[a]) * inv[a]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        enter = torch.clamp_min(near, t_min) if a == 0 \
            else torch.maximum(enter, near)
        exit_ = torch.clamp_max(far, BIG) if a == 0 \
            else torch.minimum(exit_, far)
    return enter, exit_


def _slab(box_planes, lo_c, hi_c, o, inv, t_min):
    """(enter, exit) of rays [m] against boxes [lo_c, hi_c): [m, c] each."""
    return slab_boxes(box_planes[:, lo_c:hi_c], tuple(x[:, None] for x in o),
                      tuple(x[:, None] for x in inv), t_min)


def crossing_mask(mc: MeshClusters, o, inv, cap, alive, c0: int, c_hi: int,
                  t_min: float) -> torch.Tensor:
    """[m, c_hi - c0] bool: the gate of A4, A7 and A3's first look at a
    cluster, for rays (o, inv components [m], slacked cap, alive) against
    clusters [c0, c_hi): exit > enter and enter <= cap on a live lane."""
    enter, exit_ = _slab(mc.box_planes, c0, c_hi, o, inv, float(t_min))
    return (exit_ > enter) & (enter <= cap[:, None]) & alive[:, None]


def first_crossed_cluster_plain(mc: MeshClusters, ox, oy, oz, dx, dy, dz,
                                t_min: float, alive, t_cap,
                                slice_rays: int = PLAIN_SLICE_RAYS,
                                pair: bool = False):
    """Plain PyTorch version of A4, in [slice_rays, clusters] blocks; with
    pair=True (c1, c2), the second from another pass over the clusters
    above c1."""
    n, k = ox.shape[0], mc.k
    out = torch.full((n,), k, dtype=torch.int32, device=ox.device)
    out2 = out.clone() if pair else None
    cap_all = torch.clamp_max(t_cap * 1.0001 + 1e-4, 1e37)
    for lo in range(0, n, slice_rays):
        sl = slice(lo, min(n, lo + slice_rays))
        o = (ox[sl], oy[sl], oz[sl])
        inv = tuple(slab_inv(d) for d in (dx[sl], dy[sl], dz[sl]))

        def lowest(above=None):
            c = out[sl]
            for c0 in range(0, k, PLAIN_SLICE_CLUSTERS):
                c_hi = min(k, c0 + PLAIN_SLICE_CLUSTERS)
                mask = crossing_mask(mc, o, inv, cap_all[sl], alive[sl], c0,
                                     c_hi, t_min)
                cid = torch.arange(c0, c_hi, dtype=torch.int32,
                                   device=ox.device)
                if above is not None:
                    mask = mask & (cid[None, :] > above[:, None])
                c = torch.minimum(c, torch.where(mask, cid, k).amin(dim=1))
            return c

        c1 = lowest()
        if pair:
            out2[sl] = lowest(above=c1)
        out[sl] = c1
    return (out, out2) if pair else out


def crossing_walk_gated_plain(mc: MeshClusters, ox, oy, oz, dx, dy, dz,
                              t_min: float, alive, t_cap, c_max: int, *,
                              stop: bool = False,
                              slice_rays: int = PLAIN_SLICE_RAYS):
    """The two-level walk of A4 and A7 in plain PyTorch, with a count of its
    work: (lists [N, c_max] i32, ncross [N] i32, group_tests [N] i32,
    member_tests [N] i32). Per live ray, in ascending order, group box j
    (``MeshClusters.group_boxes``) takes the capped slab test of
    crossing_mask; only when it passes are the boxes of its GROUP_C members
    tested, in ascending id, and each member that passes is the ray's next
    crossed id. lists holds the first c_max ids, filled with k; ncross
    counts them all (A7). With stop=True the walk ends at the c_max-th id
    (A4: c_max = 1; its pair variant: 2): ncross then stops at c_max, and
    the tests are counted up to there. With one cluster, the one group box
    is its box, and the kernels take that one test alone. Dead lanes: all
    k, 0 everywhere. A member that passes makes its group pass, so lists
    and ncross equal crossing_lists_plain's and
    first_crossed_cluster_plain's. A measuring aid and the subject of the
    CPU tests; no path runs it."""
    n, k = ox.shape[0], mc.k
    dev = ox.device
    cid = torch.arange(k, dtype=torch.int32, device=dev)
    grp = (cid // GROUP_C).long()
    sizes = torch.bincount(grp, minlength=num_groups(k)).to(torch.int32)
    tested = sizes if k > 1 else torch.zeros_like(sizes)  # an open group's
    lists = torch.full((n, c_max), k, dtype=torch.int32, device=dev)
    ncross = torch.zeros(n, dtype=torch.int32, device=dev)
    tests = torch.zeros((2, n), dtype=torch.int32, device=dev)
    cap_all = torch.clamp_max(t_cap * 1.0001 + 1e-4, 1e37)
    for lo in range(0, n, slice_rays):
        sl = slice(lo, min(n, lo + slice_rays))
        o = (ox[sl], oy[sl], oz[sl])
        inv = tuple(slab_inv(d) for d in (dx[sl], dy[sl], dz[sl]))
        cap, live = cap_all[sl], alive[sl]
        enter, exit_ = _slab(mc.group_boxes, 0, sizes.shape[0], o, inv,
                             float(t_min))
        opened = (exit_ > enter) & (enter <= cap[:, None]) & live[:, None]
        passed = crossing_mask(mc, o, inv, cap, live, 0, k, t_min) \
            & opened[:, grp]
        rank = torch.cumsum(passed, dim=1)          # ids found up to here
        if stop:
            passed &= rank <= c_max
        found = passed.sum(dim=1)
        ids = torch.where(passed, cid, k)
        ids = torch.nn.functional.pad(ids, (0, max(c_max - k, 0)), value=k)
        lists[sl] = torch.sort(ids, dim=1).values[:, :c_max]
        ncross[sl] = found.to(torch.int32)
        # Where the walk stopped: the c_max-th id when stop, else nowhere.
        last = torch.where(passed, cid, -1).amax(dim=1)
        halted = live & (found >= c_max) if stop else torch.zeros_like(live)
        end = torch.where(halted, last, k - 1)      # the last id tested
        g_end = (end // GROUP_C).long()
        before = torch.arange(sizes.shape[0], device=dev)[None, :] \
            < g_end[:, None]
        members = ((opened & before) * tested).sum(dim=1)
        in_last = torch.where(halted, end - g_end * GROUP_C + 1,
                              sizes[g_end])
        in_last = in_last if k > 1 else torch.zeros_like(in_last)
        members = members + torch.where(opened.gather(1, g_end[:, None])[:, 0],
                                        in_last, 0)
        tests[0, sl] = torch.where(live, g_end + 1, 0).to(torch.int32)
        tests[1, sl] = torch.where(live, members, 0).to(torch.int32)
    return lists, ncross, tests[0], tests[1]


# --------------------------------------------------------------- A3
def _check_tables(mc: MeshClusters, mt: str, visit: str) -> None:
    """The extra table that A3's instance for (mt, visit) reads is there."""
    inst = _instance(mt, visit)
    if inst == _VPU:
        return
    name, x, rows, cols = (
        ("mt_planes", mc.mt_planes, MT_FEATURES, mc.k * mc.tris_per_cluster)
        if inst == _MXU else
        ("row_boxes", mc.row_boxes, 6, mc.k * mc.tris_per_cluster // LANE))
    if x is None:
        raise ValueError(f"mt={mt!r} reads the mesh's {name}: build it with "
                         f"prep_mesh_clusters(mesh, mt={mt!r})")
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != rows
            or x.shape[1] < cols or not x.is_contiguous()
            or x.device != mc.tri_planes.device):
        raise ValueError(f"{name} must come from prep_mesh_clusters on the "
                         f"rays' device")


def mesh_hits(mc: MeshClusters, ox, oy, oz, dx, dy, dz, t_min: float,
              alive=None, t_cap=None, *, interpret: bool = False,
              exclude=None, mt: str = "vpu", visit: str = "full"):
    """Kernel A3 on the rays as given (no sort): (t [N] f32, idx [N] i32),
    the closest triangle hit strictly below t_cap (default BIG), ties to
    the lowest BVH-order id; (BIG, 0) where none beats the cap and on dead
    lanes. exclude: optional [N] integer BVH-order triangle id the lane
    never accepts (-1 for none). mt and visit pick the instance (module
    docstring); "subtile" and "sliced" launch the "full" one."""
    check_search_options(mt, visit)
    rays = (ox, oy, oz, dx, dy, dz)
    alive, t_cap = _defaults(ox, alive, t_cap)
    _check(mc, rays, alive, t_cap)
    _check_tables(mc, mt, visit)
    exclude = check_exclude(exclude, ox)
    dev = ox.device
    if not cuda_build.use_kernel(dev, interpret, "mesh_hits"):
        return mesh_search_plain(mc, *rays, t_min, alive, t_cap,
                                 exclude=exclude, mt=mt, visit=visit)
    inst = _instance(mt, visit)
    tris = mc.mt_planes if inst == _MXU else mc.tri_planes
    rows = mc.row_boxes if inst == _ROWGATE else None
    n = ox.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    counted = launch_counts("mesh_search", exclude) + {
        _VPU: (), _ROWGATE: ("mesh_search[rowgate]",),
        _MXU: ("mesh_search[mxu]",)}[inst]
    cuda_build.launch(
        "qtrt_mesh_search", *(x.data_ptr() for x in rays), alive.data_ptr(),
        t_cap.data_ptr(), excl_ptr(exclude), tris.data_ptr(), tris.shape[1],
        None if rows is None else rows.data_ptr(),
        0 if rows is None else rows.shape[1], mc.box_planes.data_ptr(), mc.k,
        mc.box_planes.shape[1], mc.tris_per_cluster, inst, float(t_min), n,
        t.data_ptr(), idx.data_ptr(), device=dev, counted=counted)
    return t, idx


def _ray_moment(o, d):
    """m = o x d, the ray-side factor of the bilinear forms, single-rounded
    in the JAX package's order (o1 * d2 - o2 * d1, ...)."""
    return (o[1] * d[2] - o[2] * d[1],
            o[2] * d[0] - o[0] * d[2],
            o[0] * d[1] - o[1] * d[0])


def _sweep(mc: MeshClusters, mt: str, o, d, m, p0: int, p1: int,
           t_min: float):
    """(t, accept) of rays o, d ([m, 1] components; m = o x d for "mxu")
    against the triangles [p0, p1): [m, p1 - p0] each, by the engine mt."""
    if mt == "mxu":
        return _moller_trumbore_bilinear(o, d, m, mc.mt_planes[:, p0:p1],
                                         t_min)
    tp = mc.tri_planes
    return _moller_trumbore(o, d, tuple(tp[a, p0:p1] for a in range(3)),
                            tuple(tp[3 + a, p0:p1] for a in range(3)),
                            tuple(tp[6 + a, p0:p1] for a in range(3)), t_min)


def mesh_search_gated_plain(mc: MeshClusters, ox, oy, oz, dx, dy, dz,
                            t_min: float, alive, t_cap, *, mt: str = "vpu",
                            visit: str = "full", exclude=None):
    """The kernel's gated sweep in plain PyTorch, cluster by cluster, with a
    count of its work: (t, idx, visits), where visits is the number of
    (ray, cluster) pairs that pass the kernel's per-lane gate (the slab test
    with an entry at most min(t_best * 1.0001 + 1e-4, 1e37) of the lane's
    running hit), each of which costs one Moller-Trumbore row of
    tris_per_cluster triangles. (t, idx) equal mesh_search_plain's: the
    gate never drops a winner. Under the row-gated instance (visit
    "rowgate", mt "vpu") each 128-triangle row of a visited cluster is gated
    the same way on its own box before it is swept, and the result is
    (t, idx, visits, row_visits), row_visits counting the (ray, row) pairs
    swept; it is that instance's plain version. Under mt "mxu" it runs the
    kernel's work: the rays in blocks of MXU_BLOCK_RAYS as they lie (dead
    lanes and all); at a cluster's turn the rays of a block that pass their
    gate packed into tiles of MXU_RAYS, each of their pairs through
    mxu_filter_plain. The result is (t, idx, visits, work), work counting
    tile_visits and block_visits (the packed tiles and the (block, cluster)
    pairs visited) and filter_passes (the pairs the filter passes on to the
    exact test). (t, idx) stay the exact sweep's, independent of the
    filter; it raises AssertionError where the filter rejects a pair that
    the exact test accepts, so that a sound filter, and the kernel's
    filter-then-exact-test with it, is checked at the caller's shapes. A
    measuring aid otherwise; no path runs it."""
    check_search_options(mt, visit)
    _check_tables(mc, mt, visit)
    rowgate = _instance(mt, visit) == _ROWGATE
    mxu = _instance(mt, visit) == _MXU
    n = ox.shape[0]
    dev = ox.device
    live = torch.nonzero(alive).squeeze(1)
    o = tuple(c[live] for c in (ox, oy, oz))
    d = tuple(c[live] for c in (dx, dy, dz))
    inv = tuple(slab_inv(c) for c in d)
    m = _ray_moment(o, d) if mt == "mxu" else (None,) * 3
    ex = None if exclude is None else exclude[live]
    cap = t_cap[live]
    t_best = cap.clone()
    best = torch.zeros(live.shape[0], dtype=torch.int32, device=dev)
    g = mc.tris_per_cluster
    visits = row_visits = 0
    work = dict(tile_visits=0, block_visits=0, filter_passes=0)
    block = torch.div(live, MXU_BLOCK_RAYS, rounding_mode="floor")

    def gate(boxes, j, ids):
        """The lanes of ids whose slab test of box j passes under their
        running cap."""
        enter, exit_ = _slab(boxes, j, j + 1,
                             tuple(c[ids] for c in o),
                             tuple(c[ids] for c in inv), float(t_min))
        cap_now = torch.clamp_max(t_best[ids] * 1.0001 + 1e-4, 1e37)
        return ids[(exit_[:, 0] > enter[:, 0]) & (enter[:, 0] <= cap_now)]

    def sweep(ids, p0, p1):
        t, ok = _sweep(mc, mt, tuple(c[ids][:, None] for c in o),
                       tuple(c[ids][:, None] for c in d),
                       tuple(None if c is None else c[ids][:, None]
                             for c in m), p0, p1, float(t_min))
        if mxu:
            # The kernel's filter: counted, and held sound against the
            # exact test, which alone decides here.
            maybe = mxu_filter_plain(
                tuple(c[ids][:, None] for c in d),
                tuple(c[ids][:, None] for c in m), mc.mt_planes[:, p0:p1])
            if bool((ok & ~maybe).any()):
                raise AssertionError(
                    "the bilinear-form filter rejects a pair that the "
                    "exact test accepts")
            work["filter_passes"] += int(maybe.sum())
        gid = torch.arange(p0, p1, dtype=torch.int32, device=dev)
        if ex is not None:
            ok = ok & (gid[None, :] != ex[ids][:, None])
        tcand = torch.where(ok & (t < t_best[ids][:, None]), t, BIG)
        tmin_c = tcand.amin(dim=1)
        idx_c = torch.where(tcand == tmin_c[:, None], gid,
                            mc.k * g).amin(dim=1)
        better = tmin_c < t_best[ids]
        t_best[ids] = torch.where(better, tmin_c, t_best[ids])
        best[ids] = torch.where(better, idx_c, best[ids])

    everyone = torch.arange(live.shape[0], device=dev)
    for j in range(mc.k):
        ids = gate(mc.box_planes, j, everyone)
        visits += int(ids.shape[0])
        if not ids.shape[0]:
            continue
        if mxu:
            per_block = torch.unique(block[ids], return_counts=True)[1]
            work["tile_visits"] += int(torch.div(
                per_block + MXU_RAYS - 1, MXU_RAYS,
                rounding_mode="floor").sum())
            work["block_visits"] += int(per_block.shape[0])
            for lo in range(0, ids.shape[0], 4 * PLAIN_SLICE_RAYS):
                sweep(ids[lo:lo + 4 * PLAIN_SLICE_RAYS], j * g, (j + 1) * g)
            continue
        if not rowgate:
            sweep(ids, j * g, (j + 1) * g)
            continue
        # t_best only shrinks, so a row that fails its gate now could not
        # pass it later in the cluster: skipping it drops no winner.
        for row in range(j * g // LANE, (j + 1) * g // LANE):
            ids_r = gate(mc.row_boxes, row, ids)
            row_visits += int(ids_r.shape[0])
            if ids_r.shape[0]:
                sweep(ids_r, row * LANE, (row + 1) * LANE)
    won = t_best < cap
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    idx_out = torch.zeros(n, dtype=torch.int32, device=dev)
    t_out[live] = torch.where(won, t_best, BIG)
    idx_out[live] = torch.where(won, best, 0)
    if rowgate:
        return t_out, idx_out, visits, row_visits
    if mxu:
        return t_out, idx_out, visits, work
    return t_out, idx_out, visits


def mesh_search_plain(mc: MeshClusters, ox, oy, oz, dx, dy, dz,
                      t_min: float, alive, t_cap,
                      slice_rays: int = PLAIN_SLICE_RAYS,
                      slice_tris: int = PLAIN_SLICE_TRIS, exclude=None, *,
                      mt: str = "vpu", visit: str = "full"):
    """Plain PyTorch version of A3: the ungated sweep over every triangle,
    in [slice_rays, slice_tris] blocks of live rays. Within a block the
    minimum t, then the lowest id reaching it; across blocks, in ascending
    order, a strict '<' update. The kernel's gate must not change this.
    exclude ([N] i32 or None): the triangle id each lane never accepts.
    mt="mxu" sweeps with the bilinear-form Moller-Trumbore, rounded op by
    op in the kernel's order; the row-gated instance's plain version is
    the row-gated sweep of mesh_search_gated_plain, which must give these
    same bits."""
    check_search_options(mt, visit)
    _check_tables(mc, mt, visit)
    if _instance(mt, visit) == _ROWGATE:
        return mesh_search_gated_plain(mc, ox, oy, oz, dx, dy, dz, t_min,
                                       alive, t_cap, mt=mt, visit=visit,
                                       exclude=exclude)[:2]
    n = ox.shape[0]
    dev = ox.device
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    idx_out = torch.zeros(n, dtype=torch.int32, device=dev)
    live = torch.nonzero(alive).squeeze(1)
    p = mc.k * mc.tris_per_cluster
    t_min = float(t_min)
    for lo in range(0, live.shape[0], slice_rays):
        ids = live[lo:lo + slice_rays]
        o = tuple(c[ids][:, None] for c in (ox, oy, oz))          # [m, 1]
        d = tuple(c[ids][:, None] for c in (dx, dy, dz))
        m = _ray_moment(o, d) if mt == "mxu" else None
        cap = t_cap[ids]
        ex = None if exclude is None else exclude[ids][:, None]
        t_best = cap.clone()
        best = torch.zeros(ids.shape[0], dtype=torch.int32, device=dev)
        for p0 in range(0, p, slice_tris):
            p1 = min(p, p0 + slice_tris)
            t, ok = _sweep(mc, mt, o, d, m, p0, p1, t_min)
            ok = ok & (t < t_best[:, None])
            gid = torch.arange(p0, p1, dtype=torch.int32, device=dev)
            if ex is not None:
                ok = ok & (gid[None, :] != ex)
            tcand = torch.where(ok, t, BIG)
            tmin_c = tcand.amin(dim=1)
            idx_c = torch.where(tcand == tmin_c[:, None], gid, p).amin(dim=1)
            better = tmin_c < t_best
            t_best = torch.where(better, tmin_c, t_best)
            best = torch.where(better, idx_c, best)
        won = t_best < cap
        t_out[ids] = torch.where(won, t_best, BIG)
        idx_out[ids] = torch.where(won, best, 0)
    return t_out, idx_out


def _accept(det, num_u, num_v, num_t, t_min):
    """(t, accept) from the determinant and the numerators of u, v and t:
    visit_vpu's accept test."""
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0, 0.0) / torch.where(ok_det, det, 1.0)
    u = num_u * inv_det
    v = num_v * inv_det
    t = num_t * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min))
    return t, ok


def _moller_trumbore(o, d, v0, e1, e2, t_min):
    """(t, accept) of rays o, d ([m, 1] components) against triangles v0,
    e1, e2 ([T] components): [m, T] each, with the expression tree of the
    TPU kernel's visit_vpu."""

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    pv = cross(d, e2)
    s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    qv = cross(s, e1)
    return _accept(dot3(pv, e1), dot3(s, pv), dot3(qv, d), dot3(qv, e2),
                   t_min)


def _moller_trumbore_bilinear(o, d, m, f, t_min):
    """(t, accept) of rays o, d with m = o x d ([m, 1] components) against
    the triangles of the factor planes f ([19, T], build_mt_features):
    det = d . f[0:3], u det = (m, d) . f[3:9], v det = (m, d) . f[9:15],
    t det = o . f[15:18] + f[18], each product rounded, each sum left to
    right, as the kernel's moller_trumbore_bilinear; then visit_vpu's
    accept test."""

    def dot(r, rows):
        acc = r[0] * rows[0]
        for a, b in zip(r[1:], rows[1:]):
            acc = acc + a * b
        return acc

    md = (*m, *d)
    return _accept(dot(d, f[0:3]), dot(md, f[3:9]), dot(md, f[9:15]),
                   dot(o, f[15:18]) + f[18], t_min)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32 as cvt.rna.tf32.f32 rounds it: to 10
    explicit significand bits, to nearest, ties away from zero (add half a
    unit of the 13 dropped bits to the magnitude, then drop them); inf and
    NaN as they are."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c (float32; b a tensor or a float32-exact number) rounded
    once to float32, as fmaf rounds it: the product is exact in float64,
    the sum is taken to float64 rounded to odd (its error by TwoSum), from
    which one rounding to float32 is the correctly rounded result."""
    p = a.double() * b
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).double()
    s = torch.where((err != 0) & even & torch.isfinite(err),
                    torch.nextafter(s, away), s)
    return s.float()


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Values below 2^-126 in magnitude to zero, as a tensor core may."""
    return torch.where(x.abs() < 2.0 ** -126, 0.0, x)


def _mma_form(a, b, acc: float, ftz: bool, floor_of=None):
    """(value, margin) of the kernel's two tensor-core products for one
    form, a [m, 1] ray features (float32, its K real ones) and b [K, T]
    factors: the value from the TF32 operands, its K products exact and
    their sum off by acc * MXU_ACC times the sum of their magnitudes (acc
    in [-1, 1]: the worst cases at +-1); the margin from c * max(|a~|,
    MXU_FLOOR) and |b~|, started at MXU_ABS * (sum |a| + 2K + 1) (sum |a|
    over runs of three features, as the kernel adds them; plus floor_of *
    MXU_TAU in one FMA, floor_of [m, T], where given) and taken MXU_ACC
    low. With ftz, operands and products below 2^-126 count as zero. Both
    [m, T] float32."""
    k = len(a)
    fl = _flush if ftz else (lambda x: x)
    at = [fl(tf32_round(x)).double() for x in a]
    bt = [fl(tf32_round(b[j])).double() for j in range(k)]
    prods = [fl(x * y) for x, y in zip(at, bt)]
    val = sum(prods[1:], prods[0])
    mag = sum((p.abs() for p in prods[1:]), prods[0].abs())
    val = (val + acc * MXU_ACC * mag).float()
    sa = None
    for j in range(0, k, 3):
        run = a[j].abs()
        for x in a[j + 1:j + 3]:
            run = run + x.abs()
        sa = run if sa is None else sa + run
    start = MXU_ABS * (sa + float(2 * k + 1))
    if floor_of is not None:
        start = _fma32(floor_of, MXU_TAU, start)
    start = start.double()
    terms = [fl((MXU_C * torch.clamp_min(x.abs(), MXU_FLOOR)) * y.abs())
             for x, y in zip(at, bt)]
    margin = ((start + sum(terms[1:], terms[0])) * (1.0 - MXU_ACC)).float()
    return val, margin


def mxu_filter_plain(d, m, f, *, acc=(0.0, 0.0, 0.0),
                     ftz: bool = True) -> torch.Tensor:
    """[m, T] bool: the pairs that the bilinear-form kernel's TF32 filter
    passes on to the exact test (csrc/mesh_intersect.cu, maybe_hit), for
    rays of direction d with m = o x d ([m, 1] float32 components, as
    _moller_trumbore_bilinear takes them) and the factor planes f ([19,
    T]). The tensor core's products are modelled by _mma_form, acc giving
    the sign (or fraction) of the accumulation error of det, u det and v
    det; the epilogue then runs in float32, op by op as the kernel's (its
    two FMAs rounded once, by _fma32). A pair is rejected only where |D| +
    E_D < DET_LO, or where |D| > E_D and u or v is certainly negative, or
    u + v certainly above 1; it never looks at t (a variant with t det and
    tests on t ran slower on the card, PERF.md §6). NaN passes. The exact
    test decides every pair that passes."""
    md = (*m, *d)
    D, ED = _mma_form(d, f[0:3], acc[0], ftz)
    aD = D.abs()
    # The floor of u and v rides in their margins' start, as in the kernel.
    U, EU = _mma_form(md, f[3:9], acc[1], ftz, aD)
    V, EV = _mma_form(md, f[9:15], acc[2], ftz, aD)
    adE = aD + ED
    neg = torch.signbit(D)
    sU = torch.where(neg, -U, U)
    sV = torch.where(neg, -V, V)
    out = (sU < -EU) | (sV < -EV) | (_fma32(adE, K_UV, EU + EV) < sU + sV)
    return ~((adE < DET_LO) | ((aD > ED) & out))


# --------------------------------------------------------------- pipeline
def _octant(dx, dy, dz):
    return ((dx < 0).to(torch.int32) * 4 + (dy < 0).to(torch.int32) * 2
            + (dz < 0).to(torch.int32))


def crossing2_keys(mc: MeshClusters, ox, oy, oz, dx, dy, dz, alive, c1, c2):
    """[N] i32 two-cluster sort key: (c1 * (k + 1) + c2) << 15 | octant << 12
    | the origin's 12-bit Morton cell (16 cells per axis of the BVH root
    box); dead rays get 2^31 - 1 and sort last."""
    lo = mc.root_lo
    ext = torch.clamp_min(mc.root_hi - lo, 1e-6)
    cell = [torch.clamp(((c - lo[a]) / ext[a] * 16.0).to(torch.int32), 0, 15)
            for a, c in enumerate((ox, oy, oz))]
    m12 = ((_part1by2(cell[0]) << 2) | (_part1by2(cell[1]) << 1)
           | _part1by2(cell[2])) & 0xFFF
    key = (c1 * (mc.k + 1) + c2) * (1 << 15) + (_octant(dx, dy, dz) << 12) \
        + m12
    return torch.where(alive, key, 2 ** 31 - 1)


def crossing_order(mc: MeshClusters, ox, oy, oz, dx, dy, dz, t_min: float,
                   alive, t_cap, *, interpret: bool = False,
                   sort_mode: str = "crossing") -> torch.Tensor:
    """The wavefront permutation mesh_search applies before A3: a stable
    sort by the key of sort_mode. "crossing": c1 * 2^18 + sort_keys, with c1
    from A4; "crossing2": crossing2_keys, with (c1, c2) from A4's pair
    variant (k <= 254, or the key leaves int32); "morton": sort_keys."""
    if sort_mode not in SORT_MODES:
        raise ValueError(f"sort_mode must be one of {SORT_MODES}, got "
                         f"{sort_mode!r}")
    rays = (ox, oy, oz, dx, dy, dz)
    if sort_mode == "crossing2":
        if mc.k > CROSSING2_MAX_K:
            raise ValueError(
                f"sort_mode='crossing2' packs two cluster ids into an int32 "
                f"key and takes at most {CROSSING2_MAX_K} clusters, got "
                f"{mc.k}")
        c1, c2 = first_crossed_cluster(mc, *rays, t_min, alive, t_cap,
                                       interpret=interpret, pair=True)
        key = crossing2_keys(mc, *rays, alive, c1, c2)
    else:
        key = sort_keys(*rays, alive, mc.root_lo, mc.root_hi)
        if sort_mode == "crossing":
            c1 = first_crossed_cluster(mc, *rays, t_min, alive, t_cap,
                                       interpret=interpret)
            key = c1 * (1 << 18) + key
    return torch.sort(key, stable=True).indices


@torch.no_grad()
def mesh_search(mc: MeshClusters, ox, oy, oz, dx, dy, dz, t_min: float,
                alive=None, t_cap=None, *, sort: bool = True,
                interpret: bool = False, mt: str = "vpu",
                visit: str = "full", sort_mode: str = "crossing",
                exclude=None, pipe: str = "gather"):
    """Closest hit over the mesh: (t [N] f32, BIG = miss; idx [N] i32, the
    BVH-order triangle id), strictly below t_cap (default BIG). With
    sort=True, n >= 2048 and more than one cluster, the wavefront is sorted
    by the key of sort_mode ("crossing", "crossing2" or "morton", see
    crossing_order) before A3 and the results are put back; live lanes get
    the same result either way. Both outputs are detached.
    exclude: optional [N] integer BVH-order triangle id that the lane never
    accepts (-1 for none); it is sorted with its ray.
    mt ("vpu", "mxu") and visit ("full", "subtile", "sliced", "rowgate")
    pick A3's instance (module docstring; mt="mxu" reads the factors that
    prep_mesh_clusters(mt="mxu") adds). pipe: "gather" or "fused", the JAX
    package's names for how the operands move through the sort; both take
    the one gather-and-scatter step here (module docstring)."""
    check_search_options(mt, visit, pipe)
    if sort_mode not in SORT_MODES:
        raise ValueError(f"sort_mode must be one of {SORT_MODES}, got "
                         f"{sort_mode!r}")
    rays = (ox, oy, oz, dx, dy, dz)
    alive, t_cap = _defaults(ox, alive, t_cap)
    _check(mc, rays, alive, t_cap)
    _check_tables(mc, mt, visit)
    exclude = check_exclude(exclude, ox)
    n = ox.shape[0]
    body = dict(interpret=interpret, mt=mt, visit=visit)
    if not (sort and n >= SORT_MIN_RAYS and mc.k > 1):
        return mesh_hits(mc, *rays, t_min, alive, t_cap, exclude=exclude,
                         **body)
    perm = crossing_order(mc, *rays, t_min, alive, t_cap, interpret=interpret,
                          sort_mode=sort_mode)
    g = lambda x: x[perm]
    # The exclude id belongs to its ray: it takes the same permutation.
    t_s, idx_s = mesh_hits(mc, *map(g, rays), t_min, g(alive), g(t_cap),
                           exclude=None if exclude is None else g(exclude),
                           **body)
    t = torch.empty_like(t_s)
    idx = torch.empty_like(idx_s)
    t[perm] = t_s
    idx[perm] = idx_s
    return t, idx
