"""Fused closest-hit query: the CUDA kernel's wrapper and its plain version.

Counterpart of ``qt_raytracer_tpu.kernels.fused_hit``. Full mode (kernel
A1), per ray: the closest sphere hit (the lowest sphere id wins a tie), the
winner's 13 material parameters, t refined with the stable root, the hit
point, the front-face flag and the signed normal, as 19 flat [N] outputs.
Shadow mode (``shadow_only=True``, kernel A2): only ``t``, the unrefined
sweep minimum, and ``idx``, the lowest winning id (0 on a miss); next-event
estimation tests occlusion with it and caps the mesh search by that t.
Both modes take an optional per-lane ``exclude`` operand ([N] sphere ids, -1
for none): that sphere is masked out of the lane's sweep before the minimum
(the edge-aware background re-trace of ``diff.edge``), so a lane whose only
hit was its excluded sphere is a miss.

``fused_hit`` launches ``csrc/fused_hit.cu`` for CUDA tensors and takes
``fused_hit_plain`` only for CPU tensors, or when asked for it with
``interpret=True`` (the counterpart of Pallas interpret mode). On a CUDA
tensor it launches the kernel or raises; it never falls back.

Outputs on a dead lane are the TPU kernel's dead-row defaults (the TPU gates
whole 128-lane rows, so it gives dead lanes of a live row real values; every
consumer masks them with ``alive``). A live lane that misses has t = BIG,
sphere 0's parameters and the geometry of t = 1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.intersect import packed_param_table
from ..core.scene import SphereScene
from ..runtime import cuda_build

# +inf stand-in, f32-exact, so that comparisons with it agree whether a
# Python float is compared in float32 or float64.
BIG = float(np.float32(3.0e38))
# trace_flat pads N to a multiple of this (the JAX kernel's tile), so shapes
# match the JAX package; the CUDA kernel itself takes any N.
TILE = 1024
PLAIN_SLICE = 65536   # rays per [slice, S] block of the plain version
GROUP_S = 32          # sweep slots per group of the kernel's group gate
GATE_PAD = 2.0 ** -8  # the group gate's padding per unit of |o|_1 + ext

FLOAT_NAMES = ("t", "px", "py", "pz", "nx", "ny", "nz", "ax", "ay", "az",
               "fuzz", "ior", "ex", "ey", "ez", "rw")
INT_NAMES = ("idx", "mat", "ff")
NAMES = ("t", "idx", "mat", "ff", "px", "py", "pz", "nx", "ny", "nz",
         "ax", "ay", "az", "fuzz", "ior", "ex", "ey", "ez", "rw")
# Dead-lane values (fused_hit.py:215-218 of the JAX package).
FLOAT_DEFAULTS = (BIG, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0,
                  0.0, 0.0, 0.0, 0.0)
INT_DEFAULTS = (0, 0, 0)


class FusedSpheres(NamedTuple):
    """Kernel-layout sphere data, built once per trace call, or once per
    forward render call, which hands it to every trace
    (``integrator_flat.build_tables``)."""

    spheres: torch.Tensor  # [S, 4] f32: cx cy cz |c|^2-r^2 (+BIG if inactive)
    params: torch.Tensor   # [S, 16] f32: packed_param_table rows
    boxes: torch.Tensor    # [ceil(S / GROUP_S), 8] f32: sweep_boxes


def prep_fused_spheres(scene: SphereScene) -> FusedSpheres:
    """Sweep rows, parameter table and group boxes (prep_fused_spheres in
    JAX, with the boxes of the kernel's group gate; the kernel takes any S,
    so the rows are not padded). The sweep rows and boxes are detached; the
    parameter table keeps the scene's autograd graph, for the re-derivation
    of the gradient path."""
    with torch.no_grad():
        c = scene.center
        c2r2 = (vm.length_squared(c) - scene.radius * scene.radius
                + torch.where(scene.active, 0.0, BIG))
        spheres = torch.cat([c, c2r2[:, None]], dim=1).contiguous()
        boxes = sweep_boxes(c, scene.radius, scene.active, c.shape[0],
                            GROUP_S)
    return FusedSpheres(spheres, packed_param_table(scene).contiguous(),
                        boxes)


def sweep_boxes(center, radius, active, slots: int, group: int
                ) -> torch.Tensor:
    """[ceil(slots / group), 8] f32: per group of `group` consecutive sweep
    slots, the AABB of its active spheres (c -+ |r|) and ext, the largest
    |c|_1 + |r| among them: rows (lo x, y, z, ext, hi x, y, z, 0); ext = -1
    for a group without an active sphere. The sweep sees only r^2, so a
    negative radius (a hollow sphere's inward normals) bounds the same
    sphere. Slots at and above the scene's sphere count (the sphere
    search's padding) belong to no box."""
    with torch.no_grad():
        g = -(-slots // group)
        pad = g * group - center.shape[0]
        rows = lambda x, v: torch.nn.functional.pad(x, (0, 0, 0, pad),
                                                    value=v)
        act = torch.nn.functional.pad(active, (0, pad), value=False)[:, None]
        r = radius.abs()[:, None]
        lo = torch.where(act, rows(center - r, 0.0), BIG).view(g, group, 3)
        hi = torch.where(act, rows(center + r, 0.0), -BIG).view(g, group, 3)
        ext = torch.where(act, rows(center.abs().sum(1, keepdim=True) + r,
                                    0.0), -1.0).view(g, group)
        ext = ext.amax(1, keepdim=True)
        empty = ext < 0
        lo = torch.where(empty, 0.0, lo.amin(1))
        hi = torch.where(empty, 0.0, hi.amax(1))
        return torch.cat([lo, ext, hi, torch.zeros_like(ext)],
                         dim=1).contiguous()


@torch.no_grad()
def fused_hit(tables: FusedSpheres, ox, oy, oz, dx, dy, dz, alive,
              t_min: float, *, interpret: bool = False,
              shadow_only: bool = False, exclude=None,
              mxu_extract: bool = True) -> dict:
    """Fused hit query on flat [N] f32 ray components and an [N] bool alive
    mask. Returns a dict of the 19 [N] outputs named in NAMES, or with
    shadow_only=True of ``t`` and ``idx`` alone; every output is detached
    (the gradient path re-derives what it differentiates). exclude: optional
    [N] integer tensor, the sphere id each lane leaves out of its sweep (-1
    for none).

    mxu_extract: how the TPU kernel reads the winner's 13 parameters, by a
    one-hot product against the table split into three bf16 pieces (True,
    its default; exact) or by a select over the f32 table (False). Both
    give the f32 row bit for bit, which the kernel here loads directly, so
    both values launch the same kernel and give the same outputs."""
    if not isinstance(mxu_extract, bool):
        raise ValueError(f"mxu_extract must be a bool, got {mxu_extract!r}")
    rays = (ox, oy, oz, dx, dy, dz)
    _check(tables, rays, alive)
    exclude = check_exclude(exclude, ox)
    if not cuda_build.use_kernel(ox.device, interpret, "fused_hit"):
        return fused_hit_plain(tables, *rays, alive, t_min,
                               shadow_only=shadow_only, exclude=exclude)
    if shadow_only:
        return _launch_shadow(tables, rays, alive, float(t_min), exclude)
    return _launch(tables, rays, alive, float(t_min), exclude)


def check_exclude(exclude, like: torch.Tensor):
    """The exclude operand as the kernels take it: None, or a contiguous [N]
    int32 tensor on the rays' device."""
    if exclude is None:
        return None
    if exclude.dtype.is_floating_point or exclude.dtype == torch.bool or \
            exclude.shape != like.shape or exclude.device != like.device:
        raise ValueError("exclude must be an [N] integer tensor on the rays' "
                         "device")
    return exclude.detach().to(torch.int32).contiguous()


def excl_ptr(exclude):
    """The operand's device pointer, None (a null pointer) without one."""
    return None if exclude is None else exclude.data_ptr()


def launch_counts(name: str, exclude) -> tuple:
    """The count names of a launch of kernel name: name, and name[exclude]
    with an exclude operand."""
    return (name,) if exclude is None else (name, f"{name}[exclude]")


def check_rays(rays, alive) -> None:
    """The ray operands the hit kernels share: rays, the [N] float32 per-ray
    operands (the six components, then t_cap where a kernel takes one),
    contiguous and on one device; alive, a contiguous [N] bool on their
    device, or None where the kernel reads none; 0 < N < 2^31."""
    n = rays[0].shape[0]
    dev = rays[0].device
    for x in rays:
        if x.dtype != torch.float32 or x.dim() != 1 or x.shape[0] != n:
            raise ValueError("ray components must be [N] float32 tensors of "
                             "one length")
        if x.device != dev or not x.is_contiguous():
            raise ValueError("ray components must be contiguous and on one "
                             "device")
    if alive is not None and (
            alive.dtype != torch.bool or alive.shape != (n,)
            or alive.device != dev or not alive.is_contiguous()):
        raise ValueError("alive must be a contiguous [N] bool tensor on the "
                         "rays' device")
    if n == 0 or n >= 2 ** 31:
        raise ValueError(f"the hit kernels take 0 < N < 2^31 rays, got {n}")


def _check(tables: FusedSpheres, rays, alive) -> None:
    check_rays(rays, alive)
    dev = rays[0].device
    s = tables.spheres.shape[0]
    for x, shape in ((tables.spheres, (s, 4)), (tables.params, (s, 16)),
                     (tables.boxes, (-(-s // GROUP_S), 8))):
        if (x.dtype != torch.float32 or x.shape != shape
                or not x.is_contiguous() or x.device != dev):
            raise ValueError("tables must come from prep_fused_spheres on the "
                             "rays' device")
    if s == 0:
        raise ValueError("fused_hit takes S > 0 spheres, got S=0")


def _launch(tables: FusedSpheres, rays, alive, t_min: float,
            exclude=None) -> dict:
    dev = rays[0].device
    n = rays[0].shape[0]
    fout = torch.empty((len(FLOAT_NAMES), n), dtype=torch.float32, device=dev)
    iout = torch.empty((len(INT_NAMES), n), dtype=torch.int32, device=dev)
    for x in (tables.spheres, tables.boxes, tables.params, fout, iout):
        if x.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    cuda_build.launch(
        "qtrt_fused_hit", *(x.data_ptr() for x in rays), alive.data_ptr(),
        excl_ptr(exclude), tables.spheres.data_ptr(), tables.boxes.data_ptr(),
        tables.params.data_ptr(), tables.spheres.shape[0], GROUP_S, t_min, n,
        fout.data_ptr(), iout.data_ptr(), device=dev,
        counted=launch_counts("fused_hit", exclude))
    return _as_dict(fout, iout)


def _launch_shadow(tables: FusedSpheres, rays, alive, t_min: float,
                   exclude=None) -> dict:
    dev = rays[0].device
    n = rays[0].shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    if tables.spheres.data_ptr() % 16 or tables.boxes.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    cuda_build.launch(
        "qtrt_fused_hit_shadow", *(x.data_ptr() for x in rays),
        alive.data_ptr(), excl_ptr(exclude), tables.spheres.data_ptr(),
        tables.boxes.data_ptr(), tables.spheres.shape[0], GROUP_S, t_min, n,
        t.data_ptr(), idx.data_ptr(), device=dev,
        counted=launch_counts("fused_hit_shadow", exclude))
    return {"t": t, "idx": idx}


def _as_dict(fout: torch.Tensor, iout: torch.Tensor) -> dict:
    out = dict(zip(FLOAT_NAMES, fout))
    out.update(zip(INT_NAMES, iout))
    return {k: out[k] for k in NAMES}


def fused_hit_plain(tables: FusedSpheres, ox, oy, oz, dx, dy, dz, alive,
                    t_min: float, slice_rays: int = PLAIN_SLICE,
                    shadow_only: bool = False, exclude=None) -> dict:
    """Plain PyTorch version of the kernel, in [slice_rays, S] blocks.

    Same formulas and association order as the kernel and as the TPU
    kernel: the expanded-form sweep, min-then-match for the lowest winning
    id, the oc-form refinement (full mode only). exclude ([N] i32 or None)
    masks each lane's excluded sphere out of the candidates before the min.
    """
    n = ox.shape[0]
    dev = ox.device
    ex = lambda sl: None if exclude is None else exclude[sl]
    if shadow_only:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        idx = torch.empty(n, dtype=torch.int32, device=dev)
        for lo in range(0, n, slice_rays):
            sl = slice(lo, min(n, lo + slice_rays))
            rays = (ox[sl], oy[sl], oz[sl], dx[sl], dy[sl], dz[sl])
            t_best, best, _ = _sweep(tables.spheres, *rays, float(t_min),
                                     ex(sl))
            t[sl] = torch.where(alive[sl], t_best, BIG)
            idx[sl] = torch.where(alive[sl], best, 0)
        return {"t": t, "idx": idx}
    fout = torch.empty((len(FLOAT_NAMES), n), dtype=torch.float32, device=dev)
    iout = torch.empty((len(INT_NAMES), n), dtype=torch.int32, device=dev)
    for lo in range(0, n, slice_rays):
        sl = slice(lo, min(n, lo + slice_rays))
        f, i = _plain_block(tables, ox[sl], oy[sl], oz[sl], dx[sl], dy[sl],
                            dz[sl], alive[sl], float(t_min), ex(sl))
        fout[:, sl] = f
        iout[:, sl] = i
    return _as_dict(fout, iout)


def sweep_candidates(spheres, ox, oy, oz, dx, dy, dz, t_min):
    """Per-(ray, slot) candidate roots of one block over the [S, 4] sweep
    rows, BIG where the slot gives no valid root: ([m, S] candidates,
    |d|^2 [m])."""
    c_x, c_y, c_z, c2 = spheres.unbind(1)                       # [S]
    o_x, o_y, o_z = ox[:, None], oy[:, None], oz[:, None]       # [m, 1]
    d_x, d_y, d_z = dx[:, None], dy[:, None], dz[:, None]

    # --- closest-hit sweep ---
    a = d_x * d_x + d_y * d_y + d_z * d_z
    o_dot_d = o_x * d_x + o_y * d_y + o_z * d_z
    o2 = o_x * o_x + o_y * o_y + o_z * o_z
    inv_a = torch.reciprocal(a)
    d_dot_c = c_x * d_x + c_y * d_y + c_z * d_z                 # [m, S]
    o_dot_c = c_x * o_x + c_y * o_y + c_z * o_z
    half_b = o_dot_d - d_dot_c
    cterm = o2 - 2.0 * o_dot_c + c2
    disc = half_b * half_b - a * cterm
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    near = (-half_b - sq) * inv_a
    far = (-half_b + sq) * inv_a
    near_ok = (near >= t_min) & (near <= BIG)
    far_ok = (far >= t_min) & (far <= BIG)
    root = torch.where(near_ok, near, far)
    valid = (disc >= 0.0) & (near_ok | far_ok)
    return torch.where(valid, root, BIG), a[:, 0]


def min_then_match(tcand):
    """(minimum [m], lowest slot id reaching it [m] i32) of [m, S]
    candidates; a lane with no hit matches every slot (all BIG), so it
    reads slot 0, as in JAX."""
    s = tcand.shape[1]
    t_best = tcand.amin(dim=1)
    rows = torch.arange(s, dtype=torch.int32, device=tcand.device)
    idx = torch.where(tcand == t_best[:, None], rows, s).amin(dim=1)
    return t_best, idx


def _sweep(spheres, ox, oy, oz, dx, dy, dz, t_min, exclude=None):
    """Closest-hit sweep of one block over the [S, 4] sweep rows: (t_best,
    lowest winning id, |d|^2). exclude: [m] i32 slot ids masked out of the
    candidates before the minimum (-1: none), or None."""
    tcand, a = sweep_candidates(spheres, ox, oy, oz, dx, dy, dz, t_min)
    if exclude is not None:
        rows = torch.arange(tcand.shape[1], dtype=torch.int32,
                            device=ox.device)
        tcand = torch.where(rows[None, :] != exclude[:, None], tcand, BIG)
    t_best, idx = min_then_match(tcand)
    return t_best, idx, a


def group_gate(box, ox, oy, oz, dx, dy, dz, t_min, t_best):
    """[m] bool: the kernel's group gate of rays [m] against one group box
    (its row of sweep_boxes) under their running minima t_best: the ray's
    segment [t_min, t_best] meets the box widened by GATE_PAD * (|o|_1 +
    ext); never for a group without an active sphere."""
    ext = box[3]
    o_l1 = (ox.abs() + oy.abs()) + oz.abs()
    pad = (o_l1 + ext) * GATE_PAD
    enter = torch.full_like(ox, t_min)
    exit_ = torch.full_like(ox, float("inf"))
    for a, (o, d) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        inv = torch.reciprocal(torch.where(
            torch.abs(d) < 1e-30, torch.where(d < 0, -1e-30, 1e-30), d))
        t0 = ((box[a] - pad) - o) * inv
        t1 = ((box[4 + a] + pad) - o) * inv
        enter = torch.maximum(enter, torch.minimum(t0, t1))
        exit_ = torch.minimum(exit_, torch.maximum(t0, t1))
    return (ext >= 0) & (exit_ >= enter) & (enter <= t_best)


def sweep_gated_plain(spheres, boxes, group: int, ox, oy, oz, dx, dy, dz,
                      t_min: float, exclude=None):
    """The kernel's gated sweep in plain PyTorch, group by group, with a
    count of its work: (t_best, lowest winning id, group visits [m] i32).
    A lane sweeps a group of `group` consecutive slots only when group_gate
    passes under its running minimum; within a group the minimum, then the
    lowest id reaching it, and a strict '<' update across groups. The gate
    is conservative, so (t_best, id) equal _sweep's. A measuring aid and the
    subject of the CPU tests; no path runs it."""
    s = spheres.shape[0]
    m = ox.shape[0]
    t_best = torch.full((m,), BIG, dtype=torch.float32, device=ox.device)
    best = torch.zeros(m, dtype=torch.int32, device=ox.device)
    visits = torch.zeros(m, dtype=torch.int32, device=ox.device)
    for gi, base in enumerate(range(0, s, group)):
        opened = group_gate(boxes[gi], ox, oy, oz, dx, dy, dz, t_min, t_best)
        visits += opened
        if not bool(opened.any()):
            continue
        end = min(s, base + group)
        tcand, _ = sweep_candidates(spheres[base:end], ox, oy, oz, dx, dy,
                                    dz, t_min)
        ids = torch.arange(base, end, dtype=torch.int32, device=ox.device)
        if exclude is not None:
            tcand = torch.where(ids[None, :] != exclude[:, None], tcand, BIG)
        t_g, i_g = min_then_match(tcand)
        better = opened & (t_g < t_best)
        t_best = torch.where(better, t_g, t_best)
        best = torch.where(better, i_g + base, best)
    return t_best, best, visits


def _plain_block(tables, ox, oy, oz, dx, dy, dz, alive, t_min, exclude=None):
    t_best, idx, a = _sweep(tables.spheres, ox, oy, oz, dx, dy, dz, t_min,
                            exclude)

    # --- winner parameters ---
    p = tables.params[idx.long()]                                # [m, 16]
    cw_x, cw_y, cw_z, r_w = p[:, 0], p[:, 1], p[:, 2], p[:, 3]

    # --- refinement: well-conditioned oc form, stable roots ---
    hit = t_best < BIG
    oc_x, oc_y, oc_z = ox - cw_x, oy - cw_y, oz - cw_z
    half_b1 = oc_x * dx + oc_y * dy + oc_z * dz
    c1 = oc_x * oc_x + oc_y * oc_y + oc_z * oc_z - r_w * r_w
    disc1 = half_b1 * half_b1 - a * c1
    pos = disc1 > 0.0
    sq1 = torch.where(pos, torch.sqrt(torch.where(pos, disc1, 1.0)), 0.0)
    sq_signed = torch.where(half_b1 >= 0.0, sq1, -sq1)
    q1 = -half_b1 - sq_signed
    q1_safe = torch.where(q1 == 0.0, 1.0, q1)
    root_a = q1 / a
    root_b = torch.where(q1 == 0.0, 0.0, c1 / q1_safe)
    near1 = torch.where(half_b1 >= 0.0, root_a, root_b)
    far1 = torch.where(half_b1 >= 0.0, root_b, root_a)
    near_ok1 = (near1 >= t_min) & (near1 <= BIG)
    t_fine = torch.where(near_ok1, near1, far1)
    fine_ok = (disc1 >= 0.0) & (near_ok1 | ((far1 >= t_min) & (far1 <= BIG)))
    t = torch.where(hit & fine_ok, t_fine, t_best)

    # --- geometry at the hit (miss lanes get benign finite values) ---
    t_safe = torch.where(hit, t, 1.0)
    p_x = ox + t_safe * dx
    p_y = oy + t_safe * dy
    p_z = oz + t_safe * dz
    r_safe = torch.where(r_w == 0.0, 1.0, r_w)
    ow_x = (p_x - cw_x) / r_safe
    ow_y = (p_y - cw_y) / r_safe
    ow_z = (p_z - cw_z) / r_safe
    ff = dx * ow_x + dy * ow_y + dz * ow_z < 0.0
    sgn = torch.where(ff, 1.0, -1.0)

    f = torch.stack([t, p_x, p_y, p_z, sgn * ow_x, sgn * ow_y, sgn * ow_z,
                     p[:, 4], p[:, 5], p[:, 6], p[:, 7], p[:, 8],
                     p[:, 10], p[:, 11], p[:, 12], r_w])
    i = torch.stack([idx, p[:, 9].to(torch.int32), ff.to(torch.int32)])
    f_def = torch.tensor(FLOAT_DEFAULTS, dtype=torch.float32, device=ox.device)
    i_def = torch.tensor(INT_DEFAULTS, dtype=torch.int32, device=ox.device)
    return (torch.where(alive, f, f_def[:, None]),
            torch.where(alive, i, i_def[:, None]))
