"""Fused closest-hit query: the CUDA kernel's wrapper and its plain version.

Counterpart of ``qt_raytracer_tpu.kernels.fused_hit`` (full mode). Per ray:
the closest sphere hit (the lowest sphere id wins a tie), the winner's 13
material parameters, t refined with the stable root, the hit point, the
front-face flag and the signed normal, as 19 flat [N] outputs.

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

FLOAT_NAMES = ("t", "px", "py", "pz", "nx", "ny", "nz", "ax", "ay", "az",
               "fuzz", "ior", "ex", "ey", "ez", "rw")
INT_NAMES = ("idx", "mat", "ff")
NAMES = ("t", "idx", "mat", "ff", "px", "py", "pz", "nx", "ny", "nz",
         "ax", "ay", "az", "fuzz", "ior", "ex", "ey", "ez", "rw")
# Dead-lane values (fused_hit.py:215-218 of the JAX package).
FLOAT_DEFAULTS = (BIG, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0,
                  0.0, 0.0, 0.0, 0.0)
INT_DEFAULTS = (0, 0, 0)

# Kernel launches by fused_hit; a run resets it to 0 and reads it back to
# show that its path went through the kernel.
launches = 0


class FusedSpheres(NamedTuple):
    """Kernel-layout sphere data, built once per trace."""

    spheres: torch.Tensor  # [S, 4] f32: cx cy cz |c|^2-r^2 (+BIG if inactive)
    params: torch.Tensor   # [S, 16] f32: packed_param_table rows


def prep_fused_spheres(scene: SphereScene) -> FusedSpheres:
    """Sweep rows and parameter table (prep_fused_spheres in JAX; the
    kernel takes any S, so the rows are not padded)."""
    c = scene.center
    c2r2 = (vm.length_squared(c) - scene.radius * scene.radius
            + torch.where(scene.active, 0.0, BIG))
    spheres = torch.cat([c, c2r2[:, None]], dim=1).contiguous()
    return FusedSpheres(spheres, packed_param_table(scene).contiguous())


def fused_hit(tables: FusedSpheres, ox, oy, oz, dx, dy, dz, alive,
              t_min: float, *, interpret: bool = False,
              shadow_only: bool = False, exclude=None) -> dict:
    """Fused hit query on flat [N] f32 ray components and an [N] bool alive
    mask. Returns a dict of the 19 [N] outputs named in NAMES."""
    if shadow_only:
        raise NotImplementedError(
            "shadow_only (kernel A2) is not ported yet: ROADMAP Queue A "
            "item 4")
    if exclude is not None:
        raise NotImplementedError(
            "the per-lane exclude operand is not ported yet: ROADMAP Queue A "
            "item 8")
    rays = (ox, oy, oz, dx, dy, dz)
    _check(tables, rays, alive)
    dev = ox.device
    if interpret or dev.type == "cpu":
        return fused_hit_plain(tables, *rays, alive, t_min)
    if dev.type != "cuda":
        raise ValueError(f"fused_hit runs on cpu or cuda tensors, got {dev}")
    return _launch(tables, rays, alive, float(t_min))


def _check(tables: FusedSpheres, rays, alive) -> None:
    n = rays[0].shape[0]
    dev = rays[0].device
    for x in rays:
        if x.dtype != torch.float32 or x.dim() != 1 or x.shape[0] != n:
            raise ValueError("ray components must be [N] float32 tensors of "
                             "one length")
        if x.device != dev or not x.is_contiguous():
            raise ValueError("ray components must be contiguous and on one "
                             "device")
    if alive.dtype != torch.bool or alive.shape != (n,) or alive.device != dev:
        raise ValueError("alive must be an [N] bool tensor on the rays' device")
    if not alive.is_contiguous():
        raise ValueError("alive must be contiguous")
    s = tables.spheres.shape[0]
    for x, w in ((tables.spheres, 4), (tables.params, 16)):
        if (x.dtype != torch.float32 or x.shape != (s, w)
                or not x.is_contiguous() or x.device != dev):
            raise ValueError("tables must come from prep_fused_spheres on the "
                             "rays' device")
    if n == 0 or n >= 2 ** 31 or s == 0:
        raise ValueError(f"fused_hit takes 0 < N < 2^31 rays and S > 0 "
                         f"spheres, got N={n}, S={s}")


def _launch(tables: FusedSpheres, rays, alive, t_min: float) -> dict:
    global launches
    lib = cuda_build.load_library()
    dev = rays[0].device
    n = rays[0].shape[0]
    fout = torch.empty((len(FLOAT_NAMES), n), dtype=torch.float32, device=dev)
    iout = torch.empty((len(INT_NAMES), n), dtype=torch.int32, device=dev)
    for x in (tables.spheres, tables.params, fout, iout):
        if x.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qtrt_fused_hit(
            *(x.data_ptr() for x in rays), alive.data_ptr(),
            tables.spheres.data_ptr(), tables.params.data_ptr(),
            tables.spheres.shape[0], t_min, n,
            fout.data_ptr(), iout.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_hit kernel launch failed: cudaError_t {err}")
    launches += 1
    return _as_dict(fout, iout)


def _as_dict(fout: torch.Tensor, iout: torch.Tensor) -> dict:
    out = dict(zip(FLOAT_NAMES, fout))
    out.update(zip(INT_NAMES, iout))
    return {k: out[k] for k in NAMES}


def fused_hit_plain(tables: FusedSpheres, ox, oy, oz, dx, dy, dz, alive,
                    t_min: float, slice_rays: int = PLAIN_SLICE) -> dict:
    """Plain PyTorch version of the kernel, in [slice_rays, S] blocks.

    Same formulas and association order as the kernel and as the TPU
    kernel: the expanded-form sweep, min-then-match for the lowest winning
    id, the oc-form refinement.
    """
    n = ox.shape[0]
    dev = ox.device
    fout = torch.empty((len(FLOAT_NAMES), n), dtype=torch.float32, device=dev)
    iout = torch.empty((len(INT_NAMES), n), dtype=torch.int32, device=dev)
    for lo in range(0, n, slice_rays):
        sl = slice(lo, min(n, lo + slice_rays))
        f, i = _plain_block(tables, ox[sl], oy[sl], oz[sl], dx[sl], dy[sl],
                            dz[sl], alive[sl], float(t_min))
        fout[:, sl] = f
        iout[:, sl] = i
    return _as_dict(fout, iout)


def _plain_block(tables, ox, oy, oz, dx, dy, dz, alive, t_min):
    c_x, c_y, c_z, c2 = tables.spheres.unbind(1)                # [S]
    s = c_x.shape[0]
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
    tcand = torch.where(valid, root, BIG)
    t_best = tcand.amin(dim=1)                                   # [m]
    rows = torch.arange(s, dtype=torch.int32, device=ox.device)
    # Lowest matching id; a lane with no hit matches every row (all BIG), so
    # it reads sphere 0, as in JAX.
    idx = torch.where(tcand == t_best[:, None], rows, s).amin(dim=1)

    # --- winner parameters ---
    p = tables.params[idx.long()]                                # [m, 16]
    cw_x, cw_y, cw_z, r_w = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    a = a[:, 0]

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
