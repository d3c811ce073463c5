"""Flat-SoA wavefront integrator, forward only (counterpart of
``qt_raytracer_tpu.core.integrator_flat.trace_flat`` with diff=False,
nee=False, compact=False).

The ray state is carried as flat [N] component tensors, and each bounce makes
one ``fused_hit`` call that returns the closest hit, its refined t, hit
point, normal and the winner's material parameters. The estimator, the
uniform slots and the tie-breaks are the JAX package's, line by line.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sampling
from .scene import DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL, SphereScene
from .vecmath import safe_sqrt
from ..kernels.fused_hit import (BIG, TILE, FusedSpheres, fused_hit,
                                 prep_fused_spheres)

TWO_PI = 6.283185307179586


def _safe_rsqrt_len2(x, y, z):
    """(n2, inv_len), with inv_len = 0 where n2 <= 1e-20."""
    n2 = x * x + y * y + z * z
    ok = n2 > 1.0e-20
    inv = torch.where(ok, torch.reciprocal(torch.sqrt(torch.where(ok, n2, 1.0))),
                      0.0)
    return n2, inv


def _cbrt(x):
    """Cube root of x >= 0 (torch has no cbrt; within 1 ulp of jnp.cbrt)."""
    return torch.pow(x, 1.0 / 3.0)


def _sky(dx, dy, dz):
    """sky_color (RayTracer.h:593-595) on flat components."""
    _, inv = _safe_rsqrt_len2(dx, dy, dz)
    t = 0.5 * (dy * inv + 1.0)
    return (1.0 - t) * 1.0 + t * 0.5, (1.0 - t) * 1.0 + t * 0.7, \
        (1.0 - t) * 1.0 + t * 1.0


def _scatter_flat(mat, ax, ay, az, fuzz, ior, ex, ey, ez,
                  dx, dy, dz, nx, ny, nz, ff, uni):
    """materials.scatter on flat components (identical formulas/slots)."""
    u0, u1, u2, u3 = uni[:, 0], uni[:, 1], uni[:, 2], uni[:, 3]
    _, inv = _safe_rsqrt_len2(dx, dy, dz)
    ux, uy, uz = dx * inv, dy * inv, dz * inv

    # Lambertian: normal + random_unit_vector, degenerate guard.
    zc = 1.0 - 2.0 * u0
    rr = torch.sqrt(torch.clamp_min(1.0 - zc * zc, 1.0e-20))
    phi = TWO_PI * u1
    rux, ruy, ruz = rr * torch.cos(phi), rr * torch.sin(phi), zc
    lx, ly, lz = nx + rux, ny + ruy, nz + ruz
    degen = lx * lx + ly * ly + lz * lz < 1.0e-8
    lx = torch.where(degen, nx, lx)
    ly = torch.where(degen, ny, ly)
    lz = torch.where(degen, nz, lz)

    # Metal: mirror + fuzz * in_unit_sphere; absorb below horizon.
    din = ux * nx + uy * ny + uz * nz
    rfx = ux - 2.0 * din * nx
    rfy = uy - 2.0 * din * ny
    rfz = uz - 2.0 * din * nz
    cb = _cbrt(u2)
    mx = rfx + fuzz * (rux * cb)
    my = rfy + fuzz * (ruy * cb)
    mz = rfz + fuzz * (ruz * cb)
    met_ok = mx * nx + my * ny + mz * nz > 0.0

    # Dielectric: Schlick vs uniform, TIR, white attenuation.
    ratio = torch.where(ff, torch.reciprocal(ior), ior)
    cos_t = torch.clamp_max((-ux) * nx + (-uy) * ny + (-uz) * nz, 1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    om = 1.0 - cos_t
    om2 = om * om
    om5 = om * (om2 * om2)     # lax.integer_pow(om, 5)'s chain of multiplies
    refl = r0 + (1.0 - r0) * om5
    must_reflect = cannot | (refl > u3)
    rpx = ratio * (ux + cos_t * nx)
    rpy = ratio * (uy + cos_t * ny)
    rpz = ratio * (uz + cos_t * nz)
    par = -safe_sqrt(torch.abs(1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)))
    ddx = torch.where(must_reflect, rfx, rpx + par * nx)
    ddy = torch.where(must_reflect, rfy, rpy + par * ny)
    ddz = torch.where(must_reflect, rfz, rpz + par * nz)

    is_lam = mat == LAMBERTIAN
    is_met = mat == METAL
    is_die = mat == DIELECTRIC
    is_emit = mat == EMISSIVE
    sdx = torch.where(is_lam, lx, torch.where(is_met, mx, ddx))
    sdy = torch.where(is_lam, ly, torch.where(is_met, my, ddy))
    sdz = torch.where(is_lam, lz, torch.where(is_met, mz, ddz))
    white = is_die | is_emit
    atx = torch.where(white, 1.0, ax)
    aty = torch.where(white, 1.0, ay)
    atz = torch.where(white, 1.0, az)
    ok = torch.where(is_met, met_ok, ~is_emit)
    emx = torch.where(is_emit, ex, 0.0)
    emy = torch.where(is_emit, ey, 0.0)
    emz = torch.where(is_emit, ez, 0.0)
    return (sdx, sdy, sdz, atx, aty, atz, ok, emx, emy, emz, is_lam)


class RayState(NamedTuple):
    """Per-ray carry of the bounce loop, flat [N_pad] tensors."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    tx: torch.Tensor   # throughput
    ty: torch.Tensor
    tz: torch.Tensor
    rx: torch.Tensor   # radiance so far
    ry: torch.Tensor
    rz: torch.Tensor
    alive: torch.Tensor  # bool
    keys: torch.Tensor   # per-ray hash states (uint32 values in int64)


def initial_state(origins: torch.Tensor, directions: torch.Tensor,
                  sample_keys: torch.Tensor) -> RayState:
    """Split [N,3] rays into flat components, padded with dead rays to a
    multiple of TILE (directions (0, 0, 1)), as the JAX package pads."""
    n = origins.shape[0]
    n_pad = (-n) % TILE
    padf = lambda x, v=0.0: torch.nn.functional.pad(x, (0, n_pad), value=v)
    ox, oy, oz = (padf(origins[:, k]) for k in range(3))
    dx, dy, dz = padf(directions[:, 0]), padf(directions[:, 1]), \
        padf(directions[:, 2], 1.0)
    keys = torch.nn.functional.pad(sample_keys, (0, n_pad))
    alive = padf(origins[:, 0] * 0.0 + 1.0) > 0.5
    zero = torch.zeros_like(ox)
    one = torch.ones_like(ox)
    return RayState(ox, oy, oz, dx, dy, dz, one, one, one, zero, zero, zero,
                    alive, keys)


def bounce(tables: FusedSpheres, s: RayState, depth_idx: int, t_min: float,
           rr_start: int = 0, interpret: bool = False) -> RayState:
    """One bounce of every ray: hit, scatter, accumulate, continue."""
    h = fused_hit(tables, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.alive,
                  t_min, interpret=interpret)
    hit = h["t"] < BIG
    ff = h["ff"] > 0

    uni = sampling.stream_uniforms(s.keys, sampling.STREAM_BOUNCE0 + depth_idx,
                                   sampling.UNIFORMS_PER_BOUNCE)
    (sdx, sdy, sdz, atx, aty, atz, ok, emx, emy, emz, _) = _scatter_flat(
        h["mat"], h["ax"], h["ay"], h["az"], h["fuzz"], h["ior"],
        h["ex"], h["ey"], h["ez"], s.dx, s.dy, s.dz,
        h["nx"], h["ny"], h["nz"], ff, uni)

    miss = s.alive & ~hit
    emit_hit = s.alive & hit
    skx, sky_, skz = _sky(s.dx, s.dy, s.dz)
    rx = s.rx + torch.where(miss, s.tx * skx, 0.0)
    ry = s.ry + torch.where(miss, s.ty * sky_, 0.0)
    rz = s.rz + torch.where(miss, s.tz * skz, 0.0)
    rx = rx + torch.where(emit_hit, s.tx * emx, 0.0)
    ry = ry + torch.where(emit_hit, s.ty * emy, 0.0)
    rz = rz + torch.where(emit_hit, s.tz * emz, 0.0)

    continues = s.alive & hit & ok
    tx = torch.where(continues, s.tx * atx, s.tx)
    ty = torch.where(continues, s.ty * aty, s.ty)
    tz = torch.where(continues, s.tz * atz, s.tz)
    if rr_start > 0 and depth_idx >= rr_start:
        # Russian roulette (unbiased: survivors are reweighted).
        p_cont = torch.clamp(torch.maximum(torch.maximum(tx, ty), tz),
                             0.05, 1.0)
        survive = uni[:, 7] < p_cont
        adj = continues & survive
        tx = torch.where(adj, tx / p_cont, tx)
        ty = torch.where(adj, ty / p_cont, ty)
        tz = torch.where(adj, tz / p_cont, tz)
        continues = adj
    return RayState(
        torch.where(continues, h["px"], s.ox),
        torch.where(continues, h["py"], s.oy),
        torch.where(continues, h["pz"], s.oz),
        torch.where(continues, sdx, s.dx),
        torch.where(continues, sdy, s.dy),
        torch.where(continues, sdz, s.dz),
        tx, ty, tz, rx, ry, rz, continues, s.keys)


@torch.no_grad()
def trace_flat(
    scene: SphereScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    sample_keys: torch.Tensor,
    max_depth: int,
    t_min: float = 1.0e-3,
    nee: bool = False,
    rr_start: int = 0,
    interpret: bool = False,
) -> torch.Tensor:
    """Radiance [N,3] of rays origins/directions [N,3] with per-ray hash
    states sample_keys [N], traced for max_depth bounces on the scene's
    device. Forward only: raises if any scene or ray tensor requires grad."""
    if not isinstance(scene, SphereScene):
        raise TypeError("trace_flat handles SphereScene only")
    if nee:
        raise NotImplementedError(
            "nee=True is not ported yet: ROADMAP Queue A item 4 (kernel A2)")
    tensors = [getattr(scene, f) for f in scene.__dataclass_fields__]
    if any(t.requires_grad for t in (*tensors, origins, directions)):
        raise ValueError(
            "trace_flat is forward-only: the fused kernel detaches every hit "
            "quantity, so gradients would be silently zero (the gradient "
            "integrator is ROADMAP Queue A item 7)")
    tables = prep_fused_spheres(scene)
    state = initial_state(origins, directions, sample_keys)
    for depth_idx in range(max_depth):
        state = bounce(tables, state, depth_idx, float(t_min), int(rr_start),
                       interpret)
    n = origins.shape[0]
    return torch.stack([state.rx, state.ry, state.rz], dim=-1)[:n]
