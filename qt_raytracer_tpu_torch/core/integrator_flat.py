"""Flat-SoA wavefront integrator (counterpart of
``qt_raytracer_tpu.core.integrator_flat``: ``trace_flat`` and
``trace_flat_world``).

The ray state is carried as flat [N] component tensors. For sphere scenes
each bounce makes one ``fused_hit`` call (kernel A1) that returns the
closest hit, its refined t, hit point, normal and the winner's material
parameters. Mesh worlds add the mesh search capped by the sphere hit, merged
into one id space: the clustered search (kernels A3 and A4) or, by
``mesh_kernel``, the pair-wavefront search (A7 and A8), which give live
lanes the same bits. ``compact=True`` sorts the carry before every bounce so
that live rays form a dense prefix, and puts the radiance back in ray order
at the end; the image does not change by a bit. Next-event estimation
casts one shadow ray per diffuse hit through the shadow-mode sphere sweep
(kernel A2) and, in a world, the mesh search, and weighs it against the
BSDF sample by the balance heuristic. The estimator, the uniform slots and
the tie-breaks are the JAX package's, line by line. Without NEE, on the
card, with hash states and no autograd recording, the shading after each
hit query is one launch of the shading kernel (``kernels/fused_shade.py``),
which gives the bits of its PyTorch route, ``_shade_plain``.

``trace_flat(diff=True)`` is the gradient-capable sphere path: the
shadow-mode kernel (A2) only selects the winner, and ``_rederive_hits_flat``
re-derives t, the hit point, the normal and the material parameters from
the scene tensors, so autograd reaches them. The other paths are forward
only: a render of tensors that require grad runs, and its backward raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sampling
from ..runtime import spans
from .scene import DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL, SphereScene
from .vecmath import gather_rows, safe_sqrt
from .config import MESH_KERNELS
from .world import (World, WorldLights, face_param_table, search_mesh,
                    tensors_of, world_lights)
from ..kernels import fused_shade
from ..kernels.fused_hit import (BIG, TILE, FusedSpheres, fused_hit,
                                 prep_fused_spheres)
from ..kernels.mesh_intersect import (CLUSTER_ROWS, MeshClusters,
                                      prep_mesh_clusters)

TWO_PI = 6.283185307179586
INV_PI = 0.3183098861837907


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


def _sphere_pdf_flat(lcx, lcy, lcz, lr, px, py, pz):
    """Solid-angle cone pdf of a sphere light seen from p, on flat
    components (integrator._sphere_solid_angle_pdf)."""
    tox, toy, toz = lcx - px, lcy - py, lcz - pz
    dist2 = tox * tox + toy * toy + toz * toz
    outside = dist2 > lr * lr * 1.0001
    sin2 = torch.clamp(lr * lr / torch.clamp_min(dist2, 1e-12), 0.0, 1.0)
    cos_max = safe_sqrt(1.0 - sin2)
    omc = sin2 / (1.0 + cos_max)
    ok = outside & (omc > 1e-12)
    den = torch.where(ok, torch.clamp_min(TWO_PI * omc, 1e-30), 1.0)
    pdf = torch.where(ok, torch.reciprocal(den), 0.0)
    return pdf, ok, cos_max, (tox, toy, toz)


def _cone_sample(lcx, lcy, lcz, lr, px, py, pz, u5, u6):
    """Direction toward a sphere light, uniform in its cone, with the
    branchless ONB of Duff et al. 2017 (integrator._onb). Returns
    (ldx, ldy, ldz, pdf, ok)."""
    pdf, ok, cos_max, (tox, toy, toz) = _sphere_pdf_flat(
        lcx, lcy, lcz, lr, px, py, pz)
    _, winv = _safe_rsqrt_len2(tox, toy, toz)
    wx, wy, wz = tox * winv, toy * winv, toz * winv
    cos_s = 1.0 - u5 * (1.0 - cos_max)
    sin_s = safe_sqrt(1.0 - cos_s * cos_s)
    phi = TWO_PI * u6
    sign = torch.where(wz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + wz)
    b = wx * wy * a
    t1x, t1y, t1z = 1.0 + sign * wx * wx * a, sign * b, -sign * wx
    t2x, t2y, t2z = b, sign + wy * wy * a, -wy
    sc, ss = sin_s * torch.cos(phi), sin_s * torch.sin(phi)
    ldx = sc * t1x + ss * t2x + cos_s * wx
    ldy = sc * t1y + ss * t2y + cos_s * wy
    ldz = sc * t1z + ss * t2z + cos_s * wz
    return ldx, ldy, ldz, pdf, ok


def _mis_contrib(cand, lit, pdf_j, n_lights, cos_surf, tx, ty, tz,
                 ax, ay, az, lex, ley, lez):
    """One-sample MIS, balance heuristic: 1/pdf_nee and the weight combine
    into one denominator (integrator._nee_mis)."""
    pdf_nee = pdf_j / n_lights
    denom = pdf_nee + cos_surf * INV_PI
    den_f = torch.where(cand, torch.clamp_min(denom, 1e-30), 1.0)
    factor = torch.where(cand, cos_surf * INV_PI / den_f, 0.0)
    cx = tx * ax * factor * lex
    cy = ty * ay * factor * ley
    cz = tz * az * factor * lez
    return (torch.where(lit, cx, 0.0), torch.where(lit, cy, 0.0),
            torch.where(lit, cz, 0.0))


def _nee_flat(tables: FusedSpheres, light_idx, px, py, pz, nx, ny, nz,
              ax, ay, az, tx, ty, tz, diffuse, uni, t_min, interpret):
    """_nee_mis on flat components (sphere lights; same estimator and
    slots). The shadow ray counts when its closest hit is the light."""
    u4, u5, u6 = uni[:, 4], uni[:, 5], uni[:, 6]
    n_lights = light_idx.shape[0]
    pick = torch.clamp((u4 * n_lights).to(torch.int32), 0, n_lights - 1)
    light = light_idx[pick.long()]
    lp = gather_rows(tables.params, light)
    lcx, lcy, lcz, lr = lp[:, 0], lp[:, 1], lp[:, 2], lp[:, 3]
    ldx, ldy, ldz, pdf_j, ok = _cone_sample(lcx, lcy, lcz, lr, px, py, pz,
                                            u5, u6)
    cos_surf = nx * ldx + ny * ldy + nz * ldz
    cand = diffuse & ok & (cos_surf > 0.0)

    sh = fused_hit(tables, px, py, pz, ldx, ldy, ldz, cand, t_min,
                   shadow_only=True, interpret=interpret)
    lit = cand & (sh["t"] < BIG) & (sh["idx"] == light)
    return _mis_contrib(cand, lit, pdf_j, n_lights, cos_surf, tx, ty, tz,
                        ax, ay, az, lp[:, 10], lp[:, 11], lp[:, 12])


def _emit_weight_flat(h, ox, oy, oz, prev_pdf, n_lights):
    """Balance-heuristic weight of a BSDF-sampled emitter hit
    (integrator._emitter_mis_weight, sphere lights only)."""
    sgn = torch.where(h["ff"] > 0, 1.0, -1.0)
    lcx = h["px"] - h["rw"] * sgn * h["nx"]
    lcy = h["py"] - h["rw"] * sgn * h["ny"]
    lcz = h["pz"] - h["rw"] * sgn * h["nz"]
    pdf_sph, _, _, _ = _sphere_pdf_flat(lcx, lcy, lcz, h["rw"], ox, oy, oz)
    pdf_nee = pdf_sph / n_lights
    use = prev_pdf > 0.0
    denom = torch.where(use, prev_pdf + pdf_nee, 1.0)
    return torch.where(use, prev_pdf / denom, 1.0)


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
    alive: torch.Tensor     # bool
    prev_pdf: torch.Tensor  # pdf of the BSDF sample that made the ray
    keys: torch.Tensor      # per-ray hash states (uint32 values in int64)
    pid: torch.Tensor       # i64: the ray's lane at the start (compact mode)


def initial_state(origins: torch.Tensor, directions: torch.Tensor,
                  sample_keys: torch.Tensor) -> RayState:
    """Split [N,3] rays into flat components, padded with dead rays to a
    multiple of TILE (directions (0, 0, 1)), as the JAX package pads.
    prev_pdf starts at -1: full weight for an emitter hit."""
    n = origins.shape[0]
    n_pad = (-n) % TILE
    padf = lambda x, v=0.0: torch.nn.functional.pad(x, (0, n_pad), value=v)
    ox, oy, oz = (padf(origins[:, k]) for k in range(3))
    dx, dy, dz = padf(directions[:, 0]), padf(directions[:, 1]), \
        padf(directions[:, 2], 1.0)
    keys = torch.cat([sample_keys, sample_keys.new_zeros(
        (n_pad, *sample_keys.shape[1:]))])   # [N] hash or [N,2] threefry
    alive = padf(origins[:, 0] * 0.0 + 1.0) > 0.5
    zero = torch.zeros_like(ox)
    one = torch.ones_like(ox)
    pid = torch.arange(ox.shape[0], device=ox.device)
    return RayState(ox, oy, oz, dx, dy, dz, one, one, one, zero, zero, zero,
                    alive, zero - 1.0, keys, pid)


def compact_state(s: RayState) -> RayState:
    """The carry under a stable sort that puts live rays first: whole
    128-lane kernel blocks go dead and are skipped. Every per-ray quantity
    rides the permutation (the keys drive the RNG, pid restores the order at
    the end), so no ray's values change."""
    order = torch.sort((~s.alive).to(torch.int8), stable=True).indices
    return RayState(*(x[order] for x in s))


def radiance_in_ray_order(s: RayState, n: int, compact: bool) -> torch.Tensor:
    """[n, 3] radiance of the first n rays; after compact bounces lane i
    holds ray pid[i]'s, and it is scattered back (padding lanes are cut)."""
    rad = torch.stack([s.rx, s.ry, s.rz], dim=-1)
    if compact:
        rad = torch.zeros_like(rad).index_copy(0, s.pid, rad)
    return rad[:n]


@spans.spanned(spans.SHADE)
def _shade(s: RayState, h: dict, depth_idx: int, rr_start: int, emit_w,
           nee_fn, interpret: bool = False) -> RayState:
    """The bounce after the hit query, shared by spheres and worlds:
    scatter, sky and emission, NEE (nee_fn, or None), Russian roulette,
    the continuing ray and its prev_pdf. One launch of the shading kernel
    where ``fused_shade.use_kernel`` allows it (CUDA tensors, not
    interpret, hash states, no NEE, no autograd recording); else the
    PyTorch route, ``_shade_plain``. Both give the same bits."""
    if fused_shade.use_kernel(s.ox.device, interpret, s.keys,
                              nee_fn is not None, (*s, *h.values())):
        return RayState(*fused_shade.fused_shade(s, h, depth_idx, rr_start,
                                                 emit_w),
                        s.prev_pdf, s.keys, s.pid)
    return _shade_plain(s, h, depth_idx, rr_start, emit_w, nee_fn)


def _shade_plain(s: RayState, h: dict, depth_idx: int, rr_start: int,
                 emit_w, nee_fn) -> RayState:
    """_shade in PyTorch ops: the shading kernel's plain version, and the
    route of NEE, threefry keys, autograd, interpret and CPU tensors."""
    hit = h["t"] < BIG
    ff = h["ff"] > 0

    uni = sampling.stream_uniforms(s.keys, sampling.STREAM_BOUNCE0 + depth_idx,
                                   sampling.UNIFORMS_PER_BOUNCE)
    (sdx, sdy, sdz, atx, aty, atz, ok, emx, emy, emz, is_lam) = _scatter_flat(
        h["mat"], h["ax"], h["ay"], h["az"], h["fuzz"], h["ior"],
        h["ex"], h["ey"], h["ez"], s.dx, s.dy, s.dz,
        h["nx"], h["ny"], h["nz"], ff, uni)

    miss = s.alive & ~hit
    emit_hit = s.alive & hit
    skx, sky_, skz = _sky(s.dx, s.dy, s.dz)
    rx = s.rx + torch.where(miss, s.tx * skx, 0.0)
    ry = s.ry + torch.where(miss, s.ty * sky_, 0.0)
    rz = s.rz + torch.where(miss, s.tz * skz, 0.0)
    rx = rx + torch.where(emit_hit, s.tx * emx * emit_w, 0.0)
    ry = ry + torch.where(emit_hit, s.ty * emy * emit_w, 0.0)
    rz = rz + torch.where(emit_hit, s.tz * emz * emit_w, 0.0)

    diffuse = s.alive & hit & is_lam
    if nee_fn is not None:
        nx_, ny_, nz_ = nee_fn(diffuse, uni)
        rx, ry, rz = rx + nx_, ry + ny_, rz + nz_

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
    prev_pdf = s.prev_pdf
    if nee_fn is not None:
        # pdf of the bounce that made the continuing ray: cosine/pi for a
        # diffuse bounce, -1 (full emitter weight) for a specular one.
        _, sinv = _safe_rsqrt_len2(sdx, sdy, sdz)
        cos_next = (h["nx"] * sdx + h["ny"] * sdy + h["nz"] * sdz) * sinv
        pdf_next = torch.where(diffuse & continues,
                               torch.clamp_min(cos_next, 0.0) * INV_PI, -1.0)
        prev_pdf = torch.where(continues, pdf_next, prev_pdf)
    return RayState(
        torch.where(continues, h["px"], s.ox),
        torch.where(continues, h["py"], s.oy),
        torch.where(continues, h["pz"], s.oz),
        torch.where(continues, sdx, s.dx),
        torch.where(continues, sdy, s.dy),
        torch.where(continues, sdz, s.dz),
        tx, ty, tz, rx, ry, rz, continues, prev_pdf, s.keys, s.pid)


def _rederive_hits_flat(params, ox, oy, oz, dx, dy, dz, t_sel, idx, t_min):
    """Differentiable re-derivation of the selected winners on flat
    components: intersect_spheres' refinement (Citardauq roots, the same
    guards) on the winners' rows of packed_param_table, params [S,16].
    Selection (idx, hit) is detached; the values are differentiable
    functions of the scene tensors. Returns fused_hit's full-mode dict."""
    p = gather_rows(params, idx)                             # [N,16]
    cxs, cys, czs, r = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    ocx, ocy, ocz = ox - cxs, oy - cys, oz - czs
    a1 = dx * dx + dy * dy + dz * dz
    half_b = ocx * dx + ocy * dy + ocz * dz
    c1 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = half_b * half_b - a1 * c1
    sqrtd = safe_sqrt(disc)
    sq_signed = torch.where(half_b >= 0.0, sqrtd, -sqrtd)
    q1 = -half_b - sq_signed
    q1_safe = torch.where(q1 == 0.0, 1.0, q1)
    root_a = q1 / a1
    root_b = torch.where(q1 == 0.0, 0.0, c1 / q1_safe)
    near = torch.where(half_b >= 0.0, root_a, root_b)
    far = torch.where(half_b >= 0.0, root_b, root_a)
    near_ok = near >= t_min
    t_fine = torch.where(near_ok, near, far)
    fine_ok = (disc >= 0.0) & (near_ok | (far >= t_min))

    hit = t_sel < BIG                                      # detached decision
    t = torch.where(hit & fine_ok, t_fine, t_sel)
    t_safe = torch.where(hit, t, 1.0)
    px, py, pz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
    r_safe = torch.where(r == 0.0, 1.0, r)
    owx, owy, owz = (px - cxs) / r_safe, (py - cys) / r_safe, \
        (pz - czs) / r_safe
    ff = dx * owx + dy * owy + dz * owz < 0.0
    sgn = torch.where(ff, 1.0, -1.0)
    return {
        "t": t, "idx": idx, "mat": p[:, 9].to(torch.int32),
        "ff": ff.to(torch.int32), "px": px, "py": py, "pz": pz,
        "nx": sgn * owx, "ny": sgn * owy, "nz": sgn * owz,
        "ax": p[:, 4], "ay": p[:, 5], "az": p[:, 6],
        "fuzz": p[:, 7], "ior": p[:, 8],
        "ex": p[:, 10], "ey": p[:, 11], "ez": p[:, 12], "rw": r,
    }


def bounce(tables: FusedSpheres, s: RayState, depth_idx: int, t_min: float,
           rr_start: int = 0, interpret: bool = False,
           light_idx: torch.Tensor | None = None,
           diff: bool = False, exclude=None) -> RayState:
    """One bounce of every ray in a sphere scene: hit, scatter, accumulate,
    continue. light_idx (the scene's emissive sphere ids) turns NEE on.
    diff=True selects with the shadow-mode kernel and re-derives the hit
    differentiably from tables.params. exclude: optional [N_pad] i32 sphere
    id left out of this bounce's hit query (-1 for none); the NEE shadow
    rays see the whole scene."""
    if diff:
        sel = fused_hit(tables, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.alive,
                        t_min, shadow_only=True, interpret=interpret,
                        exclude=exclude)
        h = _rederive_hits_flat(tables.params, s.ox, s.oy, s.oz, s.dx, s.dy,
                                s.dz, sel["t"], sel["idx"], t_min)
    else:
        h = fused_hit(tables, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.alive,
                      t_min, interpret=interpret, exclude=exclude)
    emit_w, nee_fn = 1.0, None
    if light_idx is not None:
        n_lights = light_idx.shape[0]
        emit_w = _emit_weight_flat(h, s.ox, s.oy, s.oz, s.prev_pdf, n_lights)
        nee_fn = lambda diffuse, uni: _nee_flat(
            tables, light_idx, h["px"], h["py"], h["pz"], h["nx"], h["ny"],
            h["nz"], h["ax"], h["ay"], h["az"], s.tx, s.ty, s.tz, diffuse,
            uni, t_min, interpret)
    return _shade(s, h, depth_idx, rr_start, emit_w, nee_fn, interpret)


class _ForwardOnly(torch.autograd.Function):
    """A forward-only trace inside autograd: the render of tensors that
    require grad runs (with every hit quantity detached by the kernels), and
    differentiating it raises instead of returning silently zero
    gradients."""

    @staticmethod
    def forward(ctx, what, run, *inputs):
        ctx.what = what
        return run()

    @staticmethod
    def backward(ctx, grad):
        raise ValueError(
            f"{ctx.what} is forward-only: its kernels detach every hit "
            "quantity, so gradients would be silently zero. Render gradients "
            "with grad_capable_config(cfg) (intersector 'fused_diff', or "
            "'pallas' for mesh worlds); diff.inverse.make_train_step does "
            "this itself.")


def _forward_only(what: str, run, scene, *tensors) -> torch.Tensor:
    """run() under no_grad, or through _ForwardOnly when a tensor of the
    scene or World, or one of tensors, requires grad."""
    inputs = [t for t in (*tensors, *tensors_of(scene)) if t.requires_grad]
    if torch.is_grad_enabled() and inputs:
        return _ForwardOnly.apply(what, run, *inputs)
    with torch.no_grad():
        return run()


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
    diff: bool = False,
    compact: bool = False,
    exclude_prim0=None,
    tables: FusedSpheres | None = None,
) -> torch.Tensor:
    """Radiance [N,3] of rays origins/directions [N,3] with per-ray RNG
    states sample_keys ([N] hash or [N,2] threefry), traced for max_depth
    bounces on the scene's device.

    exclude_prim0: optional [N] integer sphere id left out of the bounce-0
    hit query only (-1 for none), the background re-trace of the edge-aware
    estimator (``diff.edge``); it raises ValueError with compact=True, whose
    lane permutation would detach the exclusion from its ray. compact=True
    sorts the carry before every bounce, live rays first (compact_state);
    radiance and gradients are those of compact=False, bit for bit.

    diff=False: the full-mode kernel (A1) computes every hit quantity,
    detached; forward only (differentiating raises). diff=True: the
    shadow-mode kernel (A2) selects and every differentiable quantity is
    re-derived from the scene tensors (the 'fused_diff' intersector).

    tables: the scene's build_tables(scene), built by the caller for
    several traces of the unchanged scene; None builds them here."""
    if not isinstance(scene, SphereScene):
        raise TypeError("trace_flat handles SphereScene only")
    if tables is not None and not isinstance(tables, FusedSpheres):
        raise TypeError("trace_flat takes FusedSpheres tables")
    if exclude_prim0 is not None and compact:
        raise ValueError("exclude_prim0 is incompatible with compact (lane "
                         "permutation would detach the exclusion)")

    def run():
        ft = build_tables(scene) if tables is None else tables
        lights = scene.light_idx if nee and scene.num_lights > 0 else None
        state = initial_state(origins, directions, sample_keys)
        excl0 = None
        if exclude_prim0 is not None:
            # Padding lanes are dead; -1 excludes nothing.
            excl0 = torch.nn.functional.pad(
                exclude_prim0.detach().to(torch.int32),
                (0, state.ox.shape[0] - origins.shape[0]), value=-1)
        for depth_idx in range(max_depth):
            if compact:
                state = compact_state(state)
            state = bounce(ft, state, depth_idx, float(t_min),
                           int(rr_start), interpret, lights, diff,
                           excl0 if depth_idx == 0 else None)
        return radiance_in_ray_order(state, origins.shape[0], compact)

    if diff:
        return run()
    return _forward_only("trace_flat (intersector 'fused')", run, scene,
                         origins, directions)


# ------------------------------------------------------------ mesh worlds
class WorldTables(NamedTuple):
    """Kernel-layout world data (build_tables), built once per trace call,
    or once per forward render call, which hands it to every trace."""

    spheres: FusedSpheres
    mesh: MeshClusters
    faces: torch.Tensor    # [F,16] face_param_table
    lights: WorldLights
    num_spheres: int


def prep_world(world: World, cluster_rows: int = CLUSTER_ROWS,
               mt: str = "vpu") -> WorldTables:
    """The world's tables, its mesh packed in clusters of cluster_rows
    128-triangle rows, with the factors that mt="mxu" reads."""
    return WorldTables(prep_fused_spheres(world.spheres),
                       prep_mesh_clusters(world.mesh,
                                          cluster_rows=cluster_rows, mt=mt),
                       face_param_table(world.mesh).contiguous(),
                       world_lights(world), world.spheres.num_spheres)


def build_tables(scene, cluster_rows: int = CLUSTER_ROWS,
                 mt: str = "vpu"):
    """The kernel tables a trace reads, under the qtrt.prep span and
    counted in spans.counts["table_builds"] (one a trace call, or one a
    render call that hands its tables to every trace): prep_fused_spheres
    of a SphereScene (for trace_flat), prep_world of a World (for
    trace_flat_world; cluster_rows and mt as there)."""
    spans.counts["table_builds"] += 1
    with spans.annotate(spans.PREP):
        if isinstance(scene, SphereScene):
            return prep_fused_spheres(scene)
        return prep_world(scene, cluster_rows, mt)


def _world_hit_flat(wt: WorldTables, ox, oy, oz, dx, dy, dz, alive, t_min,
                    interpret, depth_idx=None, search=None):
    """Merged sphere + mesh closest hit on flat components (forward only):
    the sphere hit from A1, the mesh hit capped by A1's refined t, merged
    on a strict '<' into one id space (prim = num_spheres + triangle id),
    with the winning face's row of face_param_table.

    search: the keyword arguments of ``world.search_mesh`` (mesh_kernel,
    pair_c, sort0, sort_mode, visit, mt), which with depth_idx choose
    the mesh search: "clustered", "pairs" on every bounce, or "hybrid"
    (clustered at depth_idx 0, pairs after). Live lanes get the same bits
    under every choice but mt="mxu"."""
    ns = wt.num_spheres
    h = fused_hit(wt.spheres, ox, oy, oz, dx, dy, dz, alive, t_min,
                  interpret=interpret)
    t_m, idx_m = search_mesh(wt.mesh, ox, oy, oz, dx, dy, dz, t_min, alive,
                             h["t"], depth_idx=depth_idx, interpret=interpret,
                             **(search or {}))
    mesh_hit = t_m < BIG
    closer = mesh_hit & ((h["t"] >= BIG) | (t_m < h["t"]))

    t = torch.where(closer, t_m, h["t"])
    t_safe = torch.where(t < BIG, t, 1.0)
    fp = gather_rows(wt.faces, idx_m)                    # [N,16] gather
    gnx, gny, gnz = fp[:, 0], fp[:, 1], fp[:, 2]
    ff_m = dx * gnx + dy * gny + dz * gnz < 0.0
    sgn_m = torch.where(ff_m, 1.0, -1.0)

    w = lambda m_val, s_val: torch.where(closer, m_val, s_val)
    return {
        "t": t,
        "prim": torch.where(closer, ns + idx_m,
                            torch.where(h["t"] < BIG, h["idx"], 0)),
        "mat": w(fp[:, 9].to(torch.int32), h["mat"]),
        "ff": w(ff_m.to(torch.int32), h["ff"]),
        "px": w(ox + t_safe * dx, h["px"]),
        "py": w(oy + t_safe * dy, h["py"]),
        "pz": w(oz + t_safe * dz, h["pz"]),
        "nx": w(sgn_m * gnx, h["nx"]),
        "ny": w(sgn_m * gny, h["ny"]),
        "nz": w(sgn_m * gnz, h["nz"]),
        "ax": w(fp[:, 4], h["ax"]), "ay": w(fp[:, 5], h["ay"]),
        "az": w(fp[:, 6], h["az"]),
        "fuzz": w(fp[:, 7], h["fuzz"]), "ior": w(fp[:, 8], h["ior"]),
        "ex": w(fp[:, 10], h["ex"]), "ey": w(fp[:, 11], h["ey"]),
        "ez": w(fp[:, 12], h["ez"]),
        "rw": w(torch.zeros_like(t), h["rw"]),
        "area": torch.where(closer, fp[:, 3], 0.0),
    }


def _tri_pdf_flat(wx, wy, wz, d2, nx, ny, nz, area):
    """Area-to-solid-angle pdf of a triangle light on flat components."""
    cos_l = torch.abs(nx * wx + ny * wy + nz * wz)
    ok = (d2 > 1e-12) & (cos_l > 1e-7) & (area > 1e-20)
    den = torch.where(ok, torch.clamp_min(cos_l * area, 1e-30), 1.0)
    pdf = torch.where(ok, d2 / den, 0.0)
    return pdf, ok


def _nee_shadow_rays_world(lights: WorldLights, px, py, pz, nx, ny, nz,
                           diffuse, uni):
    """The NEE light sample of _nee_flat_world: one light picked uniformly
    from the world table, a cone sample (sphere) or a uniform-area sample
    (triangle). Returns (ldx, ldy, ldz, cand, pdf_j, cos_surf, row,
    exp_prim), where cand marks the lanes that cast a shadow ray."""
    u4, u5, u6 = uni[:, 4], uni[:, 5], uni[:, 6]
    n_lights = lights.n_total
    pick = torch.clamp((u4 * n_lights).to(torch.int32), 0,
                       n_lights - 1).long()
    row = lights.table[pick]                               # [N,16]
    exp_prim = lights.expected_prim[pick]
    is_tri = pick >= lights.n_sphere

    # Sphere light: cone sample.
    dsx, dsy, dsz, pdf_s, ok_s = _cone_sample(
        row[:, 0], row[:, 1], row[:, 2], row[:, 3], px, py, pz, u5, u6)

    # Triangle light: uniform-area sample.
    v0x_, v0y_, v0z_ = row[:, 0], row[:, 1], row[:, 2]
    e1x_, e1y_, e1z_ = row[:, 3], row[:, 4], row[:, 5]
    e2x_, e2y_, e2z_ = row[:, 6], row[:, 7], row[:, 8]
    flip = u5 + u6 > 1.0
    bu = torch.where(flip, 1.0 - u5, u5)
    bv = torch.where(flip, 1.0 - u6, u6)
    plx = v0x_ + bu * e1x_ + bv * e2x_
    ply = v0y_ + bu * e1y_ + bv * e2y_
    plz = v0z_ + bu * e1z_ + bv * e2z_
    wvx, wvy, wvz = plx - px, ply - py, plz - pz
    d2 = wvx * wvx + wvy * wvy + wvz * wvz
    _, winv_t = _safe_rsqrt_len2(wvx, wvy, wvz)
    dtx, dty, dtz = wvx * winv_t, wvy * winv_t, wvz * winv_t
    crx = e1y_ * e2z_ - e1z_ * e2y_
    cry = e1z_ * e2x_ - e1x_ * e2z_
    crz = e1x_ * e2y_ - e1y_ * e2x_
    two_area = safe_sqrt(crx * crx + cry * cry + crz * crz)
    area = 0.5 * two_area
    has_area = two_area > 1e-20
    inv2a = torch.where(has_area, torch.reciprocal(
        torch.where(has_area, two_area, 1.0)), 0.0)
    pdf_t, ok_t = _tri_pdf_flat(dtx, dty, dtz, d2, crx * inv2a, cry * inv2a,
                                crz * inv2a, area)

    ldx = torch.where(is_tri, dtx, dsx)
    ldy = torch.where(is_tri, dty, dsy)
    ldz = torch.where(is_tri, dtz, dsz)
    pdf_j = torch.where(is_tri, pdf_t, pdf_s)
    valid = torch.where(is_tri, ok_t, ok_s)
    cos_surf = nx * ldx + ny * ldy + nz * ldz
    cand = diffuse & valid & (cos_surf > 0.0)
    return ldx, ldy, ldz, cand, pdf_j, cos_surf, row, exp_prim


def _nee_flat_world(wt: WorldTables, px, py, pz, nx, ny, nz, ax, ay, az,
                    tx, ty, tz, diffuse, uni, t_min, interpret,
                    search=None):
    """integrator._nee_mis on flat components: one-sample MIS over the
    unified sphere + triangle light table. The shadow ray's closest world
    hit (A2, then the clustered mesh search capped by A2's unrefined t,
    with search's options but mesh_kernel, merged as in _world_hit_flat)
    must be exactly the chosen light."""
    (ldx, ldy, ldz, cand, pdf_j, cos_surf, row,
     exp_prim) = _nee_shadow_rays_world(wt.lights, px, py, pz, nx, ny, nz,
                                        diffuse, uni)
    sh = fused_hit(wt.spheres, px, py, pz, ldx, ldy, ldz, cand, t_min,
                   shadow_only=True, interpret=interpret)
    t_m, idx_m = search_mesh(wt.mesh, px, py, pz, ldx, ldy, ldz, t_min,
                             cand, sh["t"], interpret=interpret,
                             **{**(search or {}), "mesh_kernel": "clustered"})
    mesh_w = (t_m < BIG) & ((sh["t"] >= BIG) | (t_m < sh["t"]))
    has_win = mesh_w | (sh["t"] < BIG)
    win_prim = torch.where(mesh_w, wt.num_spheres + idx_m, sh["idx"])
    lit = cand & has_win & (win_prim == exp_prim)
    return _mis_contrib(cand, lit, pdf_j, wt.lights.n_total, cos_surf,
                        tx, ty, tz, ax, ay, az, row[:, 9], row[:, 10],
                        row[:, 11])


def _emit_weight_flat_world(h, ox, oy, oz, num_spheres, n_lights, prev_pdf):
    """integrator._emitter_mis_weight on flat components (both families)."""
    is_sphere = h["prim"] < num_spheres
    sgn = torch.where(h["ff"] > 0, 1.0, -1.0)
    lcx = h["px"] - h["rw"] * sgn * h["nx"]
    lcy = h["py"] - h["rw"] * sgn * h["ny"]
    lcz = h["pz"] - h["rw"] * sgn * h["nz"]
    pdf_sph, _, _, _ = _sphere_pdf_flat(lcx, lcy, lcz, h["rw"], ox, oy, oz)

    wvx, wvy, wvz = h["px"] - ox, h["py"] - oy, h["pz"] - oz
    d2 = wvx * wvx + wvy * wvy + wvz * wvz
    _, winv = _safe_rsqrt_len2(wvx, wvy, wvz)
    pdf_tri, _ = _tri_pdf_flat(wvx * winv, wvy * winv, wvz * winv, d2,
                               h["nx"], h["ny"], h["nz"], h["area"])
    pdf_nee = torch.where(is_sphere, pdf_sph, pdf_tri) / n_lights
    use = prev_pdf > 0.0
    denom = torch.where(use, prev_pdf + pdf_nee, 1.0)
    return torch.where(use, prev_pdf / denom, 1.0)


def bounce_world(wt: WorldTables, s: RayState, depth_idx: int, t_min: float,
                 nee: bool = False, rr_start: int = 0,
                 interpret: bool = False, search=None) -> RayState:
    """One bounce of every ray in a mesh world. search: _world_hit_flat's
    mesh-search options; the NEE shadow rays keep the clustered search."""
    h = _world_hit_flat(wt, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.alive,
                        t_min, interpret, depth_idx, search)
    emit_w, nee_fn = 1.0, None
    if nee and wt.lights.n_total > 0:
        emit_w = _emit_weight_flat_world(h, s.ox, s.oy, s.oz, wt.num_spheres,
                                         wt.lights.n_total, s.prev_pdf)
        nee_fn = lambda diffuse, uni: _nee_flat_world(
            wt, h["px"], h["py"], h["pz"], h["nx"], h["ny"], h["nz"],
            h["ax"], h["ay"], h["az"], s.tx, s.ty, s.tz, diffuse, uni,
            t_min, interpret, search)
    return _shade(s, h, depth_idx, rr_start, emit_w, nee_fn, interpret)


def trace_flat_world(
    world: World,
    origins: torch.Tensor,
    directions: torch.Tensor,
    sample_keys: torch.Tensor,
    max_depth: int,
    t_min: float = 1.0e-3,
    nee: bool = False,
    rr_start: int = 0,
    interpret: bool = False,
    compact: bool = False,
    mesh_kernel: str = "clustered",
    mesh_pair_c: int = 6,
    mesh_sort0: bool = True,
    mesh_sort_mode: str = "crossing",
    mesh_visit: str = "full",
    mesh_mt: str = "vpu",
    mesh_cluster_rows: int = CLUSTER_ROWS,
    tables: WorldTables | None = None,
) -> torch.Tensor:
    """Radiance [N,3] of rays in a mesh world (spheres + triangles), on the
    world's device; the same estimator and uniform slots as trace_flat.
    Forward only: differentiating it raises (mesh-world gradients take
    integrator.trace with the 'pallas' intersector).

    mesh_kernel: "clustered" (A3 behind the A4 sort), "pairs" (the
    pair-wavefront search, A7 and A8, on every bounce) or "hybrid"
    (clustered at bounce 0, pairs on bounce wavefronts); mesh_pair_c is the
    pair search's crossing-list width. mesh_sort0=False leaves the clustered
    search unsorted at bounce 0, whose rays arrive in pixel order.
    mesh_sort_mode is the clustered search's sort key ("crossing",
    "crossing2", "morton"), mesh_visit ("full", "subtile", "sliced",
    "rowgate") and mesh_mt ("vpu", "mxu") its kernel body, and
    mesh_cluster_rows its cluster size in 128-triangle rows. compact=True
    sorts the carry before every bounce, live rays first. None of these
    changes a bit of the image but mesh_mt="mxu", whose candidates round
    otherwise.

    tables: the world's build_tables(world, mesh_cluster_rows, mesh_mt),
    built by the caller for several traces of the unchanged world; None
    builds them here."""
    if not isinstance(world, World) or world.mesh is None:
        raise TypeError("trace_flat_world handles a World with a mesh")
    if tables is not None and not isinstance(tables, WorldTables):
        raise TypeError("trace_flat_world takes WorldTables tables")
    if mesh_kernel not in MESH_KERNELS:
        raise ValueError(f"mesh_kernel must be one of {MESH_KERNELS}, got "
                         f"{mesh_kernel!r}")

    search = dict(mesh_kernel=mesh_kernel, pair_c=int(mesh_pair_c),
                  sort0=bool(mesh_sort0), sort_mode=mesh_sort_mode,
                  visit=mesh_visit, mt=mesh_mt)

    def run():
        wt = (build_tables(world, mesh_cluster_rows, mesh_mt)
              if tables is None else tables)
        state = initial_state(origins, directions, sample_keys)
        for depth_idx in range(max_depth):
            if compact:
                state = compact_state(state)
            state = bounce_world(wt, state, depth_idx, float(t_min),
                                 bool(nee), int(rr_start), interpret, search)
        return radiance_in_ray_order(state, origins.shape[0], compact)

    return _forward_only("trace_flat_world", run, world, origins,
                         directions)
