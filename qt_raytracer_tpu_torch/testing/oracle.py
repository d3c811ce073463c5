"""Scalar float64 oracle tracer (counterpart of
``qt_raytracer_tpu.testing.oracle``, the same numpy code).

An independent NumPy re-implementation of the transport math, mirroring the
reference CPU tracer's semantics (include/raytracer/RayTracer.h:579-596 ray
color, :289-314 sphere hit, :473-540 materials, :543-576 camera,
src/app/RayTracerFboItem.cpp:102-128 pixel loop) in plain scalar loops at
double precision. It consumes the *identical* uniform stream as the
renderer, drawn from the port's own ``core.sampling`` on CPU tensors (bit
for bit the JAX package's), so any disagreement beyond float32-vs-float64
rounding is an algorithmic bug in the renderer: the golden-image seam that
judges every search, whatever its tie rule. No torch arithmetic runs inside
the tracing loops: the uniforms, scene, mesh and camera are numpy float64
arrays before the first ray.

Deliberate differences from the reference, mirrored here by design:
  - closed-form disk/sphere samplers instead of rejection loops,
  - closest-hit ties resolve to the lowest primitive index (argmin).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import sampling
from ..core.config import RenderConfig
from ..core.scene import DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL

TWO_PI = 6.283185307179586


# ---------------------------------------------------------------- RNG stream
def pixel_keys(key, cfg: RenderConfig) -> torch.Tensor:
    """The renderer's per-pixel RNG states of every pixel, on the CPU. key:
    an int seed or a [2] tensor of key words, on any device."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu()
    return sampling.pixel_states(key, torch.arange(cfg.num_pixels), cfg.rng)


def extract_uniforms(key, cfg: RenderConfig):
    """Materialize the renderer's full uniform stream on host.

    Returns (gen [spp, N, 4], bounce [spp, N, depth, 8]) float64 arrays,
    bitwise equal (as f32) to what the renderer consumes.
    """
    pix_keys = pixel_keys(key, cfg)
    gen_all = []
    bounce_all = []
    for s in range(cfg.spp):
        samp_keys = sampling.sample_keys(pix_keys, s)
        gen_all.append(np.asarray(
            sampling.stream_uniforms(samp_keys, sampling.STREAM_GEN,
                                     sampling.UNIFORMS_GEN), np.float64))
        per_bounce = [
            np.asarray(sampling.stream_uniforms(
                samp_keys, sampling.STREAM_BOUNCE0 + b,
                sampling.UNIFORMS_PER_BOUNCE), np.float64)
            for b in range(cfg.max_depth)
        ]
        bounce_all.append(np.stack(per_bounce, axis=1))  # [N, depth, 8]
    return np.stack(gen_all), np.stack(bounce_all)


# ------------------------------------------------------------- scalar helpers
def _unit(v):
    return v / np.linalg.norm(v)


def _reflect(v, n):
    return v - 2.0 * np.dot(v, n) * n


def _refract(uv, n, ratio):
    cos_theta = min(np.dot(-uv, n), 1.0)
    r_out_perp = ratio * (uv + cos_theta * n)
    r_out_parallel = -np.sqrt(abs(1.0 - np.dot(r_out_perp, r_out_perp))) * n
    return r_out_perp + r_out_parallel


def _reflectance(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def _unit_vector_sample(u1, u2):
    z = 1.0 - 2.0 * u1
    r = np.sqrt(max(0.0, 1.0 - z * z))
    phi = TWO_PI * u2
    return np.array([r * np.cos(phi), r * np.sin(phi), z])


def _in_unit_sphere_sample(u1, u2, u3):
    return _unit_vector_sample(u1, u2) * np.cbrt(u3)


def _in_unit_disk_sample(u1, u2):
    r = np.sqrt(u1)
    phi = TWO_PI * u2
    return np.array([r * np.cos(phi), r * np.sin(phi), 0.0])


# ------------------------------------------------------------------ geometry
def _hit_mesh_brute(mesh, o, d, t_min, t_max):
    """Scalar Möller-Trumbore scan over all triangles (mirrors accel/mesh)."""
    best_t, best_i = np.inf, -1
    v0s, e1s, e2s = mesh["v0"], mesh["e1"], mesh["e2"]
    for fi in range(len(v0s)):
        e1, e2 = e1s[fi], e2s[fi]
        p = np.cross(d, e2)
        det = np.dot(p, e1)
        if abs(det) <= 1e-12:
            continue
        inv_det = 1.0 / det
        s = o - v0s[fi]
        u = np.dot(s, p) * inv_det
        if u < 0.0:
            continue
        q = np.cross(s, e1)
        v = np.dot(q, d) * inv_det
        if v < 0.0 or u + v > 1.0:
            continue
        t = np.dot(q, e2) * inv_det
        if t < t_min or t > t_max or t >= best_t:
            continue
        best_t, best_i = t, fi
    return best_t, best_i


def _hit_scene(scene, o, d, t_min):
    """Closest sphere hit; mirrors Sphere::hit + argmin tie-break.

    Roots use the renderer's numerically stable Citardauq form
    (core/intersect.py refinement; same math as RayTracer.h:289-305, exact
    in f64) so the oracle stays a LITERAL mirror of the renderer."""
    centers = scene["center"]
    radii = scene["radius"]
    active = scene["active"]
    best_t = np.inf
    best_i = -1
    for si in range(len(radii)):
        if not active[si]:
            continue
        oc = o - centers[si]
        a = np.dot(d, d)
        half_b = np.dot(oc, d)
        c = np.dot(oc, oc) - radii[si] * radii[si]
        disc = half_b * half_b - a * c
        if disc < 0:
            continue
        sqrtd = np.sqrt(disc)
        # Citardauq: q carries the non-cancelling sum; the other root is c/q.
        q = -half_b - (sqrtd if half_b >= 0.0 else -sqrtd)
        root_a = q / a
        root_b = 0.0 if q == 0.0 else c / q
        near = root_a if half_b >= 0.0 else root_b
        far = root_b if half_b >= 0.0 else root_a
        root = near
        if root < t_min or root > best_t:
            root = far
            if root < t_min or root > best_t:
                continue
        if root < best_t:  # strict: ties keep the earlier (lower) index
            best_t = root
            best_i = si
    return best_t, best_i


def _sky(d):
    unit = _unit(d)
    t = 0.5 * (unit[1] + 1.0)
    return (1.0 - t) * np.array([1.0, 1.0, 1.0]) + t * np.array([0.5, 0.7, 1.0])


# ----------------------------------------------------------------- transport
def _onb(w):
    """Branchless ONB (Duff et al.) — mirrors integrator._onb exactly."""
    sign = 1.0 if w[2] >= 0.0 else -1.0
    a = -1.0 / (sign + w[2])
    b = w[0] * w[1] * a
    t1 = np.array([1.0 + sign * w[0] * w[0] * a, sign * b, -sign * w[0]])
    t2 = np.array([b, sign + w[1] * w[1] * a, -w[1]])
    return t1, t2


INV_PI = 1.0 / np.pi


def _sphere_pdf(center, radius, from_p):
    """Mirror of integrator._sphere_solid_angle_pdf (scalar f64)."""
    to_l = center - from_p
    dist2 = np.dot(to_l, to_l)
    outside = dist2 > radius * radius * 1.0001
    sin2 = min(1.0, radius * radius / max(dist2, 1e-12))
    cos_max = np.sqrt(max(0.0, 1.0 - sin2))
    omc = sin2 / (1.0 + cos_max)
    ok = bool(outside) and omc > 1e-12
    pdf = 1.0 / max(2.0 * np.pi * omc, 1e-30) if ok else 0.0
    return pdf, ok, cos_max, to_l, dist2


def _nee_once(scene, p, normal, throughput, u, t_min, lights, hit_albedo,
              num_spheres, mesh=None):
    """Mirror of integrator._nee_mis for one diffuse hit (one-sample MIS,
    balance heuristic). lights: [(kind, idx)] — kind 0 = sphere, 1 = mesh
    face, in the renderer's world_lights order (spheres first)."""
    n_lights = len(lights)
    pick = min(int(u[4] * n_lights), n_lights - 1)
    kind, li = lights[pick]
    if kind == 0:
        lc = scene["center"][li]
        lr = scene["radius"][li]
        le = scene["emission"][li]
        pdf_j, ok, cos_max, to_l, dist2 = _sphere_pdf(lc, lr, p)
        if not ok:
            return np.zeros(3)
        w = to_l / np.sqrt(dist2)
        cos_a = 1.0 - u[5] * (1.0 - cos_max)
        sin_a = np.sqrt(max(0.0, 1.0 - cos_a * cos_a))
        phi = TWO_PI * u[6]
        t1, t2 = _onb(w)
        ldir = sin_a * np.cos(phi) * t1 + sin_a * np.sin(phi) * t2 + cos_a * w
        expected = ("s", li)
    else:
        v0, e1, e2 = mesh["v0"][li], mesh["e1"][li], mesh["e2"][li]
        le = mesh["emission"][li]
        bu, bv = u[5], u[6]
        if bu + bv > 1.0:
            bu, bv = 1.0 - bu, 1.0 - bv
        p_l = v0 + bu * e1 + bv * e2
        wv = p_l - p
        d2 = np.dot(wv, wv)
        if d2 <= 1e-12:
            return np.zeros(3)
        ldir = wv / np.sqrt(d2)
        cr = np.cross(e1, e2)
        two_area = np.linalg.norm(cr)
        area = 0.5 * two_area
        if area <= 1e-20:
            return np.zeros(3)
        n_l = cr / two_area
        cos_l = abs(np.dot(n_l, ldir))
        if cos_l <= 1e-7:
            return np.zeros(3)
        pdf_j = d2 / max(cos_l * area, 1e-30)
        expected = ("t", li)
    cos_surf = np.dot(normal, ldir)
    if cos_surf <= 0.0:
        return np.zeros(3)
    # Shadow: the closest world hit must be exactly the chosen light.
    t_s, si = _hit_scene(scene, p, ldir, t_min)
    winner = ("s", si) if si >= 0 else None
    if mesh is not None:
        t_m, fi = _hit_mesh_brute(mesh, p, ldir, t_min,
                                  t_s if si >= 0 else np.inf)
        if fi >= 0 and t_m < (t_s if si >= 0 else np.inf):
            winner = ("t", fi)
    if winner != expected:
        return np.zeros(3)
    pdf_nee = pdf_j / n_lights
    denom = pdf_nee + cos_surf * INV_PI
    factor = cos_surf * INV_PI / max(denom, 1e-30)
    return throughput * hit_albedo * factor * le


def _emit_weight_once(scene, mesh, p, o, si, fi, mesh_won, n_lights,
                      prev_pdf):
    """Mirror of integrator._emitter_mis_weight for one emitter hit."""
    if prev_pdf <= 0.0:
        return 1.0
    if mesh_won:
        wv = p - o
        d2 = np.dot(wv, wv)
        e1, e2 = mesh["e1"][fi], mesh["e2"][fi]
        cr = np.cross(e1, e2)
        two_area = np.linalg.norm(cr)
        area = 0.5 * two_area
        if d2 <= 1e-12 or area <= 1e-20:
            pdf_j = 0.0
        else:
            ldir = wv / np.sqrt(d2)
            cos_l = abs(np.dot(cr / two_area, ldir))
            pdf_j = d2 / max(cos_l * area, 1e-30) if cos_l > 1e-7 else 0.0
    else:
        pdf_j, _, _, _, _ = _sphere_pdf(scene["center"][si],
                                        scene["radius"][si], o)
    pdf_nee = pdf_j / n_lights
    return prev_pdf / (prev_pdf + pdf_nee)


def _trace_one(scene, o, d, bounce_u, max_depth, t_min, nee=False,
               lights=None, mesh=None, rr_start=0):
    nee_active = bool(nee) and lights is not None and len(lights) > 0
    throughput = np.ones(3)
    radiance = np.zeros(3)
    prev_pdf = -1.0   # pdf of the generating bounce; -1 = camera/specular
    for b in range(max_depth):
        t, si = _hit_scene(scene, o, d, t_min)
        mesh_won, fi = False, -1
        if mesh is not None:
            tm, fi = _hit_mesh_brute(mesh, o, d, t_min,
                                     t if si >= 0 else np.inf)
            if fi >= 0 and tm < (t if si >= 0 else np.inf):
                t, mesh_won = tm, True
        if si < 0 and not mesh_won:
            return radiance + throughput * _sky(d)
        p = o + t * d
        if mesh_won:
            gn = mesh["geom_normal"][fi]
            front_face = np.dot(d, gn) < 0.0
            normal = gn if front_face else -gn
            mat = int(mesh["mat_type"][fi])
            albedo, fuzz = mesh["albedo"][fi], mesh["fuzz"][fi]
            ior_v, emission = mesh["ior"][fi], mesh["emission"][fi]
        else:
            outward = (p - scene["center"][si]) / scene["radius"][si]
            front_face = np.dot(d, outward) < 0.0
            normal = outward if front_face else -outward
            mat = scene["mat_type"][si]
            albedo, fuzz = scene["albedo"][si], scene["fuzz"][si]
            ior_v, emission = scene["ior"][si], scene["emission"][si]
        u = bounce_u[b]

        if mat == LAMBERTIAN:
            if nee_active:
                radiance = radiance + _nee_once(scene, p, normal, throughput,
                                                u, t_min, lights, albedo,
                                                len(scene["radius"]),
                                                mesh=mesh)
            nd = normal + _unit_vector_sample(u[0], u[1])
            if np.dot(nd, nd) < 1e-8:
                nd = normal
            throughput = throughput * albedo
            if nee_active:
                ndu = nd / np.linalg.norm(nd)
                prev_pdf = max(np.dot(normal, ndu), 0.0) * INV_PI
            o, d = p, nd
        elif mat == METAL:
            refl = _reflect(_unit(d), normal)
            nd = refl + fuzz * _in_unit_sphere_sample(u[0], u[1], u[2])
            if np.dot(nd, normal) <= 0.0:
                return radiance  # absorbed (RayTracer.h:498)
            throughput = throughput * albedo
            o, d = p, nd
            prev_pdf = -1.0
        elif mat == DIELECTRIC:
            ratio = (1.0 / ior_v) if front_face else ior_v
            ud = _unit(d)
            cos_theta = min(np.dot(-ud, normal), 1.0)
            sin_theta = np.sqrt(max(0.0, 1.0 - cos_theta * cos_theta))
            cannot = ratio * sin_theta > 1.0
            if cannot or _reflectance(cos_theta, ratio) > u[3]:
                nd = _reflect(ud, normal)
            else:
                nd = _refract(ud, normal, ratio)
            o, d = p, nd
            prev_pdf = -1.0
        elif mat == EMISSIVE:
            # MIS: BSDF-sampled emitter hits are balance-weighted against the
            # NEE pdf of the same direction (full weight for camera/specular
            # rays, or when NEE is off).
            w = 1.0
            if nee_active:
                w = _emit_weight_once(scene, mesh, p, o, si, fi, mesh_won,
                                      len(lights), prev_pdf)
            radiance = radiance + throughput * emission * w
            return radiance
        else:
            raise ValueError(f"bad material tag {mat}")
        if rr_start > 0 and b >= rr_start:
            p_cont = min(max(float(np.max(throughput)), 0.05), 1.0)
            if u[7] >= p_cont:
                return radiance
            throughput = throughput / p_cont
    return radiance  # depth exhausted (RayTracer.h:582)


def _np(x: torch.Tensor, dtype) -> np.ndarray:
    """A tensor of the port's dataclasses as a numpy array, from any
    device."""
    return np.asarray(x.detach().cpu().numpy(), dtype)


def camera_to_np(camera) -> dict:
    return {k: _np(getattr(camera, k), np.float64)
            for k in ("origin", "lower_left_corner", "horizontal", "vertical",
                      "u", "v", "w", "lens_radius")}


def scene_to_np(scene) -> dict:
    return {k: _np(getattr(scene, k),
                   np.float64 if k != "mat_type" else np.int32)
            for k in ("center", "radius", "mat_type", "albedo", "fuzz", "ior",
                      "emission", "active")}


def mesh_to_np(mesh) -> dict:
    out = {k: _np(getattr(mesh, k), np.float64)
           for k in ("v0", "e1", "e2", "geom_normal", "albedo", "fuzz", "ior",
                     "emission")}
    out["mat_type"] = _np(mesh.mat_type, np.int32)
    out["light_tri"] = _np(mesh.light_tri, np.int64)
    return out


def render_oracle_linear(scene, camera, cfg: RenderConfig, key) -> np.ndarray:
    """Sum of spp linear radiance samples, [H, W, 3] float64 — directly
    comparable to render_linear(). scene: SphereScene or World, on any
    device; key: an int seed or a [2] tensor of key words."""
    mesh = None
    if hasattr(scene, "spheres"):  # World
        if scene.mesh is not None:
            mesh = mesh_to_np(scene.mesh)
        scene = scene.spheres
    sc = scene_to_np(scene)
    cam = camera_to_np(camera)
    # Unified light list in world_lights order: sphere lights, then faces.
    lights = [(0, int(i)) for i in _np(scene.light_idx, np.int64)]
    if mesh is not None:
        lights += [(1, int(f)) for f in mesh["light_tri"]]
    gen_u, bounce_u = extract_uniforms(key, cfg)

    h, w = cfg.height, cfg.width
    inv_w = 1.0 / max(w - 1, 1)
    inv_h = 1.0 / max(h - 1, 1)
    out = np.zeros((h, w, 3))
    for py in range(h):
        j = h - 1 - py
        for px in range(w):
            pix = py * w + px
            acc = np.zeros(3)
            for s in range(cfg.spp):
                g = gen_u[s, pix]
                u_coord = (px + g[0]) * inv_w
                v_coord = (j + g[1]) * inv_h
                rd = cam["lens_radius"] * _in_unit_disk_sample(g[2], g[3])
                offset = rd[0] * cam["u"] + rd[1] * cam["v"]
                o = cam["origin"] + offset
                d = (cam["lower_left_corner"] + u_coord * cam["horizontal"]
                     + v_coord * cam["vertical"] - cam["origin"] - offset)
                acc += _trace_one(sc, o, d, bounce_u[s, pix], cfg.max_depth,
                                  cfg.t_min, nee=cfg.nee, lights=lights,
                                  mesh=mesh, rr_start=cfg.rr_start)
            out[py, px] = acc
    return out
