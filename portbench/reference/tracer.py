"""The plain reference path tracer: plain PyTorch, in any float dtype, on
any device, from the scene inputs alone.

It renders what the port renders (a thin-lens camera, Lambertian, metal,
dielectric and emissive spheres, triangle meshes, next-event estimation
toward sphere lights with the balance heuristic, Russian roulette) on the
same random stream (``rng.py``), and differentiates it the way the port's
pathwise estimator does: every decision (which primitive wins, which
branch a material takes, whether a shadow ray reaches its light) is held
fixed, and derivatives flow through the continuous quantities.

Nothing here is derived from the port: the closest hit is a brute-force
search over every sphere and every triangle in input order (lowest index
on a tie), with no box, BVH, cluster or table; the camera, the normals and
the light list are worked out again from the inputs.

Rays are traced in [N] columns. Each bounce works on the live rays only.
``record`` (a list) receives each bounce's live rays, their sphere hit and
their closest hit: the wavefronts that the roofline rules of
``portbench/roofline`` count on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import rng

LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3
TWO_PI = 6.283185307179586
INV_PI = 1.0 / math.pi
INF = float("inf")
PAIR_BUDGET = 1 << 22     # (ray, primitive) pairs per brute-force block


@dataclass
class Scene:
    """The scene inputs as tensors of one dtype on one device."""

    center: torch.Tensor     # [S, 3]
    radius: torch.Tensor     # [S]
    mat: torch.Tensor        # [S] int64 material tag
    albedo: torch.Tensor     # [S, 3]
    fuzz: torch.Tensor       # [S]
    ior: torch.Tensor        # [S]
    emission: torch.Tensor   # [S, 3]
    lights: torch.Tensor     # [L] int64: emissive spheres, input order
    v0: torch.Tensor | None = None     # [F, 3] triangles, input order
    e1: torch.Tensor | None = None
    e2: torch.Tensor | None = None
    gn: torch.Tensor | None = None     # [F, 3] unit geometric normals
    tri_mat: torch.Tensor | None = None
    tri_albedo: torch.Tensor | None = None
    tri_fuzz: torch.Tensor | None = None
    tri_ior: torch.Tensor | None = None
    tri_emission: torch.Tensor | None = None


def make_scene(inputs: dict, dtype, device) -> Scene:
    """Scene tensors from the raw inputs of ``portbench.harness.inputs``
    (numpy arrays): spheres, and an optional triangle mesh with per-face
    materials."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float64).to(device, dtype)
    sp = inputs["spheres"]
    mat = torch.as_tensor(sp["mat"], dtype=torch.int64).to(device)
    scene = Scene(center=f(sp["center"]), radius=f(sp["radius"]), mat=mat,
                  albedo=f(sp["albedo"]), fuzz=f(sp["fuzz"]),
                  ior=f(sp["ior"]), emission=f(sp["emission"]),
                  lights=torch.nonzero(mat == EMISSIVE).squeeze(1))
    me = inputs.get("mesh")
    if me is not None:
        verts = torch.as_tensor(me["vertices"], dtype=torch.float64)
        faces = torch.as_tensor(me["faces"], dtype=torch.int64)
        a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        a, b, c = (f(x.numpy()) for x in (a, b, c))
        scene.v0, scene.e1, scene.e2 = a, b - a, c - a
        cr = torch.linalg.cross(scene.e1, scene.e2)
        scene.gn = cr / torch.linalg.vector_norm(cr, dim=1, keepdim=True)
        scene.tri_mat = torch.as_tensor(me["mat"],
                                        dtype=torch.int64).to(device)
        scene.tri_albedo, scene.tri_fuzz = f(me["albedo"]), f(me["fuzz"])
        scene.tri_ior, scene.tri_emission = f(me["ior"]), f(me["emission"])
        if bool((scene.tri_mat == EMISSIVE).any()):
            raise NotImplementedError("the reference has no triangle lights")
    return scene


@dataclass
class Camera:
    origin: torch.Tensor
    lower_left: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    lens_radius: torch.Tensor


def make_camera(params: dict, aspect: float, dtype, device,
                translate=None) -> Camera:
    """The thin-lens camera of 'Ray Tracing in One Weekend' from lookfrom,
    lookat, vup, vfov (degrees), aperture and focus_dist; translate moves
    the whole camera (origin and image plane) by a [3] vector."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float64).to(device, dtype)
    lookfrom, lookat, vup = (f(params[k]) for k in ("lookfrom", "lookat",
                                                     "vup"))
    unit = lambda x: x / torch.linalg.vector_norm(x)
    h = math.tan(math.radians(float(params["vfov"])) / 2.0)
    vh = 2.0 * h
    vw = aspect * vh
    w = unit(lookfrom - lookat)
    u = unit(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    fd = float(params["focus_dist"])
    horizontal = fd * vw * u
    vertical = fd * vh * v
    lower_left = lookfrom - horizontal / 2.0 - vertical / 2.0 - fd * w
    origin = lookfrom
    if translate is not None:
        origin = origin + translate
        lower_left = lower_left + translate
    return Camera(origin, lower_left, horizontal, vertical, u, v,
                  f(float(params["aperture"]) / 2.0))


def _safe_sqrt(x):
    """sqrt of max(x, 0), with a zero (not an infinite) slope at 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def camera_rays(cam: Camera, width: int, height: int, pixel: torch.Tensor,
                states: torch.Tensor, dtype):
    """Primary rays of the flat pixels pixel (row 0 at the top) for one
    sample's states: jitter in the pixel, a point on the lens."""
    g = rng.uniforms(states, rng.STREAM_GEN, rng.UNIFORMS_GEN).to(dtype)
    i = (pixel % width).to(dtype)
    j = (height - 1 - pixel // width).to(dtype)
    s = (i + g[:, 0]) / max(width - 1, 1)
    t = (j + g[:, 1]) / max(height - 1, 1)
    r = torch.sqrt(g[:, 2])
    phi = TWO_PI * g[:, 3]
    rd0, rd1 = cam.lens_radius * r * torch.cos(phi), \
        cam.lens_radius * r * torch.sin(phi)
    offset = rd0[:, None] * cam.u + rd1[:, None] * cam.v
    o = cam.origin + offset
    d = (cam.lower_left + s[:, None] * cam.horizontal
         + t[:, None] * cam.vertical - cam.origin - offset)
    return o, d


def _roots(oc, d, r2):
    """(near, far, disc >= 0) of |oc + t d|^2 = r^2 in the stable form."""
    a = _dot(d, d)
    half_b = _dot(oc, d)
    c = _dot(oc, oc) - r2
    disc = half_b * half_b - a * c
    sq = _safe_sqrt(disc)
    q = -half_b - torch.where(half_b >= 0.0, sq, -sq)
    root_a = q / a
    root_b = torch.where(q == 0.0, torch.zeros_like(q),
                         c / torch.where(q == 0.0, torch.ones_like(q), q))
    near = torch.where(half_b >= 0.0, root_a, root_b)
    far = torch.where(half_b >= 0.0, root_b, root_a)
    return near, far, disc >= 0.0


def sphere_closest(sc: Scene, o, d, t_min: float):
    """(t, index) of the closest sphere hit at t >= t_min of each ray, by
    brute force over every sphere; index -1 and t = inf on a miss. Ties go
    to the lowest index."""
    n, s = o.shape[0], sc.center.shape[0]
    t_out = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    i_out = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    rows = max(1, PAIR_BUDGET // max(s, 1))
    r2 = sc.radius * sc.radius
    for lo in range(0, n, rows):
        oo, dd = o[lo:lo + rows, None, :], d[lo:lo + rows, None, :]
        near, far, ok = _roots(oo - sc.center[None], dd, r2[None])
        root = torch.where(near >= t_min, near,
                           torch.where(far >= t_min, far,
                                       torch.full_like(far, INF)))
        root = torch.where(ok, root, torch.full_like(root, INF))
        t, i = root.min(dim=1)
        t_out[lo:lo + rows] = t
        i_out[lo:lo + rows] = torch.where(t < INF, i, -1)
    return t_out, i_out


def mesh_closest(sc: Scene, o, d, t_min: float, cap):
    """(t, index) of the closest triangle hit with t_min <= t <= cap
    (Moller-Trumbore), by brute force over every triangle; -1 on a miss.
    Ties go to the lowest index."""
    n, nf = o.shape[0], sc.v0.shape[0]
    best_t = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    cols = max(1, min(nf, PAIR_BUDGET // max(n, 1)))
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    capc = cap[:, None]
    for lo in range(0, nf, cols):
        v0, e1, e2 = (x[lo:lo + cols].T[:, None, :]
                      for x in (sc.v0, sc.e1, sc.e2))
        (ax, ay, az), (bx, by, bz) = e1, e2
        px, py, pz = dy * bz - dz * by, dz * bx - dx * bz, dx * by - dy * bx
        det = px * ax + py * ay + pz * az
        ok = torch.abs(det) > 1e-12
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
        u = (sx * px + sy * py + sz * pz) * inv
        qx, qy, qz = sy * az - sz * ay, sz * ax - sx * az, sx * ay - sy * ax
        v = (qx * dx + qy * dy + qz * dz) * inv
        t = (qx * bx + qy * by + qz * bz) * inv
        ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) \
            & (t <= capc)
        t = torch.where(ok, t, torch.full_like(t, INF))
        tc, ic = t.min(dim=1)
        better = tc < best_t
        best_t = torch.where(better, tc, best_t)
        best_i = torch.where(better, ic + lo, best_i)
    return best_t, best_i


def world_closest(sc: Scene, o, d, t_min: float):
    """(t_sphere, i_sphere, t_mesh, i_mesh, mesh_won) of each ray: the mesh
    wins where its hit lies strictly before the sphere hit."""
    t_s, i_s = sphere_closest(sc, o, d, t_min)
    if sc.v0 is None:
        return t_s, i_s, None, None, torch.zeros_like(i_s, dtype=torch.bool)
    t_m, i_m = mesh_closest(sc, o, d, t_min, t_s)
    return t_s, i_s, t_m, i_m, (i_m >= 0) & (t_m < t_s)


def _sphere_t(center, radius, o, d, t_min):
    """Differentiable t of each ray's chosen sphere (near root, else far)."""
    near, far, _ = _roots(o - center, d, radius * radius)
    return torch.where(near >= t_min, near, far)


def _tri_t(sc: Scene, idx, o, d):
    """Differentiable Moller-Trumbore t of each ray's chosen triangle."""
    v0, e1, e2 = sc.v0[idx], sc.e1[idx], sc.e2[idx]
    p = torch.linalg.cross(d, e2)
    det = _dot(p, e1)
    q = torch.linalg.cross(o - v0, e1)
    return _dot(q, e2) / det


def _sphere_pdf(center, radius, from_p):
    """Solid-angle pdf of sampling a sphere light's cone from from_p."""
    to_l = center - from_p
    dist2 = _dot(to_l, to_l)
    outside = dist2 > radius * radius * 1.0001
    sin2 = torch.clamp(radius * radius / torch.clamp_min(dist2, 1e-12),
                       max=1.0)
    cos_max = _safe_sqrt(1.0 - sin2)
    omc = sin2 / (1.0 + cos_max)
    ok = outside & (omc > 1e-12)
    pdf = torch.where(ok, 1.0 / torch.clamp_min(TWO_PI * omc, 1e-30),
                      torch.zeros_like(omc))
    return pdf, ok, cos_max, to_l, dist2


def _nee(sc: Scene, emission, p, normal, throughput, albedo, u, t_min):
    """One light sample with the balance heuristic; the shadow ray counts
    when the closest hit along it is the light it aimed at."""
    n_lights = sc.lights.shape[0]
    pick = torch.clamp((u[:, 4] * n_lights).to(torch.int64), 0, n_lights - 1)
    li = sc.lights[pick]
    pdf, ok, cos_max, to_l, dist2 = _sphere_pdf(sc.center[li],
                                                sc.radius[li], p)
    w = to_l / torch.sqrt(dist2)[:, None]
    cos_a = 1.0 - u[:, 5] * (1.0 - cos_max)
    sin_a = _safe_sqrt(1.0 - cos_a * cos_a)
    phi = TWO_PI * u[:, 6]
    sign = torch.where(w[:, 2] >= 0.0, 1.0, -1.0).to(w.dtype)
    a = -1.0 / (sign + w[:, 2])
    b = w[:, 0] * w[:, 1] * a
    t1 = torch.stack([1.0 + sign * w[:, 0] * w[:, 0] * a, sign * b,
                      -sign * w[:, 0]], dim=-1)
    t2 = torch.stack([b, sign + w[:, 1] * w[:, 1] * a, -w[:, 1]], dim=-1)
    ldir = (sin_a * torch.cos(phi))[:, None] * t1 \
        + (sin_a * torch.sin(phi))[:, None] * t2 + cos_a[:, None] * w
    cos_surf = _dot(normal, ldir)
    cand = ok & (cos_surf > 0.0)
    with torch.no_grad():
        _, i_s, _, _, mesh_won = world_closest(sc, p.detach(), ldir.detach(),
                                               t_min)
    lit = cand & ~mesh_won & (i_s == li)
    pdf_nee = pdf / n_lights
    factor = cos_surf * INV_PI / torch.clamp_min(pdf_nee + cos_surf * INV_PI,
                                                 1e-30)
    contrib = throughput * albedo * factor[:, None] * emission[li]
    return torch.where(lit[:, None], contrib, torch.zeros_like(contrib))


def trace(sc: Scene, o, d, states, max_depth: int, t_min: float,
          nee: bool = False, rr_start: int = 0, albedo=None, emission=None,
          record: list | None = None):
    """[N, 3] radiance of rays (o, d) with per-ray sample states. albedo
    and emission ([S, 3]) stand in for the scene's sphere tables, so that a
    gradient can reach them."""
    albedo = sc.albedo if albedo is None else albedo
    emission = sc.emission if emission is None else emission
    dtype, dev = o.dtype, o.device
    n = o.shape[0]
    nee = bool(nee) and sc.lights.shape[0] > 0
    radiance = torch.zeros((n, 3), dtype=dtype, device=dev)
    throughput = torch.ones((n, 3), dtype=dtype, device=dev)
    prev_pdf = torch.full((n,), -1.0, dtype=dtype, device=dev)
    live = torch.arange(n, device=dev)
    sky_lo = torch.ones(3, dtype=dtype, device=dev)
    sky_hi = torch.tensor([0.5, 0.7, 1.0], dtype=torch.float64).to(dev, dtype)
    for b in range(max_depth):
        if live.numel() == 0:
            break
        o_l, d_l, th = o[live], d[live], throughput[live]
        with torch.no_grad():
            t_s, i_s, t_m, i_m, mesh_won = world_closest(
                sc, o_l.detach(), d_l.detach(), t_min)
        if record is not None:
            t_hit = t_s if t_m is None else torch.where(mesh_won, t_m, t_s)
            record.append({"o": o_l.detach(), "d": d_l.detach(),
                           "t_sphere": t_s, "t_hit": t_hit})
        hit = (i_s >= 0) | mesh_won
        # Rays that leave the scene see the sky.
        ud = _unit(d_l)
        tk = 0.5 * (ud[:, 1] + 1.0)
        sky = (1.0 - tk)[:, None] * sky_lo + tk[:, None] * sky_hi
        radiance = radiance.index_add(
            0, live, torch.where(hit[:, None], torch.zeros_like(sky),
                                 th * sky))
        keep = torch.nonzero(hit).squeeze(1)
        live, o_l, d_l, th, ud = (x[keep] for x in (live, o_l, d_l, th, ud))
        i_s, mesh_won = i_s[keep], mesh_won[keep]
        si = torch.clamp_min(i_s, 0)
        center, radius = sc.center[si], sc.radius[si]
        t = _sphere_t(center, radius, o_l, d_l, t_min)
        if sc.v0 is not None:
            fi = torch.clamp_min(i_m[keep], 0)
            t = torch.where(mesh_won, _tri_t(sc, fi, o_l, d_l), t)
        p = o_l + t[:, None] * d_l
        outward = (p - center) / radius[:, None]
        front = _dot(d_l, outward) < 0.0
        normal = torch.where(front[:, None], outward, -outward)
        mat, alb, em = sc.mat[si], albedo[si], emission[si]
        fuzz, ior = sc.fuzz[si], sc.ior[si]
        if sc.v0 is not None:
            gn = sc.gn[fi]
            front_m = _dot(d_l, gn) < 0.0
            mw = mesh_won
            front = torch.where(mw, front_m, front)
            normal = torch.where(mw[:, None],
                                 torch.where(front_m[:, None], gn, -gn),
                                 normal)
            mat = torch.where(mw, sc.tri_mat[fi], mat)
            alb = torch.where(mw[:, None], sc.tri_albedo[fi], alb)
            em = torch.where(mw[:, None], sc.tri_emission[fi], em)
            fuzz = torch.where(mw, sc.tri_fuzz[fi], fuzz)
            ior = torch.where(mw, sc.tri_ior[fi], ior)
        u = rng.uniforms(states[live], rng.STREAM_BOUNCE0 + b,
                         rng.UNIFORMS_PER_BOUNCE).to(dtype)
        is_lam, is_met = mat == LAMBERTIAN, mat == METAL
        is_die, is_emit = mat == DIELECTRIC, mat == EMISSIVE

        # Emission, weighted against the light sample of the bounce before.
        weight = torch.ones_like(t)
        if nee:
            pdf_l, _, _, _, _ = _sphere_pdf(center, radius, o_l)
            pdf_l = pdf_l / sc.lights.shape[0]
            pp = prev_pdf[live]
            use = pp > 0.0
            weight = torch.where(use, pp / torch.where(use, pp + pdf_l,
                                                       torch.ones_like(pp)),
                                 weight)
        add = torch.where(is_emit[:, None], th * em * weight[:, None],
                          torch.zeros_like(th))
        if nee:
            add = add + torch.where(is_lam[:, None],
                                    _nee(sc, emission, p, normal, th, alb, u,
                                         t_min), torch.zeros_like(th))
        radiance = radiance.index_add(0, live, add)

        # Scatter.
        z = 1.0 - 2.0 * u[:, 0]
        r = _safe_sqrt(1.0 - z * z)
        phi = TWO_PI * u[:, 1]
        uv = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
        lam = normal + uv
        lam = torch.where((_dot(lam, lam) < 1e-8)[:, None], normal, lam)
        refl = ud - (2.0 * _dot(ud, normal))[:, None] * normal
        met = refl + fuzz[:, None] * (uv * torch.pow(u[:, 2], 1.0 / 3.0)
                                      [:, None])
        met_ok = _dot(met, normal) > 0.0
        ratio = torch.where(front, 1.0 / ior, ior)
        cos_t = torch.clamp_max(_dot(-ud, normal), 1.0)
        sin_t = _safe_sqrt(1.0 - cos_t * cos_t)
        r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
        must_reflect = (ratio * sin_t > 1.0) | \
            (r0 + (1.0 - r0) * (1.0 - cos_t) ** 5 > u[:, 3])
        perp = ratio[:, None] * (ud + cos_t[:, None] * normal)
        par = -_safe_sqrt(torch.abs(1.0 - _dot(perp, perp)))[:, None] * normal
        die = torch.where(must_reflect[:, None], refl, perp + par)
        nd = torch.where(is_lam[:, None], lam,
                         torch.where(is_met[:, None], met, die))
        att = torch.where((is_die | is_emit)[:, None], torch.ones_like(alb),
                          alb)
        cont = ~is_emit & ~(is_met & ~met_ok)
        th = th * att
        if nee:
            ndu = _unit(nd)
            pdf_next = torch.where(is_lam,
                                   torch.clamp_min(_dot(normal, ndu), 0.0)
                                   * INV_PI, torch.full_like(t, -1.0))
            prev_pdf = prev_pdf.index_copy(0, live, pdf_next.to(dtype))
        if rr_start > 0 and b >= rr_start:
            p_cont = torch.clamp(th.max(dim=-1).values, 0.05, 1.0)
            survive = u[:, 7] < p_cont
            th = torch.where(survive[:, None], th / p_cont[:, None], th)
            cont = cont & survive
        keep = torch.nonzero(cont).squeeze(1)
        live = live[keep]
        o = o.index_copy(0, live, p[keep])
        d = d.index_copy(0, live, nd[keep])
        throughput = throughput.index_copy(0, live, th[keep])
    return radiance


def render_pixels(sc: Scene, cam: Camera, settings: dict, key, pixel,
                  dtype, albedo=None, emission=None, record=None):
    """[P, 3] sum over settings["spp"] samples of the flat pixels pixel,
    rendered with the [2] key words key."""
    w, h = int(settings["width"]), int(settings["height"])
    pix_states = rng.pixel_states(key, pixel)
    acc = None
    for s in range(int(settings["spp"])):
        st = rng.sample_states(pix_states, s)
        o, d = camera_rays(cam, w, h, pixel, st, dtype)
        rad = trace(sc, o, d, st, int(settings["max_depth"]),
                    float(settings.get("t_min", 1e-3)),
                    nee=bool(settings.get("nee", False)),
                    rr_start=int(settings.get("rr_start", 0)),
                    albedo=albedo, emission=emission, record=record)
        acc = rad if acc is None else acc + rad
    return acc
