"""Edge-aware (silhouette) gradients: the screen-space boundary estimator
(counterpart of ``qt_raytracer_tpu.diff.edge``).

The detached-decision pathwise estimator (``diff.inverse``) holds every
discrete decision fixed, so it drops the derivative of the hit indicator:
the Dirac term that lives on silhouette edges. That term is what moves
object and camera parameters across visibility boundaries; without it a
camera-translation gradient sees only interior shading.

The boundary integral (Li et al. 2018 edge sampling; Bangaru et al. 2020
warped-area form), in closed form for the two primitive families:

    d/dtheta int L dA  contains  oint_edges (L_fg - L_bg) v_n dl

where v_n is the normal velocity of the silhouette curve in the image plane.
The hit indicator of the bounce-0 winner is H(g) with an interior function g
that is positive inside the winner's silhouette and zero exactly on it:

    sphere:    g = r^2 - rho^2, rho the distance of the center from the ray
    triangle:  g = min(u, v, 1 - u - v), the barycentric edge margin

Dividing g by its detached screen-space gradient magnitude |grad_px g| gives
a signed distance sd in pixels. Primary samples with 0 < sd <= W lie within
W pixels inside the edge; a one-sided kernel w(sd) of unit integral turns
them into a Monte-Carlo estimate of the edge integral,

    edge ~ sum_samples w(sd) (L_fg - L_bg) d(sd)/dtheta.

L_bg, "what this ray would see if its winner were absent", is one more trace
with the bounce-0 winner excluded, on the same RNG streams (the kernels'
per-lane exclude operand). Excluding only the winning triangle makes the
estimator select itself: at an interior mesh edge the neighbour catches the
excluded ray, L_fg - L_bg ~ 0 and the term vanishes; at a true visibility
boundary the re-trace shows what was hidden. The term enters the sample
radiance in the primal-zero form

    w.detach() * (L_fg - L_bg).detach() * (sd - sd.detach())

which is exactly 0.0 in the forward pass (images are untouched) while its
backward contributes w dL d(sd)/dtheta.

The first-vertex NEE shadow-edge term is the same machinery for the shadow
ray's detached visibility: the shadow boundary on the receiver is a curve in
image space, given by the blocker's interior function along the mirrored NEE
shadow ray through the differentiably re-derived first hit point x1(i, j).
Shadow and silhouette discontinuities seen after a bounce stay unmodelled.

The kernel width W, the kernel order and the shadow term are
``cfg.edge_kernel_px``, ``cfg.edge_kernel_order`` and ``cfg.edge_shadow``.

|grad_px g| is taken in forward mode (``torch.autograd.forward_ad``): each
lane's g depends only on that lane's pixel coordinates, so one dual pass per
coordinate gives every lane's derivative, nothing is saved for a backward
pass, and it runs the same inside ``torch.utils.checkpoint`` and in its
recompute.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwad

from ..core import camera as cam_mod
from ..core import sampling
from ..core import vecmath as vm
from ..core.config import RenderConfig, mesh_search_options
from ..core.integrator import (INV_PI, light_direction, pick_light, trace)
from ..core.scene import LAMBERTIAN, SphereScene
from ..core.world import as_world, intersect_world, world_lights
from ..kernels.fused_hit import BIG, fused_hit, prep_fused_spheres


def _edge_weight(sd_det, w_px: float, order: int):
    """Unit-integral one-sided kernel weight on (0, w_px].

    order 1: w(s) = (2/W)(1 - s/W)              (first moment W/3)
    order 2: 2 w_{W/2}(s) [s <= W/2] - w_W(s)   (first moment 0: cancels
             the O(W) velocity-blur bias, at about 3x the peak magnitude)
    """
    tri = lambda wd: (2.0 / wd) * (1.0 - sd_det / wd)
    if order == 1:
        return tri(w_px)
    half = 0.5 * w_px
    inner = torch.where(sd_det <= half, 2.0 * tri(half), 0.0)
    return inner - tri(w_px)


def _silhouette_g(origins, directions, centers, radii):
    """g = r^2 - rho^2 (rho: distance of the sphere center from the ray
    line): positive strictly inside the silhouette cone, 0 on it."""
    oc = centers - origins
    d2 = vm.length_squared(directions)
    inv_d = torch.where(d2 > 1e-20, 1.0 / vm.safe_sqrt(d2), 0.0)
    along = vm.dot(oc, directions) * inv_d
    perp2 = torch.clamp_min(vm.length_squared(oc) - along * along, 0.0)
    return radii * radii - perp2


def _tri_interior_g(origins, directions, v0, e1, e2):
    """Barycentric edge margin min(u, v, 1 - u - v) of the ray's crossing of
    the (per-ray gathered) winning triangle's plane: positive strictly
    inside the triangle, 0 on its boundary. Differentiable in the ray and
    in the vertices."""
    p = vm.cross(directions, e2)
    det = torch.sum(p * e1, dim=-1)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
    s = origins - v0
    u = torch.sum(s * p, dim=-1) * inv_det
    q = vm.cross(s, e1)
    v = torch.sum(q * directions, dim=-1) * inv_det
    return torch.minimum(torch.minimum(u, v), 1.0 - u - v)


def _grad_px(g_of, i, j):
    """|grad_px g| [N], detached: the per-lane derivatives of g_of(i, j)
    with respect to the lane's own pixel coordinates, one forward-mode pass
    per coordinate. g_of must hold no custom autograd.Function."""
    one = torch.ones_like(i)
    with torch.no_grad(), fwad.dual_level():
        gi = fwad.unpack_dual(g_of(fwad.make_dual(i, one), j)).tangent
        gj = fwad.unpack_dual(g_of(i, fwad.make_dual(j, one))).tangent
        zero = torch.zeros_like(i)
        gi = zero if gi is None else gi
        gj = zero if gj is None else gj
        return vm.safe_sqrt(gi * gi + gj * gj)


def _boundary_term(g_of, i, j, lanes, w_px: float, order: int):
    """(w * (sd - sd.detach()) [N], near [N] bool) of the interior function
    g_of on the candidate lanes: sd = g / |grad_px g| in pixels, near marks
    the lanes within w_px inside the edge, w is the detached kernel
    weight there and 0 elsewhere."""
    g = g_of(i, j)
    grad_px = _grad_px(g_of, i.detach(), j.detach())
    sd = g / torch.clamp_min(grad_px, 1e-20)
    sd_det = sd.detach()
    near = lanes & (sd_det > 0.0) & (sd_det <= w_px) & (grad_px > 1e-12)
    w = torch.where(near, _edge_weight(sd_det, w_px, order), 0.0)
    return w * (sd - sd_det), near


def sample_radiance_edge_aware(scene, camera, cfg: RenderConfig,
                               pix_keys, i, j, sample_idx):
    """core.render._sample_radiance plus the boundary term (primal-zero):
    the same streams and the same forward radiance, [N,3]."""
    from ..core.render import resolve_intersector

    world = as_world(scene)
    ns = world.spheres.num_spheres
    mesh = world.mesh
    samp_keys = sampling.sample_keys(pix_keys, sample_idx)
    gen = sampling.stream_uniforms(samp_keys, sampling.STREAM_GEN,
                                   sampling.UNIFORMS_GEN)
    inv_w = 1.0 / max(cfg.width - 1, 1)
    inv_h = 1.0 / max(cfg.height - 1, 1)
    w_px, order = float(cfg.edge_kernel_px), int(cfg.edge_kernel_order)

    def rays_of(i_f, j_f):
        s = (i_f + gen[:, 0]) * inv_w
        t = (j_f + gen[:, 1]) * inv_h
        return cam_mod.get_rays(camera, s, t, gen[:, 2], gen[:, 3])

    origins, directions = rays_of(i, j)
    o_sg, d_sg = origins.detach(), directions.detach()
    kw = dict(nee=cfg.nee, rr_start=cfg.rr_start)
    mesh_kw = mesh_search_options(cfg)

    # With a fused intersector and a pure sphere scene all three traces take
    # the flat path: l_full through the gradient-capable trace_flat, the
    # bounce-0 winner through the same fused kernel (the same selection),
    # the background re-trace through its exclude operand. Anything else
    # takes the [N,3] integrator, with one intersector for all three and
    # the shadow block so the bounce-0 selection is consistent: "xla" under
    # "xla", else "pallas[_interpret]".
    resolved = resolve_intersector(cfg)
    interp = resolved.endswith("interpret")
    use_fused = isinstance(scene, SphereScene) and resolved.startswith("fused")
    backend = "xla" if resolved == "xla" else \
        "pallas_interpret" if interp else "pallas"

    if use_fused:
        from ..core.integrator_flat import trace_flat

        l_full = trace_flat(scene, origins, directions, samp_keys,
                            cfg.max_depth, cfg.t_min, diff=True,
                            interpret=interp, **kw)
        with torch.no_grad():
            comps = [x[:, k].contiguous() for x in (o_sg, d_sg)
                     for k in range(3)]
            h0f = fused_hit(prep_fused_spheres(scene), *comps,
                            torch.ones_like(comps[0], dtype=torch.bool),
                            cfg.t_min, interpret=interp)
            prim0 = h0f["idx"]
            hit0 = h0f["t"] < BIG
            is_sph = hit0 & (h0f["ff"] > 0)
            is_tri = torch.zeros_like(is_sph)
            p0 = torch.stack([h0f["px"], h0f["py"], h0f["pz"]], dim=1)
            n0 = torch.stack([h0f["nx"], h0f["ny"], h0f["nz"]], dim=1)
            alb0 = torch.stack([h0f["ax"], h0f["ay"], h0f["az"]], dim=1)
            diffuse0 = hit0 & (h0f["mat"] == LAMBERTIAN)
    else:
        l_full = trace(world, origins, directions, samp_keys, cfg.max_depth,
                       cfg.t_min, intersector=backend, **kw, **mesh_kw)
        with torch.no_grad():
            # Bounce-0 winner: selection only.
            h0 = intersect_world(world, o_sg, d_sg, cfg.t_min,
                                 backend=backend, **mesh_kw)
            prim0 = h0.prim_idx
            hit0 = h0.hit
            is_sph = h0.hit & (h0.prim_idx < ns) & h0.front_face
            is_tri = h0.hit & (h0.prim_idx >= ns) & h0.front_face
            p0, n0, alb0 = h0.point, h0.normal, h0.albedo
            diffuse0 = h0.hit & (h0.mat_type == LAMBERTIAN)

    # Differentiable gathers of the winners' geometry (gather_rows: the
    # blocked NEE lanes below gather one of a few blockers).
    if ns:
        widx = torch.clamp(prim0, 0, ns - 1)
        centers = vm.gather_rows(world.spheres.center, widx)
        radii = vm.gather_rows(world.spheres.radius, widx)
    if mesh is not None:
        nt = mesh.num_triangles
        tidx = torch.clamp(prim0 - ns, 0, nt - 1)
        tv0, te1, te2 = (vm.gather_rows(x, tidx)
                         for x in (mesh.v0, mesh.e1, mesh.e2))

    # Signed distance to the winner's silhouette, by family.
    def g_of(i_f, j_f):
        o, d = rays_of(i_f, j_f)
        g = _silhouette_g(o, d, centers, radii) if ns \
            else torch.full_like(i_f, -1.0)
        if mesh is not None:
            g = torch.where(is_tri, _tri_interior_g(o, d, tv0, te1, te2), g)
        return g

    term, near_edge = _boundary_term(g_of, i, j, is_sph | is_tri, w_px,
                                     order)

    # Background radiance: the same rays and streams, the winner excluded
    # at bounce 0.
    with torch.no_grad():
        excl = torch.where(near_edge, prim0, -1).to(torch.int32)
        if use_fused:
            l_bg = trace_flat(scene, o_sg, d_sg, samp_keys, cfg.max_depth,
                              cfg.t_min, interpret=interp,
                              exclude_prim0=excl, **kw)
        else:
            l_bg = trace(world, o_sg, d_sg, samp_keys, cfg.max_depth,
                         cfg.t_min, intersector=backend, exclude_prim0=excl,
                         **kw, **mesh_kw)
        delta = l_full.detach() - l_bg
    edge = term[:, None] * delta

    # --- NEE shadow-edge boundary term (first vertex) -------------------
    # As x1 sweeps across a shadow boundary the direct-light jump
    # contributes no pathwise gradient. The light sample mirrors
    # integrator._nee_mis (STREAM_BOUNCE0 slots 4-6), so the modelled jump
    # is the one l_full's estimator sees; with fg = blocked,
    # L_fg - L_bg = -contrib (throughput 1 at the first vertex).
    lights = world_lights(world) if cfg.nee and cfg.edge_shadow else None
    if lights is not None and lights.n_total > 0:
        u_b0 = sampling.stream_uniforms(samp_keys, sampling.STREAM_BOUNCE0,
                                        sampling.UNIFORMS_PER_BOUNCE)
        u4, u5, u6 = u_b0[:, 4], u_b0[:, 5], u_b0[:, 6]
        row_l, exp_prim, l_is_tri = pick_light(lights, u4)

        with torch.no_grad():
            ldir0, pdf_j, valid_l = light_direction(row_l, l_is_tri, p0, u5,
                                                    u6)
            cos_surf = vm.dot(n0, ldir0)
            cand = diffuse0 & valid_l & (cos_surf > 0.0)
            shadow = intersect_world(world, p0, ldir0, cfg.t_min,
                                     backend=backend, alive=cand, **mesh_kw)
            lit = cand & shadow.hit & (shadow.prim_idx == exp_prim)
            blocked = cand & shadow.hit & ~lit
            denom = pdf_j / lights.n_total + cos_surf * INV_PI
            den_f = torch.where(cand, torch.clamp_min(denom, 1e-30), 1.0)
            factor = torch.where(cand, cos_surf * INV_PI / den_f, 0.0)
            contrib = alb0 * factor[:, None] * row_l[:, 9:12]
            bidx = shadow.prim_idx
            b_tri = blocked & (bidx >= ns)
            # Winner family for the re-derive: unlike is_tri (front faces
            # only, the silhouette term's one-sidedness), the hit point
            # follows the geometric winner for back-face hits too.
            is_tri_fam = (prim0 >= ns) & hit0

        # Blocker geometry (differentiable gathers: geometry recovery sees
        # its own shadow's motion).
        if mesh is not None:
            btidx = torch.clamp(bidx - ns, 0, nt - 1)
            bv0, be1, be2 = (vm.gather_rows(x, btidx)
                             for x in (mesh.v0, mesh.e1, mesh.e2))
        if ns:
            bwidx = torch.clamp(bidx, 0, ns - 1)
            b_c = vm.gather_rows(world.spheres.center, bwidx)
            b_r = vm.gather_rows(world.spheres.radius, bwidx)

        def x1_of(i_f, j_f):
            # The bounce-0 hit point from the detached winner ids (closed
            # forms; no search).
            o, d = rays_of(i_f, j_f)
            if ns:
                oc = o - centers
                a = vm.length_squared(d)
                half_b = vm.dot(oc, d)
                c2t = vm.length_squared(oc) - radii * radii
                disc = torch.clamp_min(half_b * half_b - a * c2t, 0.0)
                sq = vm.safe_sqrt(disc)
                inv_a = 1.0 / torch.clamp_min(a, 1e-20)
                near_t = (-half_b - sq) * inv_a
                far_t = (-half_b + sq) * inv_a
                t_hit = torch.where(near_t >= cfg.t_min, near_t, far_t)
            else:
                t_hit = torch.ones_like(i_f)
            if mesh is not None:
                pv = vm.cross(d, te2)
                dett = vm.dot(pv, te1)
                okd = torch.abs(dett) > 1e-12
                inv_dt = torch.where(okd, 1.0, 0.0) \
                    / torch.where(okd, dett, 1.0)
                qv = vm.cross(o - tv0, te1)
                t_t = vm.dot(qv, te2) * inv_dt
                t_hit = torch.where(is_tri_fam, t_t, t_hit)
            t_hit = torch.where(hit0, torch.clamp_min(t_hit, cfg.t_min), 1.0)
            return o + t_hit[:, None] * d

        def g_sh_of(i_f, j_f):
            x1 = x1_of(i_f, j_f)
            ld, _, _ = light_direction(row_l, l_is_tri, x1, u5, u6)
            g = _silhouette_g(x1, ld, b_c, b_r) if ns \
                else torch.full_like(i_f, -1.0)
            if mesh is not None:
                g = torch.where(b_tri,
                                _tri_interior_g(x1, ld, bv0, be1, be2), g)
            return g

        term2, _ = _boundary_term(g_sh_of, i, j, blocked, w_px, order)
        edge = edge + term2[:, None] * (-contrib)

    return l_full + edge
