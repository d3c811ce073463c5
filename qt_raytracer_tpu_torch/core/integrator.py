"""Wavefront path-tracing integrator on [N, 3] ray state: the gradient path
(counterpart of ``qt_raytracer_tpu.core.integrator``).

A Python loop over bounce depth on SoA ray state with an alive mask.
Intersections go through ``world.intersect_world``: the kernels (A5, and on
mesh worlds A3 with A4 or, by ``mesh_kernel``, A7 and A8; under "xla" the
[N, S] sphere search and the BVH walk) pick the winners, and every hit
quantity is
re-derived differentiably, so autograd reaches scene, mesh and camera
tensors. Every sampling decision is a function of the counter-based
uniforms and is held fixed (pathwise gradients).

Semantics per bounce, for an alive ray:
    miss           -> radiance += throughput * sky(d);        die
    hit, scatter   -> throughput *= attenuation;              continue
    hit, absorbed  -> die
    hit, emissive  -> radiance += throughput * emission * w;  die
    depth exhausted-> contributes 0

Next-event estimation (nee=True): one-sample MIS between light sampling and
BSDF sampling with the balance heuristic, over every emissive sphere and
triangle; the same estimator and uniform slots as the flat integrator.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import materials, sampling, vecmath as vm
from .scene import LAMBERTIAN
from .world import World, WorldLights, as_world, intersect_world, world_lights

INV_PI = 0.3183098861837907


class RayState(NamedTuple):
    origin: torch.Tensor      # [N,3]
    direction: torch.Tensor   # [N,3]
    throughput: torch.Tensor  # [N,3]
    radiance: torch.Tensor    # [N,3]
    alive: torch.Tensor       # [N] bool
    prev_pdf: torch.Tensor    # [N] solid-angle pdf of the bounce that made
    #                           this ray; -1 = camera or specular ray


def _onb(w):
    """Branchless orthonormal basis around unit vector w (Duff et al. 2017)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    sign = torch.where(wz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + wz)
    b = wx * wy * a
    t1 = torch.stack([1.0 + sign * wx * wx * a, sign * b, -sign * wx], dim=-1)
    t2 = torch.stack([b, sign + wy * wy * a, -wy], dim=-1)
    return t1, t2


def _sphere_solid_angle_pdf(center, radius, from_point):
    """Solid-angle pdf of cone sampling a sphere light from a point (0 where
    the sampler could not produce the direction), with the stable
    1 - cos_max = sin2 / (1 + cos_max) form. The masked branches see benign
    denominators, so the backward pass stays finite."""
    to_l = center - from_point
    dist2 = vm.length_squared(to_l)
    outside = dist2 > radius * radius * 1.0001
    sin2 = torch.clamp(radius * radius / torch.clamp_min(dist2, 1e-12),
                       0.0, 1.0)
    cos_max = vm.safe_sqrt(1.0 - sin2)
    omc = sin2 / (1.0 + cos_max)
    ok = outside & (omc > 1e-12)
    den = torch.where(ok, torch.clamp_min(2.0 * math.pi * omc, 1e-30), 1.0)
    pdf = torch.where(ok, 1.0 / den, 0.0)
    return pdf, ok, cos_max, to_l, dist2


def pick_light(lights: WorldLights, u4):
    """The light each lane's slot-4 uniform picks: (its row of the light
    table [N,16], the prim id its shadow ray must hit first, is it a
    triangle)."""
    n_lights = lights.n_total
    pick = torch.clamp((u4 * n_lights).to(torch.int32), 0,
                       n_lights - 1).long()
    row = vm.gather_rows(lights.table, pick)               # [N,16]
    return row, lights.expected_prim[pick], pick >= lights.n_sphere


def _nee_direction(lights: WorldLights, p, u4, u5, u6):
    """The NEE candidate direction and pdf from points p for the slot
    uniforms. Returns (ldir unit, pdf_j, valid, row, exp_prim, is_tri)."""
    row, exp_prim, is_tri = pick_light(lights, u4)
    ldir, pdf_j, valid = light_direction(row, is_tri, p, u5, u6)
    return ldir, pdf_j, valid, row, exp_prim, is_tri


def light_direction(row, is_tri, p, u5, u6):
    """The sample of the picked lights (rows of the light table) from
    points p: (ldir unit, its solid-angle pdf, valid). No gather in here,
    so it is differentiable in p and row in forward mode too."""
    # Sphere light: cone sample.
    lc, lr = row[:, 0:3], row[:, 3]
    pdf_sph, ok_sph, cos_max, _, _ = _sphere_solid_angle_pdf(lc, lr, p)
    w_axis = vm.safe_unit_vector(lc - p)
    cos_a = 1.0 - u5 * (1.0 - cos_max)
    sin_a = vm.safe_sqrt(1.0 - cos_a * cos_a)
    phi = 2.0 * math.pi * u6
    t1, t2 = _onb(w_axis)
    dir_sph = (sin_a * torch.cos(phi))[:, None] * t1 \
        + (sin_a * torch.sin(phi))[:, None] * t2 + cos_a[:, None] * w_axis

    # Triangle light: uniform-area sample.
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    flip = u5 + u6 > 1.0
    bu = torch.where(flip, 1.0 - u5, u5)
    bv = torch.where(flip, 1.0 - u6, u6)
    p_l = v0 + bu[:, None] * e1 + bv[:, None] * e2
    wv = p_l - p
    d2 = vm.length_squared(wv)
    dir_tri = vm.safe_unit_vector(wv)
    cr = vm.cross(e1, e2)
    two_area = vm.safe_sqrt(vm.length_squared(cr))
    area = 0.5 * two_area
    n_l = cr / torch.clamp_min(two_area, 1e-20)[:, None]
    cos_l = torch.abs(vm.dot(n_l, dir_tri))
    ok_tri = (d2 > 1e-12) & (cos_l > 1e-7) & (area > 1e-20)
    den_t = torch.where(ok_tri, torch.clamp_min(cos_l * area, 1e-30), 1.0)
    pdf_tri = torch.where(ok_tri, d2 / den_t, 0.0)

    ldir = torch.where(is_tri[:, None], dir_tri, dir_sph)
    pdf_j = torch.where(is_tri, pdf_tri, pdf_sph)
    valid = torch.where(is_tri, ok_tri, ok_sph)
    return ldir, pdf_j, valid


def _nee_mis(world: World, lights: WorldLights, hits, throughput,
             diffuse_mask, uniforms, t_min, intersector, mesh_kw):
    """One-sample MIS next-event estimation over the unified light table:
    L += T * albedo/pi * cos_surf * Le / (p_j/L + cos_surf/pi) where the
    shadow ray's closest hit is the picked light. Slots 4 (pick), 5 and 6."""
    n_lights = lights.n_total
    u4, u5, u6 = uniforms[:, 4], uniforms[:, 5], uniforms[:, 6]
    ldir, pdf_j, valid, row, exp_prim, _ = _nee_direction(
        lights, hits.point, u4, u5, u6)
    cos_surf = vm.dot(hits.normal, ldir)
    cand = diffuse_mask & valid & (cos_surf > 0.0)

    shadow = intersect_world(world, hits.point, ldir, t_min,
                             backend=intersector, alive=cand, **mesh_kw)
    lit = cand & shadow.hit & (shadow.prim_idx == exp_prim)

    denom = pdf_j / n_lights + cos_surf * INV_PI
    den_f = torch.where(cand, torch.clamp_min(denom, 1e-30), 1.0)
    factor = torch.where(cand, cos_surf * INV_PI / den_f, 0.0)
    contrib = throughput * hits.albedo * factor[:, None] * row[:, 9:12]
    return torch.where(lit[:, None], contrib, 0.0)


def _emitter_mis_weight(world: World, lights: WorldLights, hits, origin,
                        prev_pdf):
    """Balance-heuristic weight of a BSDF-sampled emitter hit: the pdf with
    which NEE would have sampled this direction from the ray's origin."""
    is_sphere = hits.prim_idx < world.spheres.num_spheres
    outward = torch.where(hits.front_face[:, None], hits.normal, -hits.normal)
    center = hits.point - hits.radius[:, None] * outward
    pdf_sph, _, _, _, _ = _sphere_solid_angle_pdf(center, hits.radius, origin)

    wv = hits.point - origin
    d2 = vm.length_squared(wv)
    cos_l = torch.abs(vm.dot(hits.normal, vm.safe_unit_vector(wv)))
    ok_tri = (d2 > 1e-12) & (cos_l > 1e-7) & (hits.area > 1e-20)
    den_t = torch.where(ok_tri, torch.clamp_min(cos_l * hits.area, 1e-30),
                        1.0)
    pdf_tri = torch.where(ok_tri, d2 / den_t, 0.0)

    pdf_nee = torch.where(is_sphere, pdf_sph, pdf_tri) / lights.n_total
    use_mis = prev_pdf > 0.0
    denom = torch.where(use_mis, prev_pdf + pdf_nee, 1.0)
    return torch.where(use_mis, prev_pdf / denom, 1.0)


def sky_color(directions):
    """Vertical white-to-blue gradient on a miss (RayTracer.h:593-595)."""
    t = 0.5 * (vm.safe_unit_vector(directions)[..., 1] + 1.0)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=directions.dtype,
                        device=directions.device)
    return (1.0 - t)[..., None] * 1.0 + t[..., None] * blue


def trace(scene, origins: torch.Tensor, directions: torch.Tensor,
          sample_keys: torch.Tensor, max_depth: int, t_min: float = 1.0e-3,
          intersector: str = "pallas", nee: bool = False, rr_start: int = 0,
          exclude_prim0=None, **mesh_kw) -> torch.Tensor:
    """Trace N rays to completion; returns linear radiance [N,3].

    scene: a SphereScene or a World. sample_keys: [N] hash states or [N,2]
    threefry keys; bounce b reads stream STREAM_BOUNCE0 + b. intersector:
    "pallas" (kernels on CUDA tensors, plain versions on CPU tensors),
    "pallas_interpret" (plain versions) or "xla" (the [N, S] sphere search
    and the BVH walk), for every bounce and shadow ray. nee: MIS next-event
    estimation
    over every light (off when the world has none). rr_start: Russian
    roulette from this bounce on (0 = off; slot 7), unbiased.
    exclude_prim0: optional [N] integer unified prim id left out of the
    bounce-0 intersection only (-1 for none): the background radiance of
    the edge-aware estimator (``diff.edge``), "what this primary ray would
    see if its winner were absent"; later bounces and every NEE shadow ray
    see the whole scene. mesh_kw: the mesh-search options of every
    intersection, the shadow rays' included, as intersect_world takes them
    (mesh_kernel, mesh_pair_c, mesh_sort_mode, mesh_visit, mesh_mt,
    mesh_cluster_rows; config.mesh_search_options)."""
    world = as_world(scene)
    lights = world_lights(world)
    do_nee = bool(nee) and lights.n_total > 0

    zero3 = torch.zeros_like(origins)
    state = RayState(
        origin=origins, direction=directions, throughput=zero3 + 1.0,
        radiance=zero3,
        alive=torch.ones(origins.shape[0], dtype=torch.bool,
                         device=origins.device),
        prev_pdf=zero3[:, 0] - 1.0)

    for depth_idx in range(max_depth):
        hits = intersect_world(
            world, state.origin, state.direction, t_min, backend=intersector,
            alive=state.alive,
            exclude=exclude_prim0 if depth_idx == 0 else None, **mesh_kw)
        uniforms = sampling.stream_uniforms(
            sample_keys, sampling.STREAM_BOUNCE0 + depth_idx,
            sampling.UNIFORMS_PER_BOUNCE)
        sc = materials.scatter(
            hits.mat_type, hits.albedo, hits.fuzz, hits.ior, hits.emission,
            state.direction, hits.normal, hits.front_face, uniforms)

        miss = state.alive & ~hits.hit
        emit_hit = state.alive & hits.hit
        if do_nee:
            emit_w = _emitter_mis_weight(world, lights, hits, state.origin,
                                         state.prev_pdf)
        else:
            emit_w = zero3[:, 0] + 1.0
        radiance = state.radiance + torch.where(
            miss[:, None], state.throughput * sky_color(state.direction), 0.0)
        radiance = radiance + torch.where(
            emit_hit[:, None],
            state.throughput * sc.emitted * emit_w[:, None], 0.0)

        diffuse_hit = state.alive & hits.hit & (hits.mat_type == LAMBERTIAN)
        if do_nee:
            radiance = radiance + _nee_mis(
                world, lights, hits, state.throughput, diffuse_hit, uniforms,
                t_min, intersector, mesh_kw)

        continues = state.alive & hits.hit & sc.ok
        throughput = torch.where(continues[:, None],
                                 state.throughput * sc.attenuation,
                                 state.throughput)
        if rr_start > 0 and depth_idx >= rr_start:
            p_cont = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
            survive = uniforms[:, 7] < p_cont
            throughput = torch.where((continues & survive)[:, None],
                                     throughput / p_cont[:, None], throughput)
            continues = continues & survive
        origin = torch.where(continues[:, None], hits.point, state.origin)
        direction = torch.where(continues[:, None], sc.direction,
                                state.direction)
        prev_pdf = state.prev_pdf
        if do_nee:
            # pdf of the bounce that made the continuing ray: cosine/pi for
            # a diffuse bounce (its next emitter hit is MIS-weighted), -1
            # (full weight) for a specular one.
            cos_next = vm.dot(hits.normal, vm.safe_unit_vector(sc.direction))
            pdf_next = torch.where(diffuse_hit & continues,
                                   torch.clamp_min(cos_next, 0.0) * INV_PI,
                                   -1.0)
            prev_pdf = torch.where(continues, pdf_next, state.prev_pdf)
        state = RayState(origin, direction, throughput, radiance, continues,
                         prev_pdf)
    return state.radiance
