#!/usr/bin/env python3
"""Time the port's kernels, frames and train steps against another
checkout's, on the same inputs, in one process on one CUDA card.

Usage: python3 chip_ab.py OTHER_DIR [--ablation]
           [--parts spheres,mesh,mxu,pairs,a6,boxes,shade,paths]

OTHER_DIR holds another checkout of the repository, for example the parent
commit unpacked by ``git archive <commit> qt_raytracer_tpu_torch | tar -x -C
out/parent`` into a directory that .gitignore lists. Its
``qt_raytracer_tpu_torch`` package is loaded under the name ``qtrt_other``
and builds its own ``csrc/`` into its own ``_build/``. The two packages
are given the same scenes and rays (the same tensors) and each builds its
own kernel tables from them with its own prep functions.

Kernel wavefronts: A1 (full mode), A2 (shadow mode) and A5 (sphere search)
on chunk 0 of the 1080p book-cover frame, primary and after 2 and 5
bounces, A1 also with each ray excluding its own winner; A2 on the
Cornell-mesh NEE shadow rays; A3's VPU and ROWGATE instances on the primary
and bounce-2 wavefronts of chunk 2 of the 1080p terrain, sorted by the
crossing key and unsorted, at clusters of 1, 2 and 4 rows, and with the
exclude operand; A3's MXU instance (A3m) on the same two wavefronts,
sorted and unsorted, and sorted with the exclude operand on the primary
one, with this package's VPU instance (A3) timed beside it on the same
rays; A8 (pair hits, on the slots of this package's crossing
lists) and the whole pair search (``mesh_search_pairs``) on those two
terrain wavefronts, and A8 on a wavefront of the true-Cornell train step
(one cluster of one row); A6 (cluster-culled sphere search) on the primary and
bounce-1 wavefronts of chunk 2 of the 1080p clustered-scene frame
(chip_smoke.py's); A4, its pair variant and A7 (crossing lists, c_max 6)
on the terrain's primary wavefront of chunk 0, its primary wavefront of
chunk 2 as it comes and sorted by the crossing key, its bounce-2 wavefront
of chunk 2 and the true-Cornell step wavefront (one cluster; A7 at its
list width 1). Each pair of kernels must give the same bits on live lanes
and dead lanes (A8: on every slot); then CUDA-event ms in turns (other,
this, this, other).

Shading (``integrator_flat._shade`` without NEE, after the hit query) on
the book-cover wavefronts and the terrain's: this checkout's against the
other's, every output field on every lane bit for bit, CUDA-event ms in
turns (the shading kernel against its plain version, its device time and
its bound are ``chip_smoke.py``'s).

Paths: the 1080p book-cover frame, the 1080p terrain
frame under the default options, under ``mesh_visit="rowgate"`` and under
``mesh_kernel="pairs"``, the 1080p clustered-scene frame, the 512x512
64-spp Cornell-mesh NEE frame, and one config-5 train step on the
sphere Cornell box (4 views at 1080p), pathwise and edge-aware; host
seconds in turns, images and losses equal bit for bit.

With ``--ablation`` OTHER_DIR is a copy with a part of a kernel taken out
on purpose (the exact test, a product, a conversion), timed only: where
its bits differ the script says so and goes on.

Prints the card's name and power limit first and one JSON line per
measurement. Raises without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import statistics
import sys

import torch

from chip_smoke import (C5, C5_SPHERE_LR, C5_SPHERE_POSE_ERR, C5_SPHERE_VIEWS,
                        CORNELL, PAIR_C, SEED, TERRAIN, clustered_scene,
                        clustered_wavefronts, cornell_step_lanes,
                        float_bits, require_card, wall_s)

OTHER = "qtrt_other"
RUNS = 7
ABLATION = False   # --ablation


def load_other(root: pathlib.Path):
    """The other checkout's package, under the name OTHER."""
    pkg = root / "qt_raytracer_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        OTHER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    return mod


def other_module(name: str):
    return importlib.import_module(f"{OTHER}.{name}")


def to_other(obj):
    """obj rebuilt from the other package's class of the same name (data
    classes and named tuples, recursively); tensors are shared."""
    mod = obj.__class__.__module__
    if mod.startswith("qt_raytracer_tpu_torch."):
        cls = getattr(other_module(mod.split(".", 1)[1]),
                      obj.__class__.__name__)
        if dataclasses.is_dataclass(obj):
            return cls(**{f.name: to_other(getattr(obj, f.name))
                          for f in dataclasses.fields(obj) if f.init})
        if hasattr(obj, "_fields"):
            return cls(*map(to_other, obj))
    return obj


def event_ms(fn, runs=RUNS) -> float:
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def in_turns(this_fn, other_fn, timer) -> dict:
    o1, t1, t2, o2 = timer(other_fn), timer(this_fn), timer(this_fn), \
        timer(other_fn)
    return {"this": [t1, t2], "other": [o1, o2],
            "ratio": (t1 + t2) / (o1 + o2)}


def same_bits(a, b, alive, what: str) -> None:
    for x, y in zip(a, b):
        if not (torch.equal(x[..., alive], y[..., alive])
                and torch.equal(x[..., ~alive], y[..., ~alive])):
            if ABLATION:
                print(f"{what}: the two kernels differ (ablation)")
                return
            raise AssertionError(f"{what}: the two kernels differ")


def report(name: str, entry: dict) -> None:
    print(f"{name}: {json.dumps(entry)}", flush=True)


def shade_part(itg, fh, tab, fronts, wt, mesh_fronts, t_min_s, t_min_t):
    """The shading step on the book-cover and terrain wavefronts: this
    checkout's against the other's."""
    o_itg = other_module("core.integrator_flat")
    depth_of = {"primary": 0, "bounce2": 2, "bounce5": 5,
                "primary_chunk2": 0, "bounce2_chunk2": 2}
    cases = [(f"book_cover {k}", s, fh.fused_hit(tab, *(
        s.ox, s.oy, s.oz, s.dx, s.dy, s.dz), s.alive, t_min_s))
        for k, s in fronts.items()]
    cases += [(f"terrain {k}", s, itg._world_hit_flat(
        wt, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.alive, t_min_t, False, 0))
        for k, s in mesh_fronts]
    for label, s, h in cases:
        depth = depth_of[label.split()[1]]
        o_s = to_other(s)
        this = lambda: itg._shade(s, h, depth, 0, 1.0, None)
        other = lambda: o_itg._shade(o_s, h, depth, 0, 1.0, None)
        for name, x, y in zip(itg.RayState._fields, this(), other()):
            if not torch.equal(float_bits(x), float_bits(y)):
                raise AssertionError(f"shade {label}: {name} differs")
        report(f"shade {label}", {"rays": s.ox.shape[0],
                                  "live": int(s.alive.sum()),
                                  **in_turns(this, other, event_ms)})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--ablation", action="store_true",
                    help="OTHER_DIR's kernels have a part taken out on "
                         "purpose and are timed only: differing bits are "
                         "printed, not raised")
    ap.add_argument("--parts",
                    default="spheres,mesh,mxu,pairs,a6,boxes,shade,paths",
                    help="which of spheres, mesh, mxu, pairs, a6, boxes, "
                         "shade and paths to run")
    args = ap.parse_args()
    global ABLATION
    ABLATION = args.ablation
    parts = set(args.parts.split(","))
    dev = require_card()

    from qt_raytracer_tpu_torch import RenderConfig, render_linear, scenes
    from qt_raytracer_tpu_torch.core import integrator_flat as itg
    from qt_raytracer_tpu_torch.core import render as render_mod
    from qt_raytracer_tpu_torch.core import sampling
    from qt_raytracer_tpu_torch.core.scene import LAMBERTIAN
    from qt_raytracer_tpu_torch.kernels import fused_hit as fh
    from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi
    from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    from qt_raytracer_tpu_torch.models import meshes
    from qt_raytracer_tpu_torch.runtime import cuda_build

    load_other(args.other.resolve())
    o_fh = other_module("kernels.fused_hit")
    o_mi = other_module("kernels.mesh_intersect")
    o_si = other_module("kernels.sphere_intersect")
    o_build = other_module("runtime.cuda_build")
    for name, b in (("this", cuda_build), ("other", o_build)):
        b.load_library()
        for line in b.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line:
                print(f"{name} build: {line.strip()}")

    def primary(camera, cfg, spb=1, index=0):
        chunk = render_mod.resolve_pixel_chunk(cfg) or cfg.num_pixels
        part = slice(index * chunk, (index + 1) * chunk)
        i, j, pix = render_mod.pixel_grid(cfg, dev)
        pk = sampling.pixel_states(SEED, pix[part], cfg.rng)
        rep = lambda x: torch.cat([x] * spb)
        ids = torch.arange(spb, dtype=torch.int64,
                           device=dev).repeat_interleave(chunk)
        keys = sampling.sample_keys(rep(pk), ids if spb > 1 else 0)
        o, d = render_mod._camera_rays(camera, cfg, keys, rep(i[part]),
                                       rep(j[part]))
        return itg.initial_state(o, d, keys)

    rays_of = lambda s: (s.ox, s.oy, s.oz, s.dx, s.dy, s.dz)

    # ------------------------------------------------ A1, A2, A5
    cfg = RenderConfig(width=1920, height=1080, spp=1, max_depth=10,
                       rng="hash")
    scene, camera = scenes.get_scene("random", cfg.aspect_ratio)
    cfg_t = RenderConfig(**TERRAIN, rng="hash")
    world, cam_t = scenes.get_scene("terrain", cfg_t.aspect_ratio)
    cfg_c = RenderConfig(**CORNELL, rng="hash")
    world_c, cam_c = scenes.get_scene("cornell_mesh", cfg_c.aspect_ratio)
    tab = fh.prep_fused_spheres(scene)
    stab = si.prep_sphere_search(scene)
    o_scene = to_other(scene)
    o_tab = o_fh.prep_fused_spheres(o_scene)
    o_stab = o_si.prep_sphere_search(o_scene)
    s = primary(camera, cfg)
    fronts = {}
    for depth in range(6):
        if depth in (0, 2, 5):
            fronts["primary" if depth == 0 else f"bounce{depth}"] = s
        s = itg.bounce(tab, s, depth, cfg.t_min)
    for name, s in fronts.items() if "spheres" in parts else ():
        rays, alive = rays_of(s), s.alive
        base = {"rays": rays[0].shape[0], "live": int(alive.sum())}
        first = fh.fused_hit(tab, *rays, alive, cfg.t_min)
        excl = torch.where(alive & (first["t"] < fh.BIG), first["idx"],
                           -1).to(torch.int32)
        cases = {
            "A1": lambda m, t: m.fused_hit(t, *rays, alive, cfg.t_min),
            "A1[exclude]": lambda m, t: m.fused_hit(
                t, *rays, alive, cfg.t_min, exclude=excl),
            "A2": lambda m, t: m.fused_hit(t, *rays, alive, cfg.t_min,
                                           shadow_only=True),
        }
        visits = fh.sweep_gated_plain(tab.spheres, tab.boxes, fh.GROUP_S,
                                      *(x[alive] for x in rays),
                                      cfg.t_min)[2]
        base["slots_per_live_ray"] = float(visits.float().mean()) \
            * fh.GROUP_S if visits.numel() else 0.0
        for kname, run in cases.items():
            a, b = run(fh, tab), run(o_fh, o_tab)
            same_bits([a[k] for k in a], [b[k] for k in a], alive,
                      f"{kname} {name}")
            report(f"{kname} {name}", {**base, **in_turns(
                lambda: run(fh, tab), lambda: run(o_fh, o_tab), event_ms)})
        run5 = lambda m, t: m.sphere_search_flat(t, *rays, alive, cfg.t_min)
        same_bits(run5(si, stab), run5(o_si, o_stab), alive, f"A5 {name}")
        report(f"A5 {name}", {**base, **in_turns(
            lambda: run5(si, stab), lambda: run5(o_si, o_stab), event_ms)})

    # ------------------------------------------------ A3
    wt = itg.prep_world(world)
    t_min = cfg_t.t_min
    s0 = primary(cam_t, cfg_t, index=2)
    s2 = itg.bounce_world(wt, itg.bounce_world(wt, s0, 0, t_min), 1, t_min)
    mesh_fronts = (("primary_chunk2", s0), ("bounce2_chunk2", s2))
    for name, s in mesh_fronts if "mesh" in parts else ():
        rays, alive = rays_of(s), s.alive
        cap = fh.fused_hit(wt.spheres, *rays, alive, t_min)["t"]
        for rows in (4, 2, 1) if name.startswith("bounce") else (4,):
            mc = mi.prep_mesh_clusters(world.mesh, cluster_rows=rows)
            o_mc = o_mi.prep_mesh_clusters(to_other(world.mesh),
                                           cluster_rows=rows)
            perm = mi.crossing_order(mc, *rays, t_min, alive, cap)
            sr = tuple(x[perm] for x in rays)
            sa, sc = alive[perm], cap[perm]
            kern = mi.mesh_hits(mc, *sr, t_min, sa, sc)
            ex = torch.where(sa & (kern[0] < fh.BIG), kern[1],
                             -1).to(torch.int32)
            for visit in ("full", "rowgate"):
                variants = {"sorted": (sr, sa, sc, None),
                            "unsorted": (rays, alive, cap, None)}
                if rows == 4 and name.startswith("primary"):
                    variants["sorted_exclude"] = (sr, sa, sc, ex)
                for vname, (r, a, c, x) in variants.items():
                    run = lambda m, t: m.mesh_hits(t, *r, t_min, a, c,
                                                   visit=visit, exclude=x)
                    same_bits(run(mi, mc), run(o_mi, o_mc), a,
                              f"A3 {visit} {name} {vname}")
                    report(f"A3 {visit} {name} rows {rows} {vname}", {
                        "rays": r[0].shape[0], "live": int(a.sum()),
                        **in_turns(lambda: run(mi, mc),
                                   lambda: run(o_mi, o_mc), event_ms)})

    # ------------------------------------------------ A3m
    if "mxu" in parts:
        mc = mi.prep_mesh_clusters(world.mesh, mt="mxu")
        o_mc = o_mi.prep_mesh_clusters(to_other(world.mesh), mt="mxu")
    for name, s in mesh_fronts if "mxu" in parts else ():
        rays, alive = rays_of(s), s.alive
        cap = fh.fused_hit(wt.spheres, *rays, alive, t_min)["t"]
        perm = mi.crossing_order(mc, *rays, t_min, alive, cap)
        sr = tuple(x[perm] for x in rays)
        sa, sc = alive[perm], cap[perm]
        kern = mi.mesh_hits(mc, *sr, t_min, sa, sc, mt="mxu")
        ex = torch.where(sa & (kern[0] < fh.BIG), kern[1], -1).to(torch.int32)
        variants = {"sorted": (sr, sa, sc, None),
                    "unsorted": (rays, alive, cap, None)}
        if name.startswith("primary"):
            variants["sorted_exclude"] = (sr, sa, sc, ex)
        for vname, (r, a, c, x) in variants.items():
            run = lambda m, t: m.mesh_hits(t, *r, t_min, a, c, mt="mxu",
                                           exclude=x)
            same_bits(run(mi, mc), run(o_mi, o_mc), a, f"A3m {name} {vname}")
            report(f"A3m {name} {vname}", {
                "rays": r[0].shape[0], "live": int(a.sum()),
                **in_turns(lambda: run(mi, mc), lambda: run(o_mi, o_mc),
                           event_ms),
                "a3_ms": event_ms(lambda: mi.mesh_hits(mc, *r, t_min, a, c,
                                                       exclude=x))})

    # ------------------------------------------------ A8, the pair search
    o_mp = other_module("kernels.mesh_pairs")
    for name, s in mesh_fronts if "pairs" in parts else ():
        rays, alive = rays_of(s), s.alive
        cap = fh.fused_hit(wt.spheres, *rays, alive, t_min)["t"]
        mc = wt.mesh
        o_mc = o_mi.prep_mesh_clusters(to_other(world.mesh))
        lists, _ = mp.crossing_lists(mc, *rays, t_min, alive, cap, PAIR_C)
        ray_buf, gmap = mp.pair_slots(lists, mc.k)
        valid = ray_buf >= 0
        run8 = lambda m, t: m.pair_hits(t, *rays, cap, ray_buf, gmap, t_min)
        same_bits(run8(mp, mc), run8(o_mp, o_mc), valid, f"A8 {name}")
        rows = mp.pair_hits_gated_plain(mc, *rays, cap, ray_buf, gmap,
                                        t_min)[2]
        report(f"A8 {name}", {
            "pairs": int(valid.sum()), "slots": int(ray_buf.shape[0]),
            "rows_per_valid_pair": float(rows[valid].float().mean()),
            **in_turns(lambda: run8(mp, mc), lambda: run8(o_mp, o_mc),
                       event_ms)})
        runp = lambda m, t: m.mesh_search_pairs(t, *rays, t_min, alive, cap,
                                                pair_c=PAIR_C)
        same_bits(runp(mp, mc), runp(o_mp, o_mc), alive,
                  f"pair search {name}")
        report(f"pair search {name}", {
            "rays": rays[0].shape[0], "live": int(alive.sum()),
            **in_turns(lambda: runp(mp, mc), lambda: runp(o_mp, o_mc),
                       event_ms)})

    def cornell_step_front():
        """(world, rays, alive, cap, t_min) of a wavefront of the
        true-Cornell train step (chip_smoke.py's: one cluster of one row,
        lists of width 1)."""
        world_s = meshes.cornell_box_world().to(dev)
        cfg5 = RenderConfig(**C5)
        rays = rays_of(primary(meshes.cornell_box_mesh_camera(
            cfg5.aspect_ratio).to(dev), cfg5))
        return (world_s, rays, *cornell_step_lanes(fh, world_s, rays,
                                                   cfg5.t_min), cfg5.t_min)

    if "pairs" in parts:
        # A8 on a wavefront of the true-Cornell train step.
        world_s, rays, alive, cap, t5 = cornell_step_front()
        mc = mi.prep_mesh_clusters(world_s.mesh)
        o_mc = o_mi.prep_mesh_clusters(to_other(world_s.mesh))
        lists, _ = mp.crossing_lists(mc, *rays, t5, alive, cap,
                                     mp.pair_list_width(mc, rays[0].shape[0]))
        ray_buf, gmap = mp.pair_slots(lists, mc.k)
        valid = ray_buf >= 0
        run8 = lambda m, t: m.pair_hits(t, *rays, cap, ray_buf, gmap, t5)
        same_bits(run8(mp, mc), run8(o_mp, o_mc), valid, "A8 cornell_step")
        report("A8 cornell_step", {
            "pairs": int(valid.sum()), "slots": int(ray_buf.shape[0]),
            **in_turns(lambda: run8(mp, mc), lambda: run8(o_mp, o_mc),
                       event_ms)})

    # ------------------------------------------------ A4, A4 pair, A7
    if "boxes" in parts:
        s00 = primary(cam_t, cfg_t, index=0)
        box_fronts = [("primary_chunk0", world.mesh, rays_of(s00), s00.alive,
                       fh.fused_hit(wt.spheres, *rays_of(s00), s00.alive,
                                    t_min)["t"], t_min)]
        for name, s in mesh_fronts:
            cap = fh.fused_hit(wt.spheres, *rays_of(s), s.alive, t_min)["t"]
            box_fronts.append((name, world.mesh, rays_of(s), s.alive, cap,
                               t_min))
            if name == "primary_chunk2":
                perm = mi.crossing_order(wt.mesh, *rays_of(s), t_min,
                                         s.alive, cap)
                box_fronts.append((
                    "primary_chunk2_sorted", world.mesh,
                    tuple(x[perm] for x in rays_of(s)), s.alive[perm],
                    cap[perm], t_min))
        world_s, *front5 = cornell_step_front()
        box_fronts.append(("cornell_step", world_s.mesh, *front5))
        for name, mesh, rays, alive, cap, tm in box_fronts:
            mc = mi.prep_mesh_clusters(mesh)
            o_mc = o_mi.prep_mesh_clusters(to_other(mesh))
            width = min(PAIR_C, mc.k)
            cases = {
                "A4": lambda m, t: (m[0].first_crossed_cluster(
                    t, *rays, tm, alive, cap),),
                "A4[pair]": lambda m, t: m[0].first_crossed_cluster(
                    t, *rays, tm, alive, cap, pair=True),
                "A7": lambda m, t: (lambda lists, ncross: (
                    lists.T, ncross))(*m[1].crossing_lists(
                        t, *rays, tm, alive, cap, width)),
            }
            this, other = (mi, mp), (o_mi, o_mp)
            base = {"rays": rays[0].shape[0], "live": int(alive.sum()),
                    "clusters": mc.k}
            for kname, run in cases.items():
                same_bits(run(this, mc), run(other, o_mc), alive,
                          f"{kname} {name}")
                report(f"{kname} {name}", {**base, **in_turns(
                    lambda: run(this, mc), lambda: run(other, o_mc),
                    event_ms)})

    # ------------------------------------------------ A6
    if "a6" in parts:
        many, cam6, cfg6 = clustered_scene()
        tab6 = si.prep_sphere_search(many)
        o_tab6 = o_si.prep_sphere_search(to_other(many))
        fronts6 = clustered_wavefronts(many, primary(cam6, cfg6, index=2),
                                       cfg6.t_min)
        for name, (rays, alive) in fronts6.items():
            run6 = lambda m, t: m.sphere_search_flat(t, *rays, alive,
                                                     cfg6.t_min)
            same_bits(run6(si, tab6), run6(o_si, o_tab6), alive, f"A6 {name}")
            groups = si.sphere_search_clustered_gated_plain(
                tab6, *rays, alive, cfg6.t_min)[2]
            report(f"A6 {name}", {
                "rays": rays[0].shape[0], "live": int(alive.sum()),
                "groups_per_live_lane": float(groups[alive].float().mean()),
                **in_turns(lambda: run6(si, tab6), lambda: run6(o_si, o_tab6),
                           event_ms)})

    # Cornell-mesh shadow rays (A2) as chip_smoke.py builds them.
    if "spheres" in parts:
        wc = itg.prep_world(world_c)
        s1 = itg.bounce_world(wc, primary(cam_c, cfg_c,
                                          cfg_c.samples_per_batch),
                              0, cfg_c.t_min, nee=True)
        hit = itg._world_hit_flat(wc, *rays_of(s1), s1.alive, cfg_c.t_min,
                                  False)
        uni = sampling.stream_uniforms(s1.keys, sampling.STREAM_BOUNCE0 + 1,
                                       sampling.UNIFORMS_PER_BOUNCE)
        diffuse = s1.alive & (hit["t"] < fh.BIG) & (hit["mat"] == LAMBERTIAN)
        ldx, ldy, ldz, cand, *_ = itg._nee_shadow_rays_world(
            wc.lights, hit["px"], hit["py"], hit["pz"], hit["nx"], hit["ny"],
            hit["nz"], diffuse, uni)
        sh = (hit["px"], hit["py"], hit["pz"], ldx, ldy, ldz)
        o_wc = o_fh.prep_fused_spheres(to_other(world_c.spheres))
        run2 = lambda m, t: m.fused_hit(t, *sh, cand, cfg_c.t_min,
                                        shadow_only=True)
        a, b = run2(fh, wc.spheres), run2(o_fh, o_wc)
        same_bits([a["t"], a["idx"]], [b["t"], b["idx"]], cand,
                  "A2 Cornell")
        report("A2 cornell_shadow", {
            "rays": sh[0].shape[0], "live": int(cand.sum()),
            **in_turns(lambda: run2(fh, wc.spheres),
                       lambda: run2(o_fh, o_wc), event_ms)})
    if "shade" in parts:
        shade_part(itg, fh, tab, fronts, wt, mesh_fronts, cfg.t_min, t_min)
    if "paths" not in parts:
        return

    # ------------------------------------------------ paths
    o_render = other_module("core.render")
    o_cfg = other_module("core.config")

    def frame_pair(label, scene_, cam_, cfg_):
        o_scene, o_cam = to_other(scene_), to_other(cam_)
        o_c = o_cfg.RenderConfig(**dataclasses.asdict(cfg_))
        this = lambda: render_linear(scene_, cam_, cfg_, SEED)
        other = lambda: o_render.render_linear(o_scene, o_cam, o_c, SEED)
        if not torch.equal(this(), other()):
            raise AssertionError(f"{label}: the frames differ")
        timer = lambda fn: statistics.median(wall_s(fn)[1] for _ in range(3))
        report(f"frame {label}", in_turns(this, other, timer))

    frame_pair("book_cover_1080p", scene, camera, cfg)
    frame_pair("terrain_1080p", world, cam_t, cfg_t)
    frame_pair("terrain_1080p_rowgate", world, cam_t,
               dataclasses.replace(cfg_t, mesh_visit="rowgate"))
    frame_pair("terrain_1080p_pairs", world, cam_t,
               dataclasses.replace(cfg_t, mesh_kernel="pairs"))
    frame_pair("clustered_1080p", *clustered_scene())
    frame_pair("cornell_mesh_nee", world_c, cam_c, cfg_c)

    from qt_raytracer_tpu_torch.diff import inverse as inv
    from qt_raytracer_tpu_torch.diff import multiview as mv
    o_inv, o_mv = other_module("diff.inverse"), other_module("diff.multiview")
    cfg5 = RenderConfig(**C5)
    sph = scenes.cornell_box_spheres().to(dev)
    cam5 = scenes.cornell_box_camera(cfg5.aspect_ratio).to(dev)
    true_cams = mv.orbit_cameras(cam5, C5_SPHERE_VIEWS)
    key = sampling.prng_key(7, dev)
    targets = torch.stack([inv.mean_image(sph, c, cfg5,
                                          sampling.fold_in(key, v))
                           for v, c in enumerate(true_cams)])
    albedo = sph.albedo.clone()
    albedo[6] = torch.tensor([0.2, 0.6, 0.8], device=dev)
    wrong = dataclasses.replace(sph, albedo=albedo)
    pose = torch.tensor(C5_SPHERE_POSE_ERR, device=dev)
    start = tuple(inv.translate_camera(c, pose) for c in true_cams)
    for edge in (False, True):
        steps = {}
        for label, m_mv, m_inv, sc_, st_, c_ in (
                ("this", mv, inv, wrong, start, cfg5),
                ("other", o_mv, o_inv, to_other(wrong),
                 tuple(to_other(c) for c in start),
                 o_cfg.RenderConfig(**dataclasses.asdict(cfg5)))):
            init, step, _, _ = m_mv.make_multiview_train_step(
                sc_, st_, c_, m_inv.adam(C5_SPHERE_LR),
                trainable=("albedo", "emission"), train_camera="pose",
                edge_aware=edge)
            steps[label] = (init, step)
        losses = {}

        def run(label):
            init, step = steps[label]
            (_, loss), sec = wall_s(lambda: step(init(), targets, key))
            losses.setdefault(label, float(loss))
            return sec
        res = in_turns(lambda: run("this"), lambda: run("other"),
                       lambda fn: fn())
        if losses["this"] != losses["other"]:
            raise AssertionError(f"config-5 step losses differ: {losses}")
        report(f"config5 sphere step {'edge_aware' if edge else 'pathwise'}",
               {**res, "loss": losses["this"]})


if __name__ == "__main__":
    main()
