"""Command-line interface: render / preview / interactive / bench / invert
(counterpart of ``qt_raytracer_tpu.app.cli``).

Replaces the reference's app shell + QML control panel (src/app/main.cpp,
resources/qml/Main.qml): the CLI flags map 1:1 to the panel's controls
(width/height/samples/depth/scene, AA presets Main.qml:91-102), with the
JAX CLI's flags and defaults. One flag differs: ``--device {cuda,cpu}``
(default ``cuda``) takes the place of the JAX CLI's ``--backend``. There is
no fallback: when CUDA is asked for and absent, the command exits non-zero
with a message naming CUDA; the CPU runs only when ``--device cpu`` asks for
it. The CUDA kernels build with nvcc on first use into the package's
``_build/`` directory, which also caches them between runs.

Usage:
    python -m qt_raytracer_tpu_torch.app.cli render --scene random \\
        --width 400 --height 225 --spp 24 --out out.png
    python -m qt_raytracer_tpu_torch.app.cli render --progressive \\
        --checkpoint ck.pt --scene cornell --nee ...
    python -m qt_raytracer_tpu_torch.app.cli bench --scene random
    python -m qt_raytracer_tpu_torch.app.cli invert --steps 60
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ..core.config import AA_PRESETS, RenderConfig
from ..core.sampling import fold_in, prng_key
from ..runtime.device import resolve_device
from .png import write_png
from .stats import RenderStats, Timer, synchronize


def _build_cfg(args) -> RenderConfig:
    spp = AA_PRESETS[args.aa] if args.aa else args.spp
    return RenderConfig(
        width=args.width, height=args.height, spp=spp,
        max_depth=args.depth, nee=args.nee, quantizer=args.quantizer,
        samples_per_batch=args.samples_per_batch,
        pixel_chunk=args.pixel_chunk,
    )


def _get_scene(args, cfg, device):
    from ..models import scenes

    return scenes.get_scene(args.scene, cfg.aspect_ratio, device=device)


def cmd_render(args, device: torch.device) -> int:
    cfg = _build_cfg(args)
    scene, camera = _get_scene(args, cfg, device)

    timer = Timer()
    if args.progressive:
        from .progressive import ProgressiveRenderer

        pr = ProgressiveRenderer(scene, camera, cfg, seed=args.seed)
        if args.resume and args.checkpoint:
            pr.load(args.checkpoint)
            print(f"resumed at {pr.frame_index} spp", file=sys.stderr)
        frames = 0
        try:
            while pr.frame_index < cfg.spp:
                todo = min(args.batch, cfg.spp - pr.frame_index)
                pr.step(todo)
                frames += 1
                print(f"progress {pr.progress:5.1f}% "
                      f"({pr.frame_index}/{cfg.spp} spp)", file=sys.stderr)
                if args.checkpoint:
                    pr.save(args.checkpoint)
        except KeyboardInterrupt:
            # stopRender analog (RayTracerFboItem.cpp:334-348): stop cleanly,
            # keep the partial accumulation; --resume continues it.
            if args.checkpoint:
                pr.save(args.checkpoint)
                print(f"\ninterrupted at {pr.frame_index}/{cfg.spp} spp; "
                      f"checkpoint saved to {args.checkpoint} (resume with "
                      f"--resume)", file=sys.stderr)
            else:
                print(f"\ninterrupted at {pr.frame_index}/{cfg.spp} spp",
                      file=sys.stderr)
        img = pr.image()
        synchronize(device)
        stats = RenderStats(cfg.width, cfg.height, pr.frame_index,
                            cfg.max_depth, timer.elapsed_s, frames=frames,
                            backend=device.type)
    else:
        from ..core.render import render

        img = render(scene, camera, cfg,
                     prng_key(args.seed, device)).cpu().numpy()
        synchronize(device)
        stats = RenderStats(cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                            timer.elapsed_s, backend=device.type)

    if args.out:
        write_png(args.out, img)
        print(f"wrote {args.out}", file=sys.stderr)
    print(stats.text())
    return 0


def cmd_preview(args, device: torch.device) -> int:
    cfg = _build_cfg(args)
    scene, camera = _get_scene(args, cfg, device)
    from .preview import run_preview

    run_preview(scene, camera, cfg, seed=args.seed, batch=args.batch,
                out_path=args.out, ansi=args.ansi, ansi_cols=args.ansi_cols)
    return 0


def cmd_interactive(args, device: torch.device) -> int:
    cfg = _build_cfg(args)
    scene, camera = _get_scene(args, cfg, device)
    from .interactive import run_interactive

    return run_interactive(scene, camera, cfg, seed=args.seed,
                           batch=args.batch, ansi_cols=args.ansi_cols)


def cmd_bench(args, device: torch.device) -> int:
    cfg = _build_cfg(args)
    scene, camera = _get_scene(args, cfg, device)
    from ..core.render import render_linear

    key = prng_key(args.seed, device)
    render_linear(scene, camera, cfg, key)
    synchronize(device)              # kernel build + warm-up
    timer = Timer()
    for it in range(args.iters):
        render_linear(scene, camera, cfg, fold_in(key, it))
    synchronize(device)
    stats = RenderStats(cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                        timer.elapsed_s / args.iters, backend=device.type)
    print(json.dumps({
        "scene": args.scene, "width": cfg.width, "height": cfg.height,
        "spp": cfg.spp, "depth": cfg.max_depth, "nee": cfg.nee,
        "msamples_per_s": round(stats.msamples_per_s, 3),
        "elapsed_s": round(stats.elapsed_s, 4), "backend": device.type,
    }))
    return 0


def invert_config(args) -> RenderConfig:
    """The render settings of ``invert``."""
    return RenderConfig(width=args.width, height=args.height, spp=args.spp,
                        max_depth=args.depth)


def invert_problem(args, cfg: RenderConfig, device: torch.device):
    """What ``invert`` trains: (true scene, true camera, key, target image,
    and make_train_step's init_state, step_fn and rebuild_cam), rendered
    with cfg (``invert_config(args)``, or the same on another route)."""
    from ..diff.inverse import adam, make_train_step, mean_image
    from ..models import scenes

    true_scene, camera = scenes.get_scene(args.scene, cfg.aspect_ratio,
                                          device=device)
    key = prng_key(args.seed, device)
    target = mean_image(true_scene, camera, cfg, key)

    albedo = true_scene.albedo.clone()
    albedo[1] = torch.tensor([0.9, 0.1, 0.5], dtype=albedo.dtype,
                             device=device)
    wrong = dataclasses.replace(true_scene, albedo=albedo)
    start_cam = camera
    if args.train_camera:
        delta = torch.tensor([0.15, -0.1, 0.1], dtype=torch.float32,
                             device=device)
        start_cam = dataclasses.replace(
            camera, origin=camera.origin + delta,
            lower_left_corner=camera.lower_left_corner + delta)
    if args.train_camera and not args.edge_aware:
        # Without silhouette gradients, camera parameters need a far gentler
        # step than albedo: the pathwise estimator sees only noisy
        # interior-shading signals. --edge-aware removes the crutch (the
        # boundary term restores the real camera gradient).
        optimizer = adam({"scene/albedo": args.lr,
                          "camera/translate": args.lr * 0.05})
    else:
        optimizer = adam(args.lr)
    init_state, step_fn, _, rebuild_cam = make_train_step(
        wrong, start_cam, cfg, optimizer, trainable=("albedo",),
        train_camera="pose" if args.train_camera else False,
        edge_aware=args.edge_aware, loss=args.loss)
    return true_scene, camera, key, target, init_state, step_fn, rebuild_cam


def cmd_invert(args, device: torch.device) -> int:
    """Inverse-rendering demo: perturb a sphere albedo, recover it
    (BASELINE config 5, single-card variant)."""
    from ..diff.inverse import load_train_state, save_train_state

    (true_scene, camera, key, target, init_state, step_fn,
     rebuild_cam) = invert_problem(args, invert_config(args), device)
    state = init_state()
    if args.resume and args.checkpoint:
        state = load_train_state(args.checkpoint, state)
        print(f"resumed at step {int(state.step)}", file=sys.stderr)
    try:
        for it in range(int(state.step), args.steps):
            state, loss = step_fn(state, target, fold_in(key, it + 1))
            if it % 10 == 0 or it == args.steps - 1:
                print(f"step {it:4d} loss {float(loss):.6f}")
            if args.checkpoint and (it + 1) % args.checkpoint_every == 0:
                save_train_state(args.checkpoint, state)
    except KeyboardInterrupt:
        if args.checkpoint:
            save_train_state(args.checkpoint, state)
            print(f"\ninterrupted at step {int(state.step)}; optimizer state "
                  f"saved to {args.checkpoint} (resume with --resume)",
                  file=sys.stderr)
            return 130
        raise
    if args.checkpoint:
        save_train_state(args.checkpoint, state)
    rec = state.params["scene"]["albedo"][1].detach().cpu().numpy()
    true = true_scene.albedo[1].cpu().numpy()
    print(f"recovered albedo {rec.round(3).tolist()} "
          f"(true {true.round(3).tolist()}, "
          f"max err {abs(rec - true).max():.4f})")
    if args.train_camera:
        rec_o = rebuild_cam(state.params).origin.detach().cpu().numpy()
        true_o = camera.origin.cpu().numpy()
        print(f"recovered camera origin {rec_o.round(3).tolist()} "
              f"(true {true_o.round(3).tolist()}, "
              f"err {abs(rec_o - true_o).max():.4f})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qt_raytracer_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    from ..models.scenes import MESH_SCENES, SCENES
    scene_choices = sorted(SCENES) + sorted(MESH_SCENES)

    def common(sp):
        # Defaults = the reference QML panel (Main.qml:10-13). Every
        # registered scene is renderable from the CLI, mirroring the
        # reference exposing all backend scenes (Main.qml:18-19).
        sp.add_argument("--scene", default="random", choices=scene_choices)
        sp.add_argument("--width", type=int, default=400)
        sp.add_argument("--height", type=int, default=225)
        sp.add_argument("--spp", type=int, default=24)
        sp.add_argument("--aa", choices=sorted(AA_PRESETS),
                        help="AA preset overriding --spp (low=8/medium=24/high=64)")
        sp.add_argument("--depth", type=int, default=10)
        sp.add_argument("--nee", action="store_true",
                        help="next-event estimation (direct light sampling)")
        sp.add_argument("--quantizer", default="cpu", choices=["cpu", "gpu"])
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to render: the CUDA card (default; "
                             "exits with an error when there is none) or, "
                             "when asked, the CPU")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--samples-per-batch", type=int, default=1)
        sp.add_argument("--pixel-chunk", type=int, default=0)

    pr = sub.add_parser("render", help="render a scene to PNG")
    common(pr)
    pr.add_argument("--out", default="out.png")
    pr.add_argument("--progressive", action="store_true")
    pr.add_argument("--batch", type=int, default=1,
                    help="spp per progressive step")
    pr.add_argument("--checkpoint",
                    help="checkpoint file (torch.save) for save/resume")
    pr.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint; orbax checkpoint "
                         "directories of the JAX CLI are not read")
    pr.set_defaults(fn=cmd_render)

    pv = sub.add_parser("preview", help="progressive live preview (PNG/ANSI)")
    common(pv)
    pv.add_argument("--out", default="preview.png")
    pv.add_argument("--batch", type=int, default=1)
    pv.add_argument("--ansi", action="store_true",
                    help="render into the terminal (truecolor half-blocks)")
    pv.add_argument("--ansi-cols", type=int, default=80)
    pv.set_defaults(fn=cmd_preview)

    pi2 = sub.add_parser(
        "interactive",
        help="fly the camera in the terminal (progressive ANSI viewport)")
    common(pi2)
    pi2.add_argument("--batch", type=int, default=1,
                     help="spp per refinement step")
    pi2.add_argument("--ansi-cols", type=int, default=100)
    pi2.set_defaults(fn=cmd_interactive)

    pb = sub.add_parser("bench", help="timed render, one JSON line")
    common(pb)
    pb.add_argument("--iters", type=int, default=3)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("invert", help="inverse-rendering demo")
    common(pi)
    pi.add_argument("--steps", type=int, default=60)
    pi.add_argument("--lr", type=float, default=5e-2)
    pi.add_argument("--train-camera", action="store_true",
                    help="also recover a perturbed camera origin")
    pi.add_argument("--edge-aware", action="store_true",
                    help="silhouette (visibility) gradients — full-strength "
                         "camera recovery, ~2x trace cost")
    pi.add_argument("--checkpoint",
                    help="file (torch.save) for optimizer-state save/resume")
    pi.add_argument("--resume", action="store_true",
                    help="restore optimizer state from --checkpoint; orbax "
                         "checkpoint directories of the JAX CLI are not "
                         "read")
    pi.add_argument("--checkpoint-every", type=int, default=10)
    pi.add_argument("--loss", default="l2", choices=["l2", "dual"],
                    help="image loss: fixed-key L2 or the dual-buffer "
                         "debiased product loss (kills the fixed-key "
                         "noise-fit floor at equal cost)")
    pi.set_defaults(fn=cmd_invert)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    return args.fn(args, device)


if __name__ == "__main__":
    raise SystemExit(main())
