#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qt_raytracer_tpu_torch) on one CUDA card.

Usage: python3 chip_smoke.py      (from the root of the repository)

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, then drives the
port's main path once through ``render_linear``: the 1920x1080, 1 spp,
depth-10 book-cover frame with the hash RNG, 5 chunks of 414,720 rays, one
fused-hit launch per chunk and bounce. Every phase raises on failure, so the
script exits non-zero; without CUDA it raises before printing any result.

Output: the card's name and power limit (nvidia-smi), per-phase numbers, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

WIDTH, HEIGHT, DEPTH, SEED = 1920, 1080, 10, 0
T_RTOL = 1e-5                 # refined t of agreeing live lanes
OUT_ATOL = OUT_RTOL = 1e-5    # every other float output
IDX_AGREE_MIN = 0.9999        # live lanes whose winner ids agree
IMG_ATOL = IMG_RTOL = 2e-3    # frame vs plain frame, per channel
IMG_MISMATCH_MAX = 0.01
TIMED_RUNS = 7


def phase(name):
    print(f"== {name}", flush=True)


def require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port's smoke run needs "
                           "a CUDA card")
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"need compute capability (9, 0) for sm_90a, "
                           f"got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(dev)}")
    return dev


def cuda_ms(fn, runs=TIMED_RUNS) -> float:
    """Median milliseconds of fn() on the current stream, after a warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_hits(fh, kern: dict, plain: dict, alive: torch.Tensor) -> dict:
    """Agreement of the kernel's outputs with the plain version's."""
    idx_eq = kern["idx"] == plain["idx"]
    agree = alive & idx_eq
    live = int(alive.sum())
    stats = {"live": live,
             "idx_agree": float(agree.sum()) / max(live, 1)}
    for k in ("mat", "ff"):
        if not torch.equal(kern[k][agree], plain[k][agree]):
            raise AssertionError(f"{k} differs on lanes with equal winners")
    hit = agree & (plain["t"] < fh.BIG)
    max_err, bitwise, worst = 0.0, True, 0.0
    for k in fh.FLOAT_NAMES:
        lanes = hit if k == "t" else agree
        a, b = kern[k][lanes].double(), plain[k][lanes].double()
        err = (a - b).abs()
        if k == "t":
            bound = T_RTOL * b.abs()
        else:
            bound = OUT_ATOL + OUT_RTOL * b.abs()
        if err.numel():
            max_err = max(max_err, float(err.max()))
            worst = max(worst, float((err / bound.clamp_min(1e-30)).max()))
        bitwise &= torch.equal(kern[k][agree], plain[k][agree])
    dead = ~alive
    for k in fh.NAMES:
        if not torch.equal(kern[k][dead], plain[k][dead]):
            raise AssertionError(f"dead-lane defaults differ in {k}")
    stats.update(max_abs_err=max_err, worst_err_over_tol=worst,
                 bitwise=bool(bitwise), hits=int(hit.sum()))
    if stats["idx_agree"] < IDX_AGREE_MIN or worst > 1.0:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{stats}")
    return stats


def main() -> None:
    dev = require_card()

    from qt_raytracer_tpu_torch import RenderConfig, render_linear, scenes
    from qt_raytracer_tpu_torch.core import render as render_mod
    from qt_raytracer_tpu_torch.core import sampling
    from qt_raytracer_tpu_torch.core.integrator_flat import bounce, initial_state
    from qt_raytracer_tpu_torch.kernels import fused_hit as fh
    from qt_raytracer_tpu_torch.runtime import cuda_build

    phase("build")
    t0 = time.perf_counter()
    lib = cuda_build.load_library()
    print(f"built and loaded {cuda_build.library_path().name} in "
          f"{time.perf_counter() - t0:.3f} s ({lib._name})")

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1, max_depth=DEPTH,
                       rng="hash")
    scene, camera = scenes.get_scene("random", cfg.aspect_ratio)
    scene, camera = scene.to(dev), camera.to(dev)

    phase("kernel vs plain version")
    tables = fh.prep_fused_spheres(scene)
    chunk = render_mod.resolve_pixel_chunk(cfg)
    i, j, pix = render_mod.pixel_grid(cfg, dev)
    keys = sampling.sample_keys(
        sampling.pixel_states(SEED, pix[:chunk], cfg.rng), 0)
    origins, directions = render_mod._camera_rays(camera, cfg, keys,
                                                  i[:chunk], j[:chunk])
    primary = initial_state(origins, directions, keys)
    bounced = primary
    for depth_idx in range(3):
        bounced = bounce(tables, bounced, depth_idx, cfg.t_min,
                         interpret=True)
    wavefronts = {"primary_chunk0": primary, "bounce3": bounced}
    kernel_stats = {}
    for name, s in wavefronts.items():
        args = (tables, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.alive,
                cfg.t_min)
        kern = fh.fused_hit(*args)
        plain = fh.fused_hit_plain(*args)
        torch.cuda.synchronize()
        st = compare_hits(fh, kern, plain, s.alive)
        # In turns, on the same card and inputs.
        st["ms"] = cuda_ms(lambda: fh.fused_hit(*args))
        st["plain_ms"] = cuda_ms(lambda: fh.fused_hit_plain(*args))
        st["rays"] = s.ox.shape[0]
        kernel_stats[name] = st
        print(f"{name}: {json.dumps(st)}", flush=True)

    phase("1080p frame through render_linear")
    fh.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_linear(scene, camera, cfg, SEED)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fh.launches
    expected = -(-cfg.num_pixels // chunk) * DEPTH
    if launches != expected:
        raise AssertionError(f"fused_hit launched {launches} times in the "
                             f"frame, expected {expected}")
    if img.shape != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("frame is not a finite [1080, 1920, 3] image")
    steady = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_linear(scene, camera, cfg, SEED)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
    frame_s = statistics.median(steady)

    plain_cfg = dataclasses.replace(cfg, intersector="fused_interpret")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = render_linear(scene, camera, plain_cfg, SEED)
    torch.cuda.synchronize()
    plain_frame_s = time.perf_counter() - t0
    mismatch = ((img - ref).abs() > IMG_ATOL + IMG_RTOL * ref.abs())
    frame = {
        "launches": launches, "first_s": first_s, "steady_s": frame_s,
        "msamples_per_s": cfg.num_pixels * cfg.spp / frame_s / 1e6,
        "plain_frame_s": plain_frame_s,
        "mismatch_frac": float(mismatch.float().mean()),
        "bitwise_frac": float((img == ref).float().mean()),
        "mean": float(img.mean()),
    }
    print(f"frame: {json.dumps(frame)}", flush=True)
    if frame["mismatch_frac"] > IMG_MISMATCH_MAX:
        raise AssertionError(f"frame differs from the plain frame: {frame}")

    phase("small frame on the card vs the CPU")
    small = RenderConfig(width=64, height=36, spp=2, max_depth=6, rng="hash")
    s_cpu, c_cpu = scenes.get_scene("random", small.aspect_ratio)
    on_card = render_linear(s_cpu.to(dev), c_cpu.to(dev), small, SEED).cpu()
    on_cpu = render_linear(s_cpu, c_cpu, small, SEED)
    bad = ((on_card - on_cpu).abs() > IMG_ATOL + IMG_RTOL * on_cpu.abs())
    print(f"card vs cpu mismatch_frac {float(bad.float().mean())}")
    if float(bad.float().mean()) > IMG_MISMATCH_MAX:
        raise AssertionError("card render disagrees with the CPU render")

    a = kernel_stats["primary_chunk0"]
    print(json.dumps({"kernels": [{
        "name": "fused_hit",
        "route": "cuda",
        "source": "qt_raytracer_tpu_torch/csrc/fused_hit.cu",
        "replaces": "qt_raytracer_tpu/kernels/fused_hit.py:50",
        "launches": launches,
        "max_abs_err": max(st["max_abs_err"] for st in kernel_stats.values()),
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
