#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qt_raytracer_tpu_torch) on one CUDA card.

Usage: python3 chip_smoke.py      (from the root of the repository)

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, then drives the
port's paths through ``render_linear``, each with the kernels' launch
counts set to 0 just before it and read just after:

  - the sphere path: the 1920x1080, 1 spp, depth-10 book-cover frame (5
    chunks of 414,720 rays, one fused-hit launch per chunk and bounce);
  - the mesh-world path: the ~100k-triangle terrain (BASELINE config 4),
    1920x1080, 1 spp, depth 5 (fused hit, first crossed cluster and mesh
    search once per chunk and bounce); then the same frame with the
    pair-wavefront mesh search (``mesh_kernel="hybrid"`` and ``"pairs"``:
    crossing lists and pair hits, with the clustered search as the overflow
    fallback), with ``mesh_compact=True``, the row-gated mesh search
    (``mesh_visit="rowgate"``) and clusters of one 128-triangle row
    (``mesh_cluster_rows=1``), each bit-identical to it, and with the
    bilinear-form Moller-Trumbore (``mesh_mt="mxu"``) within the flip
    budget of it;
  - the mesh-world path with next-event estimation: the true Cornell box
    (BASELINE config 2), 512x512, 64 spp, depth 10 (fused hit, shadow-mode
    fused hit and two mesh searches per chunk, sample batch and bounce);
  - a sphere scene of 1,061 random spheres in 1,152 slots, 1920x1080, 1
    spp, depth 10, through the [N,3] integrator (``intersector="pallas"``):
    the cluster-culled sphere search once per chunk and bounce;
  - the gradient path, BASELINE config 5 (1920x1080, 2 spp, depth 4, NEE)
    through ``diff.multiview``: multi-view train steps on the sphere
    Cornell box (4 views; albedo, emission and pose) and per-view train
    steps on the true Cornell box (2 views; pose), one step of each with
    the pathwise estimator and two with the edge-aware one
    (``edge_aware=True``: the boundary term of ``diff.edge``, whose
    background re-trace runs the kernels' exclude operands), with a
    view-step's gradients held against the plain versions' on the card and
    against the CPU; and one pathwise step on the true Cornell box with
    ``mesh_kernel="pairs"``, whose loss equals the clustered step's (its
    crossing-list and pair kernels held against their plain versions on
    one of its wavefronts: one cluster, lists of width 1);
  - the app layer, through the entry points a user calls: ``python -m
    qt_raytracer_tpu_torch.app.cli bench`` at the book-cover frame's size
    in its own process; the reference panel's progressive render (400x225,
    24 spp in steps of 4, a checkpoint at 12 spp resumed into a renderer
    built with another seed), against the batch render within 1e-5, and
    bit for bit in 1-spp steps; ``cli render`` of the terrain and of the
    sphere Cornell box with NEE, each PNG the bytes of ``render``'s image;
    and ``cli invert --steps 2`` (finite losses);
  - the portable route, ``intersector="xla"`` (the [N, S] sphere search in
    PyTorch ops and the BVH walk kernel): the terrain and book-cover 1080p
    frames, each against the default route's frame by the flip budget
    (the walk and the clustered search break ties otherwise), and one
    config-5 view-step on the true Cornell box, pathwise and edge-aware
    (the walk's exclude instance in the background re-trace), against the
    default route's view-step, the walk with and without exclude then
    held bit for bit against its plain version on the background
    re-trace's own wavefront, captured from that step; before them the walk against its plain
    version on two terrain wavefronts (with dead lanes, an excluded
    winner on a tenth of the lanes, a finite t_max), timed beside the
    clustered search (A3) on the same rays; after them a 96x64
    Cornell-mesh NEE frame on the card against the port's f64 vector
    oracle;
  - the sharded render and training (``parallel/``): the book-cover frame
    through ``render_linear_sharded`` over a world of one on NCCL, bit for
    bit ``render_linear``'s; then two ranks spawned on the one card over
    gloo (NCCL refuses two ranks on one GPU; the ranks share the card, so
    no scaling is measured): the frame at (sp, px) = (1, 2) bit for bit,
    at spp 2 over (2, 1) within 3e-7, the terrain 1080p frame at (1, 2)
    bit for bit the single-process terrain frame (A1, A4, A3 on a rank's
    pixel range), the three parts of the JAX package's
    ``dryrun_multichip`` (a three-sphere step, a true-Cornell NEE pose
    step, a terrain forward) held against the same parts in one process on
    the kernels and on the plain route, and a 1080p config-5 view-step over
    (1, 2) whose loss equals the single-process step's, whose gradients lie
    within 1e-4 x max|g| of it, and whose parameters are equal on both
    ranks.

The differentiable bounce (``kernels/diff_bounce.py``: F1, F2 forward, B
backward, counted ``diff_bounce[shadow_rays]``, ``diff_bounce`` and
``diff_bounce[backward]``) is held against the PyTorch route of
``bounce(diff=True)`` on config 5's chunk-2 wavefront (414,720 lanes):
the new carry bit for bit, the gradients within 1e-4 of the largest
input's norm, two backward calls bit for bit; each kernel's device ms
beside its bound and ptxas's registers and spills; and it launches on
every bounce of every gradient step on a sphere scene with hash keys.

The shading kernel (``shade_kernel``, a bounce's shading without NEE in
one launch) is held bit for bit against its plain version,
``integrator_flat._shade_plain``, on every output field and lane of the
book-cover primary and bounce-2 wavefronts of chunk 0 and the terrain's of
chunk 2 (414,720 lanes each; the bounce-2 ones also with Russian roulette
on), and launches once per chunk and bounce of every frame without NEE.

Before the frames, the mesh search's row-gated and bilinear-form instances
are held against their plain versions and against the default instance on
the terrain's sorted wavefronts, with and without the exclude operand; the
bilinear-form instance (A3m: blocks of 64 rays, a TF32 filter on the tensor
cores, an exact re-test) also against the gated exact sweep
(``mesh_search_gated_plain(mt="mxu")``) on the whole sorted primary and
bounce-2 wavefronts, which counts its packed 16-ray tiles, block visits and
filter passes per live ray and holds the plain filter sound on every pair
it sweeps; the HMMA instructions of its instances are counted in
``cuobjdump -sass`` of the built library; the
default and row-gated instances are timed at clusters of 1, 2 and 4 rows on
a bounce wavefront. The pair hits are held against their row-gated plain
version too (on every slot), and the cluster-culled sphere search against
its gated plain version and the monolithic one, also on tied copies with a
hollow sphere in 2,112 slots; each prints the work its gates leave (rows
per valid pair, groups per live lane). The first crossed cluster (and its
pair variant) and the crossing lists are held against their ungated plain
versions and against the two-level walk of their group gate
(``crossing_walk_gated_plain``), which counts the group and member boxes a
live ray tests.

Each frame is checked for finite values and against the same frame with the
plain versions (at a reduced size where the plain mesh search is too slow),
sphere-scene NEE on the card against the CPU, and the threefry RNG on the
card against the CPU bit for bit. Every phase raises on failure, so the
script exits non-zero; without CUDA it raises before printing any result.

Beside its time and its plain version's, each kernel gets its bound: the
least time the card could take for the same work, the largest of its FP32
operations over 67 TFLOP/s, its TF32 tensor-core operations over 495
TFLOP/s (A3m's products) and its bytes (inputs once, outputs once) over
3.35 TB/s, all counted from this run's inputs (live lanes, chunks and
clusters that the gates open); ``peak`` names which. A3m also prints the
bound of the FP32 form it replaced. The shading kernel's ``ms`` is its
device time, its launches queued behind a sleep kernel, since the host
time of its launch (also printed) is longer than the kernel. No single PyTorch call computes any of these
functions, so ``library_ms`` is null throughout.

Output: the card's name and power limit (nvidia-smi), per-phase numbers, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WIDTH, HEIGHT, DEPTH, SEED = 1920, 1080, 10, 0   # book-cover frame
TERRAIN = dict(width=1920, height=1080, spp=1, max_depth=5)
TERRAIN_PLAIN_WH = (240, 135)      # terrain kernel vs plain frame
CORNELL = dict(width=512, height=512, spp=64, max_depth=10, nee=True,
               samples_per_batch=4)
CORNELL_PLAIN_SPP = 4              # Cornell kernel vs plain frame
SUBSET_RAYS = 32768                # strided subset for the plain mesh search
T_RTOL = 1e-5                 # t of agreeing live lanes
OUT_ATOL = OUT_RTOL = 1e-5    # every other float output
IDX_AGREE_MIN = 0.9999        # live lanes whose winner ids agree
IMG_ATOL = IMG_RTOL = 2e-3    # frame vs plain frame, per channel
IMG_MISMATCH_MAX = 0.01
TIMED_RUNS = 7             # the medians of the kernels line's ms, plain_ms
EXPLORE_RUNS = 3           # the medians of timings outside the kernels line
KERNELS = ("fused_hit", "fused_hit_shadow", "mesh_first_cluster",
           "mesh_search", "sphere_search", "sphere_search_clustered",
           "fused_hit[exclude]", "sphere_search[exclude]",
           "mesh_search[exclude]", "mesh_first_cluster[pair]",
           "mesh_crossing_lists", "mesh_pairs", "mesh_search[rowgate]",
           "mesh_search[mxu]", "bvh_walk", "bvh_walk[exclude]",
           "fused_shade", "diff_bounce", "diff_bounce[shadow_rays]",
           "diff_bounce[backward]")
PAIR_C = 6                 # crossing-list width of the pair search
CLUSTER_ROWS = (1, 2, 4)   # cluster sizes timed on the bounce wavefront
PEAK_FP32 = 67e12          # FLOP/s outside the tensor cores (H100 SXM)
PEAK_TF32 = 495e12         # FLOP/s of the tensor cores in TF32, dense
PEAK_BYTES = 3.35e12       # bytes/s of HBM3
SWEEP_FLOPS = 25           # per (ray, sphere) pair of a sphere sweep
SWEEP_DEPTHS = (2, 3, 5)   # bounce wavefronts of the sphere sweep phase
REFINE_FLOPS = 100         # per ray: A1's refinement and geometry
SLAB_FLOPS = 20            # per (ray, box) slab test
MT_FLOPS = 45              # per (ray, triangle) Moller-Trumbore and accept
MXU_FLOPS = 45             # the same, bilinear form (mesh_common.cuh count)
MXU_TRI_BYTES = 76         # 19 f32 factors per triangle
# A3m (csrc/mesh_intersect.cu) per (ray, triangle) pair: det, u det, v det
# and their three margins as tensor-core products, 2 * (3 + 6 + 6) * 2
# TF32 operations; in FP32 the filter's epilogue (maybe_hit, 14), the FMA
# that starts u's and v's margins (1) and the pair's share of the B
# operands' TF32 rounding and sign masking (5 cvt and 5 AND a thread for
# its 4 pairs, 2.5); the exact test (MXU_FLOPS) on each pair the filter
# passes.
MXU_PRODUCT_FLOPS = 60
MXU_EPILOGUE_OPS = 17.5
MXU_TILE_RAYS = 16         # rays a warp of A3m (mesh_intersect.MXU_RAYS)
# shade_kernel (csrc/fused_shade.cu) moves 98 bytes a lane (12 state floats
# and alive, in and out), 4 more a live one (t) and 72 more a live hit (the
# other 14 hit floats, its int64 key, mat and ff); a live hit runs some 300
# single-rounded operations.
SHADE_LANE_BYTES, SHADE_LIVE_BYTES, SHADE_HIT_BYTES = 98, 4, 72
SHADE_FLOPS = 300
SHADE_HOST_CALLS = 50      # launches timed back to back
# The differentiable bounce (csrc/diff_bounce.cu), bytes a lane each kernel
# moves: F1 reads the ray, alive, the winner's id and t and the key (41)
# and writes the shadow ray and cand (25); F2 reads the carry, t, the
# shadow t and id, alive, the key and the winner's id (77) and writes the
# new carry and alive (53); B reads F2's operands but the radiance (65) and
# 13 upstream gradients (52), and writes 10 gradients (40). The params rows
# stay in L2. Operations a lane: about 150 (F1), 350 (F2) single-rounded
# FP32, and B's recompute plus some 400 adjoint operations in FP64, at
# half the FP32 rate (counted twice).
DIFF_F1_BYTES, DIFF_F2_BYTES, DIFF_B_BYTES = 66, 130, 157
DIFF_F1_FLOPS, DIFF_F2_FLOPS, DIFF_B_FLOPS = 150, 350, 350 + 2 * 400
SLEEP_CYCLES = 10 ** 8     # about 50 ms of the card's clock
A6_SPHERES = 1061          # the clustered scene: 1,152 slots, 18 chunks
# BASELINE config 5 (benchmarks/run_baselines.py:196-386).
C5 = dict(width=1920, height=1080, spp=2, max_depth=4, rng="hash", nee=True,
          samples_per_batch=1)
C5_SPHERE_VIEWS = [(0.0, 0.0, 0.0), (0.5, 0.0, 0.0), (-0.5, 0.1, 0.0),
                   (0.0, 0.3, -0.3)]
C5_SPHERE_POSE_ERR = (0.1, -0.07, 0.08)
C5_SPHERE_LR = {"scene/albedo": 0.03, "scene/emission": 0.6,
                "camera/translate": 2.5e-2}
C5_MESH_VIEWS = [(0.0, 0.0, 0.0), (0.4, 0.15, 0.0)]
C5_MESH_POSE_ERR = (0.1, -0.07, 0.05)
C5_STEPS = 2               # edge-aware steps per scene: first, steady
C5_PATHWISE_STEPS = 1      # pathwise steps per scene
GRAD_PLAIN_WH = {"edge_aware": (1920, 1080),  # kernel vs plain gradients
                 "pathwise": (960, 540)}      # on the card
GRAD_CPU_WH = (96, 54)             # card vs CPU gradients
GRAD_RTOL_PLAIN = 1e-4   # x max|g|: atomic-add order of the gather backward
GRAD_RTOL_CPU = 2e-3     # x max|g|: the render flip budget
# The CLI on the card: `bench` as a user runs it, the reference panel's
# progressive render (Main.qml:10-13) with a checkpoint half way, small mesh,
# NEE and inverse-rendering runs, each held against the same run on the
# plain route (every kernel's plain version, on the card).
CLI_BENCH = ["bench", "--scene", "random", "--width", "1920", "--height",
             "1080", "--spp", "1", "--depth", "10", "--iters", "3"]
PANEL = dict(width=400, height=225, spp=24, max_depth=10)
PANEL_STEP, PANEL_CHECKPOINT = 4, 12
CLI_SMALL = dict(width=192, height=108, spp=2, depth=3)
PROGRESSIVE_ATOL = PROGRESSIVE_RTOL = 1e-5   # steps of n > 1 spp vs batch
PLAIN_ROUTE = "fused_interpret"   # every kernel's plain version, on the card
# The portable route (intersector="xla"): the BVH walk's node (two boxes,
# escape, start, count) and triangle (v0, e1, e2) rows; the vector oracle's
# frame and budget (tests/test_oracle_vec.py).
NODE_BYTES = TRI_BYTES = 36
XLA_ORACLE = dict(width=96, height=64, spp=4, max_depth=6, nee=True,
                  rng="hash", intersector="xla")
XLA_ORACLE_MISMATCH_MAX = 0.04
# The sharded phase: a world of one over NCCL in this process, then two
# ranks spawned on the one card over gloo (NCCL refuses two ranks on one
# GPU). Two ranks sharing a card measure no scaling.
SHARD_RANKS = 2
SHARD_JOIN_S = 300                 # the spawned ranks' whole run
SHARD_GROUP_TIMEOUT = datetime.timedelta(seconds=120)
SHARD_RTOL = SHARD_ATOL = 3e-7     # "sp" reassociates the spp sum


START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - START:.1f} s)", flush=True)


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


def wall_s(fn):
    """(result, seconds) of fn() on the host clock, card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def compare_hits(fh, kern: dict, plain: dict, alive: torch.Tensor) -> dict:
    """Agreement of the full-mode kernel's outputs with the plain version's."""
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


def compare_t_idx(big, kern, plain, alive) -> dict:
    """Agreement of a (t, idx) kernel (A2, A3) with its plain version: ids
    on live lanes, t within T_RTOL where the ids agree on a hit, BIG/0 on
    dead lanes."""
    (tk, ik), (tp, ip) = kern, plain
    live = int(alive.sum())
    agree = alive & (ik == ip)
    hit = agree & (tp < big)
    err = (tk[hit].double() - tp[hit].double()).abs()
    worst = float((err / (T_RTOL * tp[hit].double().abs())).max()) \
        if err.numel() else 0.0
    stats = {"live": live, "idx_agree": float(agree.sum()) / max(live, 1),
             "hits": int(hit.sum()),
             "max_abs_err": float(err.max()) if err.numel() else 0.0,
             "worst_err_over_tol": worst,
             "bitwise": bool(torch.equal(tk[alive], tp[alive])
                             and torch.equal(ik[alive], ip[alive]))}
    dead = ~alive
    for x in (tk, tp):
        if not bool((x[dead] == big).all()):
            raise AssertionError("dead lanes do not hold t = BIG")
    for x in (ik, ip):
        if not bool((x[dead] == 0).all()):
            raise AssertionError("dead lanes do not hold idx = 0")
    if stats["idx_agree"] < IDX_AGREE_MIN or worst > 1.0:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{stats}")
    return stats


def _sphere_search_module():
    from qt_raytracer_tpu_torch.kernels import sphere_intersect
    return sphere_intersect


def _mesh_pairs_module():
    from qt_raytracer_tpu_torch.kernels import mesh_pairs
    return mesh_pairs


def _bvh_walk_module():
    from qt_raytracer_tpu_torch.kernels import bvh_walk
    return bvh_walk


def _fused_shade_module():
    from qt_raytracer_tpu_torch.kernels import fused_shade
    return fused_shade


def reset_counts() -> None:
    from qt_raytracer_tpu_torch.runtime import spans
    spans.counts.clear()


def read_counts() -> dict:
    """The launch counts of KERNELS since the last reset_counts."""
    from qt_raytracer_tpu_torch.runtime import spans
    return {k: spans.counts[k] for k in KERNELS}


def bound(flops: float, nbytes: float, tf32_flops: float = 0.0) -> dict:
    """The least time the card could take: the largest of FP32 operations
    over the FP32 peak, TF32 operations over the tensor cores' TF32 peak
    (the two units run side by side) and bytes over the HBM rate; peak
    names which of the three it is."""
    times = {"fp32": flops / PEAK_FP32 * 1e3,
             "tf32": tf32_flops / PEAK_TF32 * 1e3,
             "hbm": nbytes / PEAK_BYTES * 1e3}
    peak = max(times, key=times.get)
    return {"bound_ms": times[peak],
            "bound_by": "bytes" if peak == "hbm" else "operations",
            "peak": peak, "flops": flops, "bytes": nbytes,
            **({"tf32_flops": tf32_flops} if tf32_flops else {})}


def device_ms(fn, runs: int = SHADE_HOST_CALLS) -> float:
    """Mean device milliseconds of fn()'s work, `runs` calls queued back to
    back behind a sleep kernel between two CUDA events: the card reaches
    the first event only once every call is queued, so a launch that takes
    the host longer than the card does not pace the time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    queued_in_time = not start.query()
    end.synchronize()
    if not queued_in_time:
        raise AssertionError("the sleep kernel ended before the calls were "
                             "queued")
    return start.elapsed_time(end) / runs


def host_us(fn, calls: int = SHADE_HOST_CALLS) -> float:
    """Host microseconds a call of fn, over `calls` calls issued back to
    back: the launch's host time where the card keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sec = time.perf_counter() - t0
    torch.cuda.synchronize()
    return sec / calls * 1e6


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """x's bits, so that NaN lanes compare too."""
    return x.view(torch.int32) if x.is_floating_point() else x


def shade_wavefront(itg, s, h, depth_idx: int, rr_start: int,
                    big: float, roulette_at: int = 0) -> dict:
    """shade_kernel (``fused_shade.fused_shade``) against its plain version
    (``integrator_flat._shade_plain``) on one wavefront s with its hits h:
    every output field on every lane, dead lanes included, bit for bit;
    with ``roulette_at`` > 0 once more with Russian roulette from that
    depth. Then the kernel's device ms (device_ms), the call's ms between
    two CUDA events, the launch's host microseconds and the checks' of its
    operands, the plain version's ms, and the bound of this wavefront."""
    from qt_raytracer_tpu_torch.runtime import cuda_build
    fs = _fused_shade_module()

    def check(rr):
        before = read_counts()["fused_shade"]
        kern = fs.fused_shade(s, h, depth_idx, rr)
        plain = itg._shade_plain(s, h, depth_idx, rr, 1.0, None)
        if read_counts()["fused_shade"] != before + 1:
            raise AssertionError("shade_kernel did not launch")
        for name, a, b in zip(itg.RayState._fields, kern, plain):
            differ = float_bits(a) != float_bits(b)
            if bool(differ.any()):
                raise AssertionError(
                    f"shade_kernel differs from its plain version in {name} "
                    f"on {int(differ.sum())} lanes (depth {depth_idx}, "
                    f"rr_start {rr})")

    check(rr_start)
    if roulette_at:
        check(roulette_at)
    n, live = s.ox.shape[0], int(s.alive.sum())
    hits = int((s.alive & (h["t"] < big)).sum())
    nbytes = (SHADE_LANE_BYTES * n + SHADE_LIVE_BYTES * live
              + SHADE_HIT_BYTES * hits)
    call = lambda: fs.fused_shade(s, h, depth_idx, rr_start)
    ops = ([getattr(s, k) for k in fs.STATE_FLOATS]
           + [h[k] for k in fs.HIT_FLOATS] + [s.alive, s.keys]
           + [h[k] for k in fs.HIT_INTS])
    return {"rays": n, "live": live, "hits": hits, "bitwise": True,
            "max_abs_err": 0.0, "roulette_checked": bool(roulette_at),
            "ms": device_ms(call),
            "call_ms": cuda_ms(call),
            "launch_host_us": host_us(call),
            "operand_check_host_us": host_us(
                lambda: cuda_build.pointers("fused_shade", ops, fs.DTYPES, n,
                                            s.ox.device)),
            "plain_ms": cuda_ms(lambda: itg._shade_plain(
                s, h, depth_idx, rr_start, 1.0, None)),
            **bound(SHADE_FLOPS * hits, nbytes)}


def diff_bounce_counts(units: int, depth: int) -> dict:
    """The differentiable bounce's launches over `units` checkpointed
    (chunk, sample) units of `depth` bounces with NEE: F2 and F1 in the
    forward and again in the recompute; B once a unit and bounce."""
    return {"diff_bounce": 2 * units * depth,
            "diff_bounce[shadow_rays]": 2 * units * depth,
            "diff_bounce[backward]": units * depth}


def ptxas_lines(cuda_build, kernel: str) -> dict:
    """Registers and spilled bytes ptxas reported for kernel in the last
    build (cuda_build.build_log; empty when this process built nothing)."""
    lines = cuda_build.build_log.splitlines()
    for k, line in enumerate(lines):
        if f"{kernel}E" in line and "Function properties" in line:
            spill, regs = lines[k + 1].strip(), lines[k + 2].strip()
            return {"spill": spill, "registers": regs.split(":", 1)[-1]}
    return {}


def diff_bounce_wavefront(itg, db, fh, cuda_build, tables, s, lights,
                          t_min: float) -> dict:
    """F1, F2 and B (kernels/diff_bounce.py) on one bounce-0 wavefront s of
    a sphere scene with NEE: the new carry bit for bit against the PyTorch
    route of bounce(diff=True), each input's gradient within 1e-4 of the
    larger of its norm and the median input's of that route's, B twice bit
    for bit; then each kernel's device ms beside its bound, the bounce's
    forward and backward ms on both routes, and ptxas's registers."""
    plain_rule = db.use_kernel
    gen = torch.Generator().manual_seed(0)
    weights = [torch.randn(s.ox.shape, generator=gen).to(s.ox.device)
               for _ in range(13)]

    def run(kernel: bool):
        """(new carry, loss, leaves) of the bounce along the kernels' route
        or the PyTorch route, the carry and the params table as leaves."""
        db.use_kernel = plain_rule if kernel else (lambda *a, **k: False)
        try:
            params = tables.params.detach().clone().requires_grad_(True)
            carry = {k: getattr(s, k).detach().clone().requires_grad_(True)
                     for k in db.CARRY}
            tab = fh.FusedSpheres(tables.spheres, params, tables.boxes)
            out = itg.bounce(tab, s._replace(**carry), 0, t_min, 0, False,
                             lights, True)
            loss = sum((w * x).sum() for w, x in
                       zip(weights, (*out[:12], out[13])))
            return out, loss, [params, *carry.values()]
        finally:
            db.use_kernel = plain_rule

    before = read_counts()
    got, loss_k, leaves_k = run(True)
    want, loss_p, leaves_p = run(False)
    after = read_counts()
    if (after["diff_bounce"] - before["diff_bounce"],
            after["diff_bounce[shadow_rays]"]
            - before["diff_bounce[shadow_rays]"]) != (1, 1):
        raise AssertionError("the differentiable bounce did not launch")
    for name, a, b in zip(itg.RayState._fields, got, want):
        differ = float_bits(a) != float_bits(b)
        if bool(differ.any()):
            raise AssertionError(f"diff_bounce's forward differs from the "
                                 f"PyTorch route in {name} on "
                                 f"{int(differ.sum())} lanes")
    gk = torch.autograd.grad(loss_k, leaves_k, retain_graph=True)
    again = torch.autograd.grad(loss_k, leaves_k, retain_graph=True)
    gp = torch.autograd.grad(loss_p, leaves_p, retain_graph=True)
    if not all(torch.equal(float_bits(a), float_bits(b))
               for a, b in zip(gk, again)):
        raise AssertionError("diff_bounce's backward is not deterministic")
    norms = [float(g.double().norm()) for g in gp]
    med = float(np.median(norms))
    rel = max(float((a.double() - b.double()).norm()) / max(n, med)
              for a, b, n in zip(gk, gp, norms))
    if not rel <= GRAD_RTOL_PLAIN:
        raise AssertionError(f"diff_bounce's gradients differ from the "
                             f"PyTorch route's: {rel}")

    # The kernels alone, on the same wavefront's operands.
    sel = fh.fused_hit(tables, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.alive,
                       t_min, shadow_only=True)
    st = db._Setup(tables, s.alive, s.keys, sel["idx"], sel["t"],
                   db._lights(lights, s.ox.device), 1, 0, t_min)
    ops = {**{k: getattr(s, k) for k in db.CARRY}, "t_sel": sel["t"],
           "alive": s.alive, "keys": s.keys, "idx": sel["idx"]}
    params = tables.params.detach()
    rays, cand = db.shadow_rays(st, params, ops)
    sh = fh.fused_hit(tables, *rays.unbind(0), cand, t_min, shadow_only=True)
    ops.update(sh_t=sh["t"], sh_idx=sh["idx"])
    b_ops = {k: v for k, v in ops.items() if k not in ("rx", "ry", "rz")}
    ups = [torch.randn(s.ox.shape[0], device=s.ox.device)
           for _ in db.CARRY]
    n, live = s.ox.shape[0], int(s.alive.sum())
    out = {"rays": n, "live": live, "cand": int(cand.sum()),
           "bitwise": True, "grad_rel_err": rel}
    for name, fn, nbytes, flops, kernel in (
            ("F1", lambda: db.shadow_rays(st, params, ops), DIFF_F1_BYTES,
             DIFF_F1_FLOPS, "diff_bounce_shadow_kernel"),
            ("F2", lambda: db.forward(st, params, ops), DIFF_F2_BYTES,
             DIFF_F2_FLOPS, "diff_bounce_kernel"),
            ("B", lambda: db.backward((1, 0, t_min), params, st.lights,
                                      b_ops, ups, True), DIFF_B_BYTES,
             DIFF_B_FLOPS, "diff_bounce_backward_kernel")):
        out[name] = {"ms": device_ms(fn), "call_ms": cuda_ms(fn),
                     "launch_host_us": host_us(fn),
                     **ptxas_lines(cuda_build, kernel),
                     **bound(flops * n, nbytes * n)}
    # The whole bounce after the leaves' copies (13 of them) and with its
    # loss (26 launches): A2's two calls, F1 and F2 against the PyTorch
    # route's forward; then each route's backward alone.
    out["bounce_forward_ms"] = cuda_ms(lambda: run(True))
    out["bounce_forward_plain_ms"] = cuda_ms(lambda: run(False))
    _, loss_k, leaves_k = run(True)
    _, loss_p, leaves_p = run(False)
    out["bounce_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
        loss_k, leaves_k, retain_graph=True))
    out["bounce_backward_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
        loss_p, leaves_p, retain_graph=True))
    return out


def sweep_work(fh, spheres, boxes, rays, alive, t_min,
               exclude=None) -> tuple[int, int]:
    """(pairs, gate tests) that the gated sweep of A1, A2 and A5 needs on
    these rays, counted by fused_hit.sweep_gated_plain: per live ray, one
    gate test per group and the slots of each group its gate opens (a
    whole GROUP_S per group: exact where GROUP_S divides the slots, as in
    every table here). Its (t, idx) must be the ungated sweep's."""
    live = torch.nonzero(alive).squeeze(1)
    groups = boxes.shape[0]
    pairs = 0
    for lo in range(0, live.shape[0], 65536):
        ids = live[lo:lo + 65536]
        part = [x[ids] for x in rays]
        ex = None if exclude is None else exclude[ids]
        t, i, visits = fh.sweep_gated_plain(spheres, boxes, fh.GROUP_S,
                                            *part, t_min, ex)
        t_ref, i_ref, _ = fh._sweep(spheres, *part, t_min, ex)
        if not (torch.equal(t, t_ref) and torch.equal(i, i_ref)):
            raise AssertionError("the gated sweep differs from the ungated "
                                 "one")
        pairs += int(visits.sum()) * fh.GROUP_S
    return pairs, int(live.shape[0]) * groups


def sweep_bound(n: int, live: int, work: tuple[int, int], slots: int,
                out_words: int, full: bool = False,
                exclude: bool = False) -> dict:
    """Bound of a sphere sweep (A1, A2, A5) on n rays, live of them alive:
    25 operations per (ray, slot) pair and 20 per group gate test of work
    (sweep_work), A1's refinement per live ray; rays in (6 floats and a
    flag, the exclude id where given), the table and its group boxes once,
    out_words per ray out."""
    pairs, tests = work
    flops = pairs * SWEEP_FLOPS + tests * SLAB_FLOPS \
        + live * (REFINE_FLOPS if full else 0)
    nbytes = n * (25 + 4 * exclude + 4 * out_words) \
        + slots * 16 * (5 if full else 1) + tests // max(live, 1) * 32
    return {"pairs_per_live_ray": pairs / max(live, 1),
            **bound(flops, nbytes)}


def with_dead_lanes(alive: torch.Tensor, seed: int) -> torch.Tensor:
    """alive with about 10% dead lanes scattered through live 128-ray rows,
    every 7th 128-ray row dead and one dead 256-ray thread block."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = alive.cpu() & (torch.rand(alive.shape[0], generator=g) >= 0.1)
    rows = out[: out.shape[0] // 128 * 128].view(-1, 128)
    rows[::7] = False
    out[1024:1280] = False
    return out.to(alive.device)


def clustered_scene():
    """The clustered-scene frame's scene on the card (A6_SPHERES random
    Lambertian spheres from seed 9, Morton-ordered at build: 1,152 slots,
    18 chunks), its camera and its config."""
    from qt_raytracer_tpu_torch import RenderConfig, SceneBuilder, make_camera
    cfg6 = RenderConfig(width=WIDTH, height=HEIGHT, spp=1, max_depth=DEPTH,
                        rng="hash", intersector="pallas")
    rng = np.random.default_rng(9)
    b = SceneBuilder()
    for _ in range(A6_SPHERES):
        b.lambertian(rng.uniform(-10, 10, 3), rng.uniform(0.05, 0.4),
                     0.2 + 0.7 * rng.random(3))
    cam6 = make_camera(lookfrom=(0.0, 6.0, 34.0), lookat=(0.0, 0.0, 0.0),
                       vfov=40.0, aspect_ratio=cfg6.aspect_ratio)
    return b.build(pad_to=128), cam6, cfg6


def clustered_wavefronts(many, s6, t_min) -> dict:
    """A6's wavefronts on the clustered scene, name -> (6 flat ray
    components, alive): the primary rays of the state s6 with about 10%
    dead lanes, and a bounce-1 wavefront from their hits into the
    hemisphere about each normal (seeded)."""
    from qt_raytracer_tpu_torch.core.intersect import intersect_spheres
    o6 = torch.stack([s6.ox, s6.oy, s6.oz], dim=1)
    d6 = torch.stack([s6.dx, s6.dy, s6.dz], dim=1)
    h6 = intersect_spheres(many, o6, d6, t_min, alive=s6.alive)
    gen = torch.Generator(device=o6.device).manual_seed(6)
    rnd = torch.randn(o6.shape, generator=gen, device=o6.device)
    d6b = h6.normal + rnd / rnd.norm(dim=1, keepdim=True)
    fronts = {"primary_chunk2": (o6, d6, with_dead_lanes(s6.alive, 6)),
              "bounce1_chunk2": (h6.point, d6b, h6.hit & s6.alive)}
    return {name: ([x[:, k].contiguous() for x in (o, d) for k in range(3)],
                   al.contiguous()) for name, (o, d, al) in fronts.items()}


def tie_wavefront(num_spheres: int, n: int, seed: int):
    """A scene of num_spheres slots in slot order (no spatial sort, so the
    ids stay where they are put): the ground, random spheres, copies of
    spheres 3, 7 and 20 at ids in another lane (+1), another 32-slot group
    (+33) and another 64-slot chunk (+70), and in slot 45 a sphere of
    radius -0.5 far from the rest of its group; and n rays from above, half
    aimed at the copied spheres and the hollow one, about 10% dead. Returns
    (scene on the card, 6 flat ray components, alive)."""
    from qt_raytracer_tpu_torch import SceneBuilder
    rng = np.random.default_rng(num_spheres)
    rows = [((0.0, -1000.0, 0.0), 1000.0)]
    while len(rows) < num_spheres:
        rows.append(((rng.uniform(-6, 6), rng.uniform(0.3, 1.0),
                      rng.uniform(-6, 6)), rng.uniform(0.1, 0.3)))
    for src in (3, 7, 20):
        rows[src] = ((rng.uniform(-4, 4), 2.0, rng.uniform(-4, 4)), 0.4)
        for off in (1, 33, 70):
            rows[src + off] = rows[src]
    rows[45] = ((8.0, 3.2, -8.0), -0.5)
    b = SceneBuilder()
    for c, r in rows:
        b.lambertian(c, r, (0.5, 0.5, 0.5))
    scene = b.build(pad_to=None, spatial_sort=False)
    rng = np.random.default_rng(seed)
    o = rng.uniform(-7.0, 7.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(3.0, 5.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = rng.random(n) < 0.5
    centers = np.array([rows[j][0] for j in (3, 7, 20, 45)], np.float32)
    tgt = centers[rng.integers(0, 4, int(k.sum()))]
    d[k] = tgt + rng.normal(scale=0.05, size=tgt.shape) - o[k]
    dev = scene.center.device
    rays = [torch.from_numpy(np.ascontiguousarray(x[:, a])).to(dev)
            for x in (o, d) for a in range(3)]
    return scene, rays, torch.from_numpy(rng.random(n) >= 0.1).to(dev)


def compare_search(si, scene, o, d, alive, t_min, exclude=None) -> dict:
    """A5 against its plain version on one wavefront: bitwise (t, idx) on
    live lanes, (BIG, 0) on dead lanes; CUDA-event ms of both on the
    prepared table and flat ray components (the wrapper's prep and copies
    left out)."""
    kw = dict(alive=alive, exclude=exclude)
    kern = si.sphere_search(scene, o, d, t_min, **kw)
    plain = si.sphere_search(scene, o, d, t_min, interpret=True, **kw)
    torch.cuda.synchronize()
    st = compare_t_idx(si.BIG, kern, plain, alive)
    if not st["bitwise"]:
        raise AssertionError(f"A5 is not bitwise equal to its plain version "
                             f"on live lanes: {st}")
    from qt_raytracer_tpu_torch.kernels import fused_hit as fh
    tables = si.prep_sphere_search(scene)
    rays = [x[:, k].contiguous() for x in (o, d) for k in range(3)]
    work = sweep_work(fh, tables.spheres, tables.boxes, rays, alive, t_min,
                      None if exclude is None else
                      exclude.to(torch.int32))
    st.update(rays=o.shape[0], dead_lanes=int((~alive).sum()),
              ms=cuda_ms(lambda: si.sphere_search_flat(
                  tables, *rays, alive, t_min, exclude=exclude)),
              plain_ms=cuda_ms(lambda: si.sphere_search_flat(
                  tables, *rays, alive, t_min, interpret=True,
                  exclude=exclude)),
              **sweep_bound(o.shape[0], st["live"], work,
                            tables.spheres.shape[0], 2,
                            exclude=exclude is not None))
    return st


def own_winner(idx, t, alive, big) -> torch.Tensor:
    """Each live hitting lane's own winner as its exclude id, -1 elsewhere:
    the exclude operand that shows every ray its second hit."""
    return torch.where(alive & (t < big), idx, -1).to(torch.int32)


def check_excluded(kern_t, kern_idx, excl, alive, big, what: str) -> dict:
    """No lane's excluded id wins; some lane shows a second hit."""
    named = alive & (excl >= 0)
    if bool((named & (kern_t < big) & (kern_idx == excl)).any()):
        raise AssertionError(f"{what}: an excluded id won")
    second = int((named & (kern_t < big)).sum())
    if second == 0:
        raise AssertionError(f"{what}: no second hit behind any winner")
    return {"excluded_lanes": int(named.sum()), "second_hits": second}


def view_loss_and_grads(scene, camera, cfg, key, target, fields):
    """L2 loss of one view and its gradients by leaf ("albedo", "emission"
    of the spheres, "translate" of the camera), as a train step takes
    them."""
    from qt_raytracer_tpu_torch.diff import inverse as inv
    from qt_raytracer_tpu_torch.core.world import World
    spheres = scene.spheres if isinstance(scene, World) else scene
    params = {f: (torch.zeros(3, device=target.device) if f == "translate"
                  else getattr(spheres, f)).clone().requires_grad_(True)
              for f in fields}
    sp = dataclasses.replace(spheres, **{f: v for f, v in params.items()
                                         if f != "translate"})
    sc = dataclasses.replace(scene, spheres=sp) \
        if isinstance(scene, World) else sp
    cam = inv.translate_camera(camera, params["translate"]) \
        if "translate" in params else camera
    loss = inv.image_loss(sc, cam, inv.grad_capable_config(cfg), key, target)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(fields, grads))


def compare_grads(a, b, rtol: float, what: str) -> dict:
    """Loss and gradients a against b (both (loss, {name: grad})), each
    within rtol x max|b|."""
    (la, ga), (lb, gb) = a, b
    out = {"loss": [float(la), float(lb)]}
    pairs = [("loss", la, lb)] + [(k, ga[k], gb[k]) for k in gb]
    for k, x, y in pairs:
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        scale = float(y.abs().max())
        err = float((x - y).abs().max())
        out[k] = {"max_abs_err": err, "max_abs": scale}
        if not (bool(torch.isfinite(x).all()) and err <= rtol * scale):
            raise AssertionError(f"{what}: {k} differs: {out}")
    return out


def train_steps(step_fn, state, targets, key, errs, steps,
                per_step: dict) -> tuple:
    """`steps` train steps: per step the seconds, the loss, the errors,
    peak memory and the launches, which must be per_step for every kernel;
    every trainable group's gradient must be finite and nonzero. Returns
    (state, log, launches summed, the first step's gradients)."""
    from qt_raytracer_tpu_torch.diff.inverse import leaves
    log, launches, first_grads = [], None, None
    for k in range(steps):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (state, loss), sec = wall_s(lambda: step_fn(state, targets, key))
        counts = read_counts()
        launches = counts if launches is None else \
            {n: launches[n] + c for n, c in counts.items()}
        grads = {p: t.grad for p, t in leaves(state.params)}
        if first_grads is None:
            first_grads = {p: g.clone() for p, g in grads.items()}
        want = {**dict.fromkeys(KERNELS, 0), **per_step}
        if counts != want:
            raise AssertionError(f"step {k + 1} launched {counts}, expected "
                                 f"{want}")
        with torch.no_grad():
            err = errs(state)
        entry = {"step": k + 1, "s": sec, "loss": float(loss), **err,
                 "max_memory_allocated_gib":
                     torch.cuda.max_memory_allocated() / 2 ** 30,
                 "launches": counts,
                 "grad_max_abs": {p: float(g.abs().max())
                                  for p, g in grads.items()}}
        print(f"step {json.dumps(entry)}", flush=True)
        if not (torch.isfinite(loss) and all(
                bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
                for g in grads.values())):
            raise AssertionError(f"step {k + 1}: loss or gradients not "
                                 f"finite and nonzero: {entry}")
        log.append(entry)
    return state, log, launches, first_grads


def pose_gradient_differs(edge: dict, pathwise: dict, what: str) -> float:
    """|g_edge - g_pathwise| / |g_pathwise| of the pose gradient of the
    same first step (same state, same key): the boundary term is live when
    it is well away from 0."""
    a, b = edge["camera/translate"], pathwise["camera/translate"]
    rel = float((a - b).norm() / b.norm())
    if not rel > 0.05:
        raise AssertionError(f"{what}: the edge-aware pose gradient equals "
                             f"the pathwise one (relative change {rel})")
    return rel


def drive_frame(render_linear, scene, camera, cfg, expected: dict,
                steady_runs: int = 3) -> tuple[torch.Tensor, dict]:
    """Drive one path through render_linear: launch counts set to 0 just
    before its first frame and read just after, then steady frames."""
    reset_counts()
    img, first_s = wall_s(lambda: render_linear(scene, camera, cfg, SEED))
    counts = read_counts()
    expected = {**dict.fromkeys(KERNELS, 0), **expected}
    if counts != expected:
        raise AssertionError(f"kernel launches {counts}, expected {expected}")
    if img.shape != (cfg.height, cfg.width, 3) or \
            not bool(torch.isfinite(img).all()):
        raise AssertionError(f"frame is not a finite "
                             f"[{cfg.height}, {cfg.width}, 3] image")
    steady = [wall_s(lambda: render_linear(scene, camera, cfg, SEED))[1]
              for _ in range(steady_runs)]
    frame_s = statistics.median(steady)
    return img, {"launches": counts, "first_s": first_s, "steady_s": frame_s,
                 "steady_runs": steady,
                 "msamples_per_s": cfg.num_pixels * cfg.spp / frame_s / 1e6,
                 "mean": float(img.mean())}


def against_plain_frame(render_linear, scene, camera, cfg, img=None,
                        plain: str = "fused_interpret") -> dict:
    """The kernel frame against the plain-version frame of cfg."""
    if img is None:
        img = render_linear(scene, camera, cfg, SEED)
    plain_cfg = dataclasses.replace(cfg, intersector=plain)
    ref, plain_s = wall_s(lambda: render_linear(scene, camera, plain_cfg,
                                                SEED))
    mismatch = (img - ref).abs() > IMG_ATOL + IMG_RTOL * ref.abs()
    out = {"size": [cfg.width, cfg.height, cfg.spp, cfg.max_depth],
           "plain_frame_s": plain_s,
           "mismatch_frac": float(mismatch.float().mean()),
           "bitwise_frac": float((img == ref).float().mean())}
    if not bool(torch.isfinite(ref).all()) or \
            out["mismatch_frac"] > IMG_MISMATCH_MAX:
        raise AssertionError(f"frame differs from the plain frame: {out}")
    return out


def cornell_step_lanes(fh, world, rays, t_min):
    """(alive, cap) of a wavefront of the true-Cornell train step: scattered
    dead lanes, and the sphere hit as intersect_world caps the mesh search
    with it."""
    from qt_raytracer_tpu_torch.core.intersect import intersect_spheres
    n = rays[0].shape[0]
    alive = with_dead_lanes(torch.ones(n, dtype=torch.bool,
                                       device=rays[0].device), 5)
    hs = intersect_spheres(world.spheres, torch.stack(rays[:3], dim=1),
                           torch.stack(rays[3:], dim=1), t_min, alive=alive)
    return alive, torch.where(hs.hit, hs.t, fh.BIG).detach().contiguous()


def pair_step_wavefront(fh, mi, mp, world, rays, t_min) -> None:
    """A4 (both outputs), A7 and A8 against their plain versions, and the
    pair search against the clustered one, at the shape the true-Cornell
    train step gives them: one chunk of primary rays (cornell_step_lanes);
    one cluster of one 128-triangle row, so lists of width 1. All bitwise."""
    mc = mi.prep_mesh_clusters(world.mesh)
    n = rays[0].shape[0]
    alive, cap = cornell_step_lanes(fh, world, rays, t_min)
    a4 = lambda **kw: mi.first_crossed_cluster(mc, *rays, t_min, alive, cap,
                                               pair=True, **kw)
    c12 = a4()
    two = mi.crossing_walk_gated_plain(mc, *rays, t_min, alive, cap, 2,
                                       stop=True)[0]
    if not (all(torch.equal(a, b) for a, b in zip(c12, a4(interpret=True)))
            and torch.equal(c12[0], two[:, 0])
            and torch.equal(c12[1], two[:, 1])
            and torch.equal(c12[0], mi.first_crossed_cluster(
                mc, *rays, t_min, alive, cap))):
        raise AssertionError("A4 differs from its plain versions (Cornell)")
    width = mp.pair_list_width(mc, n)
    a7 = lambda **kw: mp.crossing_lists(mc, *rays, t_min, alive, cap, width,
                                        **kw)
    lists, ncross = a7()
    walk, a7_bound = walk_bound(mi, mc, rays, alive, cap, t_min, width, False,
                                n * (33 + 4 * (width + 1))
                                + mc.box_planes.numel() * 4,
                                float(alive.sum()) * mc.k)
    if not all(torch.equal(a, b) for a, b in zip((lists, ncross),
                                                 a7(interpret=True))) \
            or not all(torch.equal(a, b) for a, b in zip((lists, ncross),
                                                         walk)):
        raise AssertionError("A7 differs from its plain versions (Cornell)")
    ray_buf, gmap = mp.pair_slots(lists, mc.k)
    a8 = lambda **kw: mp.pair_hits(mc, *rays, cap, ray_buf, gmap, t_min, **kw)
    kern = a8()
    gated = mp.pair_hits_gated_plain(mc, *rays, cap, ray_buf, gmap, t_min)
    if not all(torch.equal(a, b) for a, b in zip(kern, a8(interpret=True))) \
            or not all(torch.equal(a, b) for a, b in zip(kern, gated[:2])):
        raise AssertionError("A8 differs from its plain versions (Cornell)")
    st = compare_t_idx(
        fh.BIG, mp.mesh_search_pairs(mc, *rays, t_min, alive, cap),
        mi.mesh_search(mc, *rays, t_min, alive=alive, t_cap=cap), alive)
    if not st["bitwise"]:
        raise AssertionError(f"the pair search is not bitwise equal to the "
                             f"clustered search (Cornell): {st}")
    st.update(rays=n, clusters=mc.k, tris_per_cluster=mc.tris_per_cluster,
              list_width=width, pairs=int(ncross.sum()),
              rows_per_valid_pair=float(gated[2].sum())
              / max(int((ray_buf >= 0).sum()), 1),
              slots=int(ray_buf.shape[0]), hits=int((kern[0] < fh.BIG).sum()),
              a7_ms=cuda_ms(a7), a7_plain_ms=cuda_ms(
                  lambda: a7(interpret=True), 3),
              a7_bound=a7_bound,
              a8_ms=cuda_ms(a8), a8_plain_ms=cuda_ms(
                  lambda: a8(interpret=True), 3))
    print(f"A7 and A8 on a wavefront of the true-Cornell step: "
          f"{json.dumps(st)}", flush=True)


def walk_bound(mi, mc, rays, alive, cap, t_min, c_max: int, stop: bool,
               nbytes: float, parent_tests: float) -> tuple:
    """((lists, ncross), bound) of the two-level walk of A4 (c_max 1 or 2,
    stop) or A7 (c_max, no stop) on these rays, by
    crossing_walk_gated_plain: 20 operations per group or member box
    tested; bytes: nbytes and the group boxes. Beside it the parent's bound,
    20 per box of the ungated walk (parent_tests), and the tests per live
    ray."""
    lists, ncross, groups, members = mi.crossing_walk_gated_plain(
        mc, *rays, t_min, alive, cap, c_max, stop=stop)
    live = max(int(alive.sum()), 1)
    g, m = int(groups.sum()), int(members.sum())
    return (lists, ncross), {
        **bound((g + m) * SLAB_FLOPS, nbytes + mc.group_boxes.numel() * 4),
        "parent_bound_ms": bound(parent_tests * SLAB_FLOPS,
                                 nbytes)["bound_ms"],
        "group_tests_per_live_ray": g / live,
        "member_tests_per_live_ray": m / live,
        "parent_tests_per_live_ray": parent_tests / live}


def a8_bound(mc, pairs: int, rows: int, slots: int) -> dict:
    """Bound of A8 on `pairs` valid pairs in `slots` slots: 45 operations
    per (valid pair, triangle of a row its gate opens; rows as
    pair_hits_gated_plain counts them) and 20 per row gate test; bytes: the
    pairs' rays in (28 each), the slots' ids and results (16 each), the
    tile map, the triangle planes and the row boxes. Beside it the parent's
    count, 45 per (valid pair, triangle of its cluster)."""
    g = mc.tris_per_cluster
    nbytes = pairs * 28 + slots * 16 + slots // 128 * 4 \
        + mc.tri_planes.numel() * 4 + mc.row_boxes.numel() * 4
    return {"rows_per_valid_pair": rows / max(pairs, 1),
            "bound_all_rows_ms": bound(pairs * g * MT_FLOPS,
                                       nbytes)["bound_ms"],
            **bound(rows * 128 * MT_FLOPS
                    + pairs * (g // 128) * SLAB_FLOPS, nbytes)}


def a3_bound(mc, body: str, n: int, live: int, visits: int, rows: int = 0,
             exclude: bool = False, work: dict | None = None) -> dict:
    """Bound of A3 (body "a3"), its row-gated ("rowgate") or bilinear-form
    ("mxu") instance on n rays (live of them alive): 20 operations per
    (live ray, cluster) slab test, 20 per row slab test of a visited
    cluster (the row gate), 45 per (ray, triangle) of a visited cluster, or
    of a row that passes the row gate; visits and rows as the gated plain
    sweep counts them. "mxu" (A3m) counts its own form: per (ray, triangle)
    of a cluster the ray visits, MXU_PRODUCT_FLOPS on the tensor cores and
    MXU_EPILOGUE_OPS in FP32, and 45 per pair of those that the filter
    passes (work, from the gated plain sweep under mt="mxu"), with the
    FP32 form's bound (45 a pair) beside it and the packed tile, block and
    filter counts per live ray. Bytes: the rays (and the exclude ids) in,
    (t, idx) out, the triangle planes (19 factors a triangle for "mxu"),
    the boxes and the row boxes."""
    g = mc.tris_per_cluster
    flops = live * mc.k * SLAB_FLOPS
    nbytes = n * (37 + 4 * exclude) + mc.box_planes.numel() * 4
    tf32, extra = 0.0, {}
    if body == "rowgate":
        flops += rows * 128 * MT_FLOPS + visits * (g // 128) * SLAB_FLOPS
        nbytes += mc.tri_planes.numel() * 4 + mc.row_boxes.numel() * 4
    elif body == "mxu":
        nbytes += mc.k * g * MXU_TRI_BYTES
        per = max(live, 1)
        extra = {"bound_fp32_form_ms": bound(flops + visits * g * MXU_FLOPS,
                                             nbytes)["bound_ms"],
                 "tile_visits_per_live_ray": work["tile_visits"] / per,
                 "tile_rays_per_visit": work["tile_visits"] * MXU_TILE_RAYS
                 / max(visits, 1),
                 "block_visits": work["block_visits"],
                 "block_visits_per_live_ray": work["block_visits"] / per,
                 "filter_passes_per_live_ray": work["filter_passes"] / per,
                 "filter_passes_per_visit":
                     work["filter_passes"] / max(visits, 1)}
        flops += visits * g * MXU_EPILOGUE_OPS \
            + work["filter_passes"] * MXU_FLOPS
        tf32 = visits * g * MXU_PRODUCT_FLOPS
    else:
        flops += visits * g * MT_FLOPS
        nbytes += mc.tri_planes.numel() * 4
    return {"visits_per_live_ray": visits / max(live, 1),
            **({"rows_per_live_ray": rows / max(live, 1)}
               if body == "rowgate" else {}),
            **extra, **bound(flops, nbytes, tf32)}


def tensor_core_instructions(cuda_build) -> dict:
    """The HMMA (tensor-core) instructions in each instance of A3's kernels,
    as cuobjdump -sass of the built library shows them: A3m's must have
    some, the warp-per-ray kernel none."""
    tool = pathlib.Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(cuda_build.library_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = fn[fn.index("mesh_search"):fn.index("EEv") + 2] \
                if "mesh_search" in fn and "EEv" in fn else None
            if name:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    mxu = {k: v for k, v in counts.items() if "mxu" in k}
    if len(mxu) != 2 or min(mxu.values()) == 0 or any(
            v for k, v in counts.items() if "mxu" not in k):
        raise AssertionError(f"HMMA instructions not where expected: "
                             f"{counts}")
    return counts


def compare_body(mi, mc, body, r_sub, al_sub, cap_sub, t_min, a3_sub,
                 exclude=None, time_plain=False) -> dict:
    """A3's row-gated ("rowgate") or bilinear-form ("mxu") instance against
    its plain version on a sorted subset: bitwise; the row gate also
    bitwise equal to A3 (a3_sub), the bilinear form in winner ids on at
    least IDX_AGREE_MIN of the live lanes. Its ms (and the plain version's
    with time_plain), and the bound."""
    kw = dict(visit="rowgate") if body == "rowgate" else dict(mt="mxu")
    run = lambda **more: mi.mesh_hits(mc, *r_sub, t_min, al_sub, cap_sub,
                                      exclude=exclude, **kw, **more)
    kern = run()
    # The row gate's plain version is the gated sweep that counts its work;
    # the bilinear form's is the ungated sweep, which the gated one (the
    # kernel's gate, its tiles and filter counted, the filter held sound)
    # must equal.
    gated = mi.mesh_search_gated_plain(mc, *r_sub, t_min, al_sub, cap_sub,
                                       exclude=exclude, **kw)
    plain = gated[:2] if body == "rowgate" else run(interpret=True)
    if not all(torch.equal(a, b) for a, b in zip(gated[:2], plain)):
        raise AssertionError(f"the gated plain sweep ({body}) differs from "
                             f"the plain version")
    torch.cuda.synchronize()
    st = compare_t_idx(mi.BIG, kern, plain, al_sub)
    if not st["bitwise"]:
        raise AssertionError(f"A3 {body} is not bitwise equal to its plain "
                             f"version: {st}")
    if body == "rowgate":
        if not all(torch.equal(a[al_sub], b[al_sub])
                   for a, b in zip(kern, a3_sub)):
            raise AssertionError("A3 rowgate is not bitwise equal to A3")
        st["bitwise_vs_a3"] = True
    else:
        st["idx_agree_vs_a3"] = float((kern[1] == a3_sub[1])[al_sub].float()
                                      .mean())
        if st["idx_agree_vs_a3"] < IDX_AGREE_MIN:
            raise AssertionError(f"A3 mxu disagrees with A3: {st}")
    if exclude is not None:
        st.update(check_excluded(kern[0], kern[1], exclude, al_sub, mi.BIG,
                                 f"A3 {body}"))
    elif body == "mxu":
        st["subset_filter_passes"] = gated[3]["filter_passes"]
    counts = dict(visits=gated[2], rows=gated[3]) if body == "rowgate" \
        else dict(visits=gated[2], work=gated[3])
    st.update(a3_bound(mc, body, r_sub[0].shape[0], int(al_sub.sum()),
                       exclude=exclude is not None, **counts),
              subset_rays=int(r_sub[0].shape[0]), ms=cuda_ms(run))
    if time_plain:
        st["plain_ms"] = cuda_ms(lambda: run(interpret=True), 1)
    return st


def cluster_sizes(mi, world, rays, alive, cap, t_min, ref) -> dict:
    """A3 and its row-gated instance on one wavefront at each cluster size
    of CLUSTER_ROWS, sorted by each size's own crossing key: bitwise equal
    on live lanes to ref (the default search); each kernel's ms on the
    sorted rays, and its bound from the gated plain sweep's counts over the
    whole wavefront (the row gate leaves the cluster visits as they are)."""
    out = {}
    for rows in CLUSTER_ROWS:
        mc = mi.prep_mesh_clusters(world.mesh, cluster_rows=rows)
        perm = mi.crossing_order(mc, *rays, t_min, alive, cap)
        srays = tuple(x[perm] for x in rays)
        salive, scap = alive[perm], cap[perm]
        st = {"k": mc.k, "tris_per_cluster": mc.tris_per_cluster}
        _, _, visits, row_visits = mi.mesh_search_gated_plain(
            mc, *srays, t_min, salive, scap, visit="rowgate")
        for body, kw in (("a3", {}), ("rowgate", dict(visit="rowgate"))):
            got = mi.mesh_search(mc, *rays, t_min, alive=alive, t_cap=cap,
                                 **kw)
            if not all(torch.equal(a[alive], b[alive])
                       for a, b in zip(got, ref)):
                raise AssertionError(f"A3 {body} with {rows}-row clusters "
                                     f"differs from the default search")
            st[body] = {"ms": cuda_ms(lambda: mi.mesh_hits(
                mc, *srays, t_min, salive, scap, **kw)),
                **a3_bound(mc, body, rays[0].shape[0], int(alive.sum()),
                           visits, row_visits)}
        out[f"cluster_rows_{rows}"] = st
        print(f"cluster rows {rows}: {json.dumps(st)}", flush=True)
    return out


def run_cli(cli, argv: list[str]) -> tuple[int, str]:
    """(exit code, standard output) of the port's CLI run in this process,
    so that its kernel launches land in this process's counters."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def small_args(scene: str) -> list[str]:
    return ["--scene", scene] + [a for k, v in CLI_SMALL.items()
                                 for a in (f"--{k}", str(v))]


def cli_phase(scenes, render_linear, RenderConfig) -> dict:
    """The port's app layer on the card through the entry points a user
    calls. Raises on any failure; returns the phase's numbers and the
    launches of its counted runs."""
    from qt_raytracer_tpu_torch import render
    from qt_raytracer_tpu_torch.app import cli
    from qt_raytracer_tpu_torch.app.png import encode_png
    from qt_raytracer_tpu_torch.app.progressive import ProgressiveRenderer
    from qt_raytracer_tpu_torch.core.sampling import fold_in

    t0 = time.perf_counter()
    out = {"launches": dict.fromkeys(KERNELS, 0)}

    def count(what: str, expected: dict, at_least: tuple = ()) -> dict:
        counts = read_counts()
        for k, v in counts.items():
            out["launches"][k] += v
        want = {**dict.fromkeys(KERNELS, 0), **expected}
        bad = {k: (counts[k], want[k]) for k in KERNELS
               if (counts[k] == 0 if k in at_least else counts[k] != want[k])}
        if bad:
            raise AssertionError(f"{what}: launches (got, expected) {bad}")
        return {k: v for k, v in counts.items() if v}

    # (a) `bench` as a user runs it, in its own process.
    proc = subprocess.run(
        [sys.executable, "-m", "qt_raytracer_tpu_torch.app.cli", *CLI_BENCH],
        cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"cli bench exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    if not bench["msamples_per_s"] > 0 or bench["backend"] != "cuda":
        raise AssertionError(f"cli bench: {bench}")
    out["bench"] = bench
    print(f"cli bench: {json.dumps(bench)}", flush=True)

    # (b) The panel's progressive render, interrupted at 12 spp by a
    # checkpoint, resumed into a renderer built with a wrong seed.
    cfg = RenderConfig(**PANEL)
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        reset_counts()
        t1 = time.perf_counter()
        pr = ProgressiveRenderer(scene, cam, cfg, seed=SEED)
        while pr.frame_index < PANEL_CHECKPOINT:
            pr.step(PANEL_STEP)
        pr.save(tmp / "panel.pt")
        resumed = ProgressiveRenderer(scene, cam, cfg, seed=SEED + 99)
        resumed.load(tmp / "panel.pt")
        if resumed.frame_index != PANEL_CHECKPOINT or resumed.seed != SEED:
            raise AssertionError("the checkpoint did not restore its state")
        while resumed.frame_index < cfg.spp:
            resumed.step(PANEL_STEP)
        torch.cuda.synchronize()
        out["progressive_s"] = time.perf_counter() - t1
        out["progressive_launches"] = count(
            "progressive render", {"fused_hit": cfg.spp * cfg.max_depth})
        # The same render on the plain route (the kernels' plain versions,
        # on the card): the steps of 4 spp and the batch, bit for bit.
        plain_cfg = dataclasses.replace(cfg, intersector=PLAIN_ROUTE)
        plain_pr = ProgressiveRenderer(scene, cam, plain_cfg, seed=SEED)
        while plain_pr.frame_index < cfg.spp:
            plain_pr.step(PANEL_STEP)
        out["progressive_bitwise_vs_plain"] = bool(
            torch.equal(resumed.state.accum, plain_pr.state.accum))
        batch = render_linear(scene, cam, cfg, SEED)
        out["batch_bitwise_vs_plain"] = bool(torch.equal(
            batch, render_linear(scene, cam, plain_cfg, SEED)))
        if not (out["progressive_bitwise_vs_plain"]
                and out["batch_bitwise_vs_plain"]):
            raise AssertionError(f"the panel render differs from the plain "
                                 f"route's: {out}")
        err = (resumed.state.accum - batch).abs()
        out["progressive_max_abs_err"] = float(err.max())
        if not bool(torch.isfinite(resumed.state.accum).all()) or bool(
                (err > PROGRESSIVE_ATOL
                 + PROGRESSIVE_RTOL * batch.abs()).any()):
            raise AssertionError(f"progressive render in steps of "
                                 f"{PANEL_STEP} spp differs from the batch "
                                 f"render: max abs err {float(err.max())}")
        reset_counts()
        ones = ProgressiveRenderer(scene, cam, cfg, seed=SEED)
        for _ in range(cfg.spp):
            ones.step(1)
        count("progressive render in 1-spp steps",
              {"fused_hit": cfg.spp * cfg.max_depth})
        out["progressive_1spp_bitwise"] = bool(
            torch.equal(ones.state.accum, batch))
        if not out["progressive_1spp_bitwise"]:
            raise AssertionError("progressive render in 1-spp steps is not "
                                 "bitwise equal to the batch render")

        # (c) Mesh and NEE renders, each PNG the bytes of the plain route's
        # image, and the kernel route's linear image the plain route's.
        for name, extra, expected in (
                ("terrain", [], ("fused_hit", "mesh_first_cluster",
                                 "mesh_search")),
                ("cornell", ["--nee"], ("fused_hit", "fused_hit_shadow"))):
            png = tmp / f"{name}.png"
            reset_counts()
            rc, text = run_cli(cli, ["render", *small_args(name), *extra,
                                     "--out", str(png)])
            per = CLI_SMALL["spp"] * CLI_SMALL["depth"]
            out[f"{name}_launches"] = count(
                f"cli render --scene {name}", dict.fromkeys(expected, per))
            if rc != 0:
                raise AssertionError(f"cli render --scene {name} exited {rc}")
            c = RenderConfig(width=CLI_SMALL["width"],
                             height=CLI_SMALL["height"], spp=CLI_SMALL["spp"],
                             max_depth=CLI_SMALL["depth"], nee=bool(extra))
            plain_c = dataclasses.replace(c, intersector=PLAIN_ROUTE)
            sc, cm = scenes.get_scene(name, c.aspect_ratio)
            if png.read_bytes() != encode_png(render(sc, cm, plain_c,
                                                     SEED).cpu().numpy()):
                raise AssertionError(f"cli render --scene {name} wrote "
                                     f"another image than the plain route")
            if not torch.equal(render_linear(sc, cm, c, SEED),
                               render_linear(sc, cm, plain_c, SEED)):
                raise AssertionError(f"--scene {name}: the kernel route's "
                                     f"linear image is not the plain "
                                     f"route's")
            print(f"cli render --scene {name}: {text.strip()}", flush=True)

    # (d) `invert`: the target render (A1), then train steps on the gradient
    # path (A2 selects, autograd re-derives: the CLI's threefry keys keep
    # the PyTorch route, no diff_bounce launch); with --edge-aware also the
    # background re-trace (A1's exclude instance). Each run's first printed
    # loss is the plain route's first step, printed the same way.
    per = CLI_SMALL["spp"] * CLI_SMALL["depth"]
    for extra, steps, expected, at_least in (
            ([], 2, {"fused_hit": per}, ("fused_hit_shadow",)),
            (["--edge-aware", "--train-camera"], 1, {},
             ("fused_hit", "fused_hit_shadow", "fused_hit[exclude]"))):
        what = " ".join(["cli invert", *extra])
        argv = ["invert", *small_args("random"), "--steps", str(steps),
                *extra]
        reset_counts()
        rc, text = run_cli(cli, argv)
        printed = [line.split()[-1] for line in text.splitlines()
                   if line.startswith("step")]
        launched = count(what, expected, at_least=at_least)
        losses = [float(x) for x in printed]
        if rc != 0 or len(losses) != steps or not all(np.isfinite(losses)):
            raise AssertionError(f"{what}: exit {rc}, losses {losses}")
        if "--train-camera" in extra and "recovered camera origin" not in text:
            raise AssertionError(f"{what} printed no camera origin")
        args = cli.build_parser().parse_args(argv)
        plain_cfg = dataclasses.replace(cli.invert_config(args),
                                        intersector=PLAIN_ROUTE)
        *_, key, target, init_state, step_fn, _ = cli.invert_problem(
            args, plain_cfg, torch.device("cuda", 0))
        _, plain_loss = step_fn(init_state(), target, fold_in(key, 1))
        plain_loss = f"{float(plain_loss):.6f}"
        out[what] = {"losses": losses, "plain_first_loss": plain_loss,
                     "launches": launched}
        if printed[0] != plain_loss:
            raise AssertionError(f"{what}: first loss {printed[0]}, on the "
                                 f"plain route {plain_loss}")
    out["phase_s"] = time.perf_counter() - t0
    return out


def bvh_walk_bound(n: int, live: int, boxes: int, tris: int, mesh,
                   exclude: bool) -> dict:
    """Bound of the BVH walk on n rays (live of them alive): 20 operations
    per node box and 45 per triangle the live rays test (as the plain walk
    counts them); bytes: the rays, alive (and the exclude ids) in, (t, idx)
    out, the node and triangle tables once. Beside it the bytes of every
    node and triangle row the walk reads, each time it reads one."""
    tables = mesh.bvh_escape.shape[0] * NODE_BYTES \
        + mesh.num_triangles * TRI_BYTES
    rays = n * (25 + 4 * exclude + 8)
    return {"boxes_per_live_ray": boxes / max(live, 1),
            "tris_per_live_ray": tris / max(live, 1),
            "bytes_read_per_visit": boxes * NODE_BYTES + tris * TRI_BYTES,
            **bound(boxes * SLAB_FLOPS + tris * MT_FLOPS, rays + tables)}


def walk_wavefront(bw, mi, mc, mesh, o, d, alive, t_min, seed: int,
                   time_plain: bool) -> dict:
    """The walk against its plain version on one wavefront [N, 3]: with
    alive, with each ray's own winner excluded on a random tenth of the
    lanes, and under a finite t_max (the median hit t); live lanes bit for
    bit, (BIG, 0) on dead lanes. Times the kernel, the plain walk (when
    time_plain) and A3 (the clustered search, uncapped) on the same rays,
    and counts the plain walk's work for the bound; with time_plain, the
    exclude instance gets a plain time and a bound of its own."""
    n = o.shape[0]
    live = int(alive.sum())
    t, idx = bw.bvh_walk(mesh, o, d, t_min, alive=alive)
    plain, plain_s = wall_s(lambda: bw.bvh_walk_plain(
        mesh, o, d, t_min, alive=alive, count=True))
    g = torch.Generator(device="cpu").manual_seed(seed)
    tenth = (torch.rand(n, generator=g) < 0.1).to(o.device)
    excl = torch.where(tenth, own_winner(idx, t, alive, bw.BIG), -1)
    plain_x = bw.bvh_walk_plain(mesh, o, d, t_min, alive=alive, exclude=excl,
                                count=time_plain)
    hits = t[alive & (t < bw.BIG)]
    t_max = float(hits.median()) if hits.numel() else bw.BIG
    out = {"rays": n, "live": live, "finite_t_max": t_max,
           "hits": int(hits.numel()), "plain_s": plain_s}
    cases = {"alive": ((t, idx), plain[:2], {}),
             "exclude": (None, plain_x[:2], dict(exclude=excl)),
             "t_max": (None, None, dict(t_max=t_max))}
    for name, (kern, ref, kw) in cases.items():
        tm = kw.pop("t_max", bw.BIG)
        if kern is None:
            kern = bw.bvh_walk(mesh, o, d, t_min, tm, alive=alive, **kw)
        if ref is None:
            ref = bw.bvh_walk_plain(mesh, o, d, t_min, tm, alive=alive, **kw)
        st = compare_t_idx(bw.BIG, kern, ref, alive)
        if not st["bitwise"]:
            raise AssertionError(f"the walk ({name}) is not bitwise equal "
                                 f"to its plain version: {st}")
        if name == "exclude":
            st.update(check_excluded(kern[0], kern[1], excl, alive, bw.BIG,
                                     "the walk"))
        if name == "t_max" and bool((kern[0][alive] > tm).logical_and(
                kern[0][alive] < bw.BIG).any()):
            raise AssertionError("the walk returned a hit beyond t_max")
        st["ms"] = cuda_ms(lambda: bw.bvh_walk(mesh, o, d, t_min, tm,
                                               alive=alive, **kw))
        out[name] = st
    comps = [x[:, k].contiguous() for x in (o, d) for k in range(3)]
    out.update(
        bvh_walk_bound(n, live, plain[2], plain[3], mesh, False),
        ms=out["alive"]["ms"], max_abs_err=0.0,
        a3_ms=cuda_ms(lambda: mi.mesh_search(mc, *comps, t_min,
                                             alive=alive)),
        plain_ms=cuda_ms(lambda: bw.bvh_walk_plain(
            mesh, o, d, t_min, alive=alive), 1) if time_plain else None)
    if time_plain:
        out["exclude"].update(
            bvh_walk_bound(n, live, plain_x[2], plain_x[3], mesh, True),
            plain_ms=cuda_ms(lambda: bw.bvh_walk_plain(
                mesh, o, d, t_min, alive=alive, exclude=excl), 1))
    return out


@contextlib.contextmanager
def capture_exclude_walk(bw):
    """Record the operands of the first walk with exclude made inside the
    block (the edge-aware step's bounce-0 background re-trace): a list that
    holds (mesh, o, d, t_min, t_max, alive, exclude) after the block. The
    walk itself runs unchanged and counts its launch as before."""
    walk, seen = bw.bvh_walk, []

    def spy(mesh, o, d, t_min, t_max=bw.BIG, **kw):
        if not seen and kw.get("exclude") is not None:
            n = o.shape[0]
            alive = kw.get("alive")
            alive = torch.ones(n, dtype=torch.bool, device=o.device) \
                if alive is None else alive
            seen.extend((mesh, o.detach().clone(), d.detach().clone(),
                         float(t_min), float(t_max), alive.clone(),
                         kw["exclude"].clone()))
        return walk(mesh, o, d, t_min, t_max, **kw)

    bw.bvh_walk = spy
    try:
        yield seen
    finally:
        bw.bvh_walk = walk


def walk_step_wavefront(bw, mesh, o, d, t_min, t_max, alive, excl) -> dict:
    """The walk, with and without exclude, against its plain version on the
    wavefront the edge-aware true-Cornell step hands its exclude instance:
    live lanes bit for bit, (BIG, 0) on dead lanes; each timed."""
    out = {"rays": o.shape[0], "live": int(alive.sum()),
           "excluded_lanes": int((alive & (excl >= 0)).sum()),
           "triangles": mesh.num_triangles}
    for name, kw in (("alive", {}), ("exclude", dict(exclude=excl))):
        kern = lambda: bw.bvh_walk(mesh, o, d, t_min, t_max, alive=alive,
                                   **kw)
        plain = lambda: bw.bvh_walk_plain(mesh, o, d, t_min, t_max,
                                          alive=alive, **kw)
        st = compare_t_idx(bw.BIG, kern(), plain(), alive)
        if not st["bitwise"]:
            raise AssertionError(f"the walk ({name}) is not bitwise equal to "
                                 f"its plain version on the Cornell step: "
                                 f"{st}")
        st.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, 1))
        out[name] = st
    return out


def xla_phase(mi, render_linear, RenderConfig, scenes, terrain, book,
              world, camw, cfg5, key, results) -> dict:
    """The portable route, intersector="xla", on the card: (a) the BVH walk
    against its plain version on two terrain wavefronts; (b) the terrain
    1080p frame (exact walk launches) against the default route's frame by
    the flip budget; (c) the book-cover 1080p frame (the [N, S] sphere
    search, no kernel) likewise, with its peak memory; (d) one config-5
    true-Cornell view-step, pathwise and edge-aware (the walk's exclude
    instance in the background re-trace), against the default route's by
    the step criteria of PERF.md section 2, and the walk with and without
    exclude against its plain version on the re-trace's wavefront; (e) a small Cornell-mesh NEE
    frame against the port's vector oracle. Returns its numbers and the
    launches of its counted frames and steps."""
    from qt_raytracer_tpu_torch.core.render import resolve_pixel_chunk
    from qt_raytracer_tpu_torch.testing.oracle_vec import render_oracle_vec
    bw = _bvh_walk_module()
    out = {"launches": dict.fromkeys(KERNELS, 0)}

    def chunks(cfg):
        chunk = resolve_pixel_chunk(cfg)
        return -(-cfg.num_pixels // chunk) if 0 < chunk < cfg.num_pixels \
            else 1

    def count(counts):
        for k, v in counts.items():
            out["launches"][k] += v

    # (a) the walk on the terrain's chunk-2 primary and bounce-2 wavefronts.
    mesh, cfg_t = terrain["world"].mesh, terrain["cfg"]
    walk = {}
    for seed, (name, s) in enumerate(terrain["fronts"].items()):
        o = torch.stack([s.ox, s.oy, s.oz], 1)
        d = torch.stack([s.dx, s.dy, s.dz], 1)
        alive = with_dead_lanes(s.alive, 11 + seed) if name.startswith(
            "primary") else s.alive
        walk[name] = walk_wavefront(bw, mi, terrain["mc"], mesh, o, d, alive,
                                    cfg_t.t_min, seed,
                                    time_plain=name.startswith("primary"))
        print(f"bvh_walk {name}: {json.dumps(walk[name])}", flush=True)
    prim = walk["primary_chunk2"]
    results["bvh_walk"] = (0.0, prim)
    results["bvh_walk[exclude]"] = (0.0, prim["exclude"])
    out["walk"] = walk

    # (b), (c) the frames, each against the default route's frame.
    per = chunks(cfg_t) * cfg_t.max_depth
    frames = {"terrain": (terrain, {"bvh_walk": per}),
              "book_cover": (book, {})}
    for name, (ref, expected) in frames.items():
        scene = ref["world"] if "world" in ref else ref["scene"]
        cfg = dataclasses.replace(ref["cfg"], intersector="xla")
        torch.cuda.reset_peak_memory_stats()
        img, fr = drive_frame(render_linear, scene, ref["camera"], cfg,
                              expected)
        bad = (img - ref["img"]).abs() > IMG_ATOL + IMG_RTOL * ref["img"].abs()
        fr.update(default_steady_s=ref["frame_s"],
                  mismatch_frac_vs_default=float(bad.float().mean()),
                  bitwise_frac_vs_default=float((img == ref["img"]).float()
                                                .mean()),
                  max_memory_allocated_gib=torch.cuda.max_memory_allocated()
                  / 2 ** 30)
        if fr["mismatch_frac_vs_default"] > IMG_MISMATCH_MAX:
            raise AssertionError(f"the xla {name} frame differs from the "
                                 f"default route's frame: {fr}")
        count(fr["launches"])
        out[f"{name}_frame"] = fr
        print(f"xla {name} frame: {json.dumps(fr)}", flush=True)
        del img

    # (d) one config-5 view-step on the true Cornell box, both estimators.
    evals = chunks(cfg5) * cfg5.spp * 2   # forward and its recompute
    bounces = cfg5.max_depth
    tgt = torch.full((cfg5.height, cfg5.width, 3), 0.3,
                     device=camw.origin.device)
    steps = {}
    for est, per_eval, excl in (("pathwise", 2 * bounces, 0),
                                ("edge_aware", 4 * bounces + 2, 1)):
        cfg_e = dataclasses.replace(cfg5, edge_aware=est == "edge_aware")
        default, default_s = wall_s(lambda: view_loss_and_grads(
            world, camw, cfg_e, key, tgt, ("translate",)))
        cfg_x = dataclasses.replace(cfg_e, intersector="xla")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with capture_exclude_walk(bw) as seen:
            got, sec = wall_s(lambda: view_loss_and_grads(
                world, camw, cfg_x, key, tgt, ("translate",)))
        counts = read_counts()
        want = {**dict.fromkeys(KERNELS, 0), "bvh_walk": evals * per_eval,
                "bvh_walk[exclude]": evals * excl}
        if counts != want:
            raise AssertionError(f"xla {est} view-step launched {counts}, "
                                 f"expected {want}")
        g = got[1]["translate"]
        if not (torch.isfinite(got[0]) and bool(torch.isfinite(g).all())
                and float(g.abs().max()) > 0):
            raise AssertionError(f"xla {est} view-step: loss or gradient "
                                 f"not finite and nonzero: {got}")
        steps[est] = {
            "s": sec, "default_s": default_s, "launches": counts,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated()
            / 2 ** 30,
            "vs_default": compare_grads(got, default, GRAD_RTOL_CPU,
                                        f"xla {est} view-step vs default")}
        count(counts)
        print(f"xla view-step {est}: {json.dumps(steps[est])}", flush=True)
        if seen:
            st = walk_step_wavefront(bw, *seen)
            print(f"bvh_walk on the Cornell step's background re-trace: "
                  f"{json.dumps(st)}", flush=True)
            steps[est]["walk_wavefront"] = st
    if "walk_wavefront" not in steps["edge_aware"]:
        raise AssertionError("the edge-aware xla view-step made no walk "
                             "with exclude")
    out["view_steps"] = steps

    # (e) a small frame on the card against the f64 vector oracle.
    cfg_o = RenderConfig(**XLA_ORACLE)
    w_o, c_o = scenes.get_scene("cornell_mesh", cfg_o.aspect_ratio,
                                device=camw.origin.device)
    img = render_linear(w_o, c_o, cfg_o, SEED).double().cpu().numpy()
    ref, oracle_s = wall_s(lambda: render_oracle_vec(w_o, c_o, cfg_o, SEED))
    per_px = np.max(np.abs(img - ref), axis=-1) \
        / (np.max(ref, axis=-1) + 1e-3)
    out["oracle"] = {"size": [cfg_o.width, cfg_o.height, cfg_o.spp,
                              cfg_o.max_depth],
                     "mismatch_frac": float((per_px > 2e-3).mean()),
                     "oracle_s": oracle_s, "finite": bool(np.isfinite(
                         img).all())}
    if not out["oracle"]["finite"] or \
            out["oracle"]["mismatch_frac"] >= XLA_ORACLE_MISMATCH_MAX:
        raise AssertionError(f"the xla frame differs from the f64 oracle: "
                             f"{out['oracle']}")
    print(f"xla frame vs the f64 oracle: {json.dumps(out['oracle'])}",
          flush=True)
    return out


def book_cover(dev, spp: int = 1):
    """The main-path frame: (scene, camera, cfg)."""
    from qt_raytracer_tpu_torch import RenderConfig, scenes
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=spp, max_depth=DEPTH,
                       rng="hash")
    scene, camera = scenes.get_scene("random", cfg.aspect_ratio, device=dev)
    return scene, camera, cfg


def shard_chunks(cfg, mesh) -> int:
    """Pixel chunks of one rank of a sharded render of cfg."""
    from qt_raytracer_tpu_torch.core import render as render_mod
    from qt_raytracer_tpu_torch.parallel import sharding
    shard = sharding._padded_pixels(cfg, mesh.px) // mesh.px
    chunk = render_mod.resolve_pixel_chunk(cfg) or shard
    return -(-shard // chunk)


def c5_view_step(dev, mesh) -> dict:
    """One pathwise config-5 train step on one 1080p view of the sphere
    Cornell box (albedo, emission, pose), sharded over mesh when one is
    given: the loss, the gradients and the parameters after it, the
    step's launches, seconds and peak memory."""
    from qt_raytracer_tpu_torch import RenderConfig, scenes
    from qt_raytracer_tpu_torch.core import sampling
    from qt_raytracer_tpu_torch.diff import inverse as inv
    cfg5 = RenderConfig(**C5)
    sph = scenes.cornell_box_spheres(device=dev)
    cam = scenes.cornell_box_camera(cfg5.aspect_ratio, device=dev)
    key = sampling.prng_key(7, dev)
    with torch.no_grad():
        target = inv.mean_image(sph, cam, cfg5, sampling.fold_in(key, 1),
                                mesh)
    albedo = sph.albedo.clone()
    albedo[6] = torch.tensor([0.2, 0.6, 0.8], device=dev)
    emission = sph.emission.clone()
    emission[5] = 8.0
    wrong = dataclasses.replace(sph, albedo=albedo, emission=emission)
    start = inv.translate_camera(
        cam, torch.tensor(C5_SPHERE_POSE_ERR, device=dev))
    init, step, _, _ = inv.make_train_step(
        wrong, start, cfg5, inv.adam(C5_SPHERE_LR),
        trainable=("albedo", "emission"), train_camera="pose", mesh=mesh)
    state = init()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (state, loss), sec = wall_s(lambda: step(state, target, key))
    counts = read_counts()
    leaves = dict(inv.leaves(state.params))
    return {"loss": loss.cpu(),
            "grads": {p: t.grad.detach().cpu() for p, t in leaves.items()},
            "params": {p: t.detach().cpu() for p, t in leaves.items()},
            "launches": counts, "s": sec,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30}


def dryrun_parts(dev, mesh, tworld, sp: int = 2,
                 intersector: str = "auto") -> dict:
    """The three parts of the JAX package's dryrun_multichip
    (__graft_entry__.py) at its sizes, on the given route, sharded over mesh
    (in one process when mesh is None; sp sets the sample counts either
    way): a three-sphere step on albedo, emission and every camera field; a
    true-Cornell NEE pose step; a forward render of the terrain world tworld
    (99,458 triangles). Returns each step's loss and gradients and the
    terrain image, on the host; raises unless all are finite."""
    from qt_raytracer_tpu_torch import RenderConfig, scenes
    from qt_raytracer_tpu_torch.core import sampling
    from qt_raytracer_tpu_torch.diff import inverse as inv
    from qt_raytracer_tpu_torch.models import meshes
    key = sampling.prng_key(0, dev)

    def step_once(scene, camera, cfg, target_key, **kw):
        with torch.no_grad():
            target = inv.mean_image(scene, camera, cfg, target_key, mesh)
        init, step, _, _ = inv.make_train_step(scene, camera, cfg,
                                               inv.adam(1e-2), mesh=mesh,
                                               **kw)
        state, loss = step(init(), target, key)
        return {"loss": loss.detach().cpu(),
                "grads": {p: t.grad.detach().cpu()
                          for p, t in inv.leaves(state.params)}}

    t0 = time.perf_counter()
    cfg = RenderConfig(width=16, height=12, spp=2 * sp, max_depth=3,
                       samples_per_batch=1, intersector=intersector)
    scene, camera = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                     device=dev)
    out = {"three_sphere": step_once(
        scene, camera, cfg, sampling.fold_in(key, 1),
        trainable=("albedo", "emission"), train_camera=True)}
    t1 = time.perf_counter()
    wcfg = RenderConfig(width=16, height=12, spp=sp, max_depth=3, nee=True,
                        samples_per_batch=1, intersector=intersector)
    world = meshes.cornell_box_world(device=dev)
    wcam = meshes.cornell_box_mesh_camera(wcfg.aspect_ratio, device=dev)
    out["cornell_nee"] = step_once(world, wcam, wcfg,
                                   sampling.fold_in(key, 2), trainable=(),
                                   train_camera="pose")
    t2 = time.perf_counter()
    tcfg = RenderConfig(width=16, height=12, spp=sp, max_depth=2, rng="hash",
                        intersector=intersector)
    tcam = meshes.terrain_camera(tcfg.aspect_ratio, device=dev)
    with torch.no_grad():
        out["terrain"] = inv.mean_image(tworld, tcam, tcfg,
                                        sampling.fold_in(key, 3), mesh).cpu()
    out["part_s"] = [t1 - t0, t2 - t1, time.perf_counter() - t2]
    finite = [out["terrain"]] + [x for part in ("three_sphere", "cornell_nee")
                                 for x in (out[part]["loss"],
                                           *out[part]["grads"].values())]
    if not all(bool(torch.isfinite(x).all()) for x in finite):
        raise AssertionError(f"dryrun parts not finite "
                             f"({intersector}, mesh {mesh})")
    return out


def dryrun_against(got: dict, one: dict, plain: dict, what: str) -> dict:
    """A rank's dryrun parts against one process's on the kernels and on
    the plain route. One sample a rank makes the true-Cornell step's loss
    and the terrain image bit for bit one process's; "sp" reassociates the
    three-sphere step's four samples. Losses and gradients within
    GRAD_RTOL_PLAIN x max|g| of both; the terrain image against the plain
    route's by the flip budget."""
    out = {}
    for part in ("three_sphere", "cornell_nee"):
        g = (got[part]["loss"], got[part]["grads"])
        out[part] = {}
        for ref_name, ref in (("one_process", one), ("plain", plain)):
            cmp = compare_grads(g, (ref[part]["loss"], ref[part]["grads"]),
                                GRAD_RTOL_PLAIN, f"{what} {part} vs "
                                f"{ref_name}")
            # The worst leaf, as a share of its max|g|.
            out[part][f"vs_{ref_name}_rel"] = max(
                v["max_abs_err"] / v["max_abs"] if v["max_abs"] else 0.0
                for k, v in cmp.items() if k != "loss")
    if not torch.equal(got["cornell_nee"]["loss"], one["cornell_nee"]["loss"]):
        raise AssertionError(f"{what}: the true-Cornell loss is not one "
                             f"process's bit for bit: {out['cornell_nee']}")
    img, ref = got["terrain"], plain["terrain"]
    mismatch = float(((img - ref).abs() > IMG_ATOL + IMG_RTOL * ref.abs())
                     .float().mean())
    out["terrain"] = {"bitwise_vs_one_process": torch.equal(
        img, one["terrain"]), "mismatch_frac_vs_plain": mismatch,
        "bitwise_vs_plain": torch.equal(img, ref)}
    if not out["terrain"]["bitwise_vs_one_process"] or \
            mismatch > IMG_MISMATCH_MAX:
        raise AssertionError(f"{what}: the terrain image differs: "
                             f"{out['terrain']}")
    out["part_s"] = got["part_s"]
    return out


def sharded_rank(rank: int, tmp: str) -> None:
    """One of the two ranks of the sharded phase, on the one card over gloo:
    the main-path frame at (sp, px) = (1, 2) and at spp 2 over (2, 1), the
    terrain 1080p frame at (1, 2), the dryrun parts over (2, 1), and the
    config-5 view-step over (1, 2). Saves its images and numbers under
    tmp."""
    import torch.distributed as dist
    from qt_raytracer_tpu_torch import RenderConfig, scenes
    from qt_raytracer_tpu_torch.parallel import distributed, sharding
    dev = distributed.initialize(f"file://{tmp}/store", SHARD_RANKS, rank,
                                 backend="gloo", timeout=SHARD_GROUP_TIMEOUT)
    try:
        out = {}
        cfg_t = RenderConfig(**TERRAIN, rng="hash")
        tworld, tcam = scenes.get_scene("terrain", cfg_t.aspect_ratio,
                                        device=dev)
        frames = {"frame_1x2": (1, *book_cover(dev, 1)),
                  "frame_2x1_spp2": (2, *book_cover(dev, 2)),
                  "terrain_1x2": (1, tworld, tcam, cfg_t)}
        for name, (sp, scene, camera, cfg) in frames.items():
            mesh = sharding.make_mesh(sp=sp)
            reset_counts()
            img, sec = wall_s(lambda: sharding.render_linear_sharded(
                scene, camera, cfg, SEED, mesh))
            out[name] = {"launches": read_counts(), "s": sec,
                         "chunks": shard_chunks(cfg, mesh),
                         "depth": cfg.max_depth}
            torch.save(img.cpu(), pathlib.Path(tmp) / f"{name}_{rank}.pt")
            del img
        reset_counts()
        out["dryrun"], out["dryrun_s"] = wall_s(
            lambda: dryrun_parts(dev, sharding.make_mesh(sp=2), tworld))
        out["dryrun_launches"] = read_counts()
        mesh = sharding.make_mesh(sp=1)
        out["c5"] = c5_view_step(dev, mesh)
        out["c5"]["chunks"] = shard_chunks(RenderConfig(**C5), mesh)
        torch.save(out, pathlib.Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def sharded_phase(render_linear, dev, terrain: dict) -> dict:
    """The sharded render and training (``parallel/``): (1) the main-path
    frame through render_linear_sharded over a world of one on NCCL, bit
    for bit render_linear's, 50 A1 and 50 shading-kernel launches; (2) two
    ranks spawned on the card over gloo: the frame at (1, 2) bit for bit
    (1)'s, at spp 2 over (2, 1) within 3e-7 of render_linear's, and the
    terrain 1080p frame at (1, 2) bit for bit terrain["img"], the
    single-process frame; (3) on the
    same ranks, the dryrun_multichip parts, held against the same parts in
    this process on the kernels and on the plain route (dryrun_against),
    and a config-5 view-step over (1, 2) whose loss equals the
    single-process step's, whose gradients lie within GRAD_RTOL_PLAIN x
    max|g| of it, and whose parameters are equal on both ranks. Every
    rank's launches must be its pixel range's. Raises on any failure."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from qt_raytracer_tpu_torch.parallel import distributed, sharding
    out, launches = {}, dict.fromkeys(KERNELS, 0)
    scene, camera, cfg = book_cover(dev)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(f"file://{tmp}/nccl_store", 1, 0,
                               timeout=SHARD_GROUP_TIMEOUT)
        try:
            mesh = sharding.make_mesh()
            ref = render_linear(scene, camera, cfg, SEED)
            reset_counts()
            img, sec = wall_s(lambda: sharding.render_linear_sharded(
                scene, camera, cfg, SEED, mesh))
            counts = read_counts()
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
        want = {**dict.fromkeys(KERNELS, 0),
                **dict.fromkeys(("fused_hit", "fused_shade"),
                                shard_chunks(cfg, mesh) * DEPTH)}
        if counts != want or not torch.equal(img, ref):
            raise AssertionError(f"world of one: launches {counts} (expected "
                                 f"{want}), equal {torch.equal(img, ref)}")
        out["world_of_one"] = {"backend": backend, "s": sec,
                               "launches": counts["fused_hit"]}
        for k, v in counts.items():
            launches[k] += v
        del img

        ctx = mp.start_processes(sharded_rank, args=(tmp,),
                                 nprocs=SHARD_RANKS, join=False,
                                 start_method="spawn")
        t0 = time.perf_counter()
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > SHARD_JOIN_S:
                    raise TimeoutError(f"the sharded ranks did not finish in "
                                       f"{SHARD_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(pathlib.Path(tmp) / f"rank{r}.pt",
                            weights_only=False) for r in range(SHARD_RANKS)]
        frames = ("frame_1x2", "frame_2x1_spp2", "terrain_1x2")
        images = {name: [torch.load(pathlib.Path(tmp) / f"{name}_{r}.pt")
                         for r in range(SHARD_RANKS)] for name in frames}
    ref = ref.cpu()
    _, _, cfg2 = book_cover(dev, 2)
    ref2 = render_linear(scene, camera, cfg2, SEED).cpu()
    # Sphere frames launch A1 and the shading kernel at every bounce of
    # every chunk; the terrain also A4 and A3.
    kernels_of = {"frame_1x2": ("fused_hit", "fused_shade"),
                  "frame_2x1_spp2": ("fused_hit", "fused_shade"),
                  "terrain_1x2": ("fused_hit", "mesh_first_cluster",
                                  "mesh_search", "fused_shade")}
    for name, want_img in (("frame_1x2", ref), ("frame_2x1_spp2", ref2),
                           ("terrain_1x2", terrain["img"])):
        for r, img in enumerate(images[name]):
            if not torch.equal(img, images[name][0]):
                raise AssertionError(f"{name}: rank {r} differs from rank 0")
        img = images[name][0]
        if name == "frame_2x1_spp2":
            torch.testing.assert_close(img, want_img, rtol=SHARD_RTOL,
                                       atol=SHARD_ATOL)
        elif not torch.equal(img, want_img):
            raise AssertionError(f"{name}: the frame at (1, 2) is not the "
                                 f"single-process frame bit for bit")
        out[name] = {"max_abs_err": float((img - want_img).abs().max()),
                     "bitwise": torch.equal(img, want_img), "ranks": []}
        for r, rk in enumerate(ranks):
            st = rk[name]
            per = st["chunks"] * st["depth"]
            want = {**dict.fromkeys(KERNELS, 0),
                    **dict.fromkeys(kernels_of[name], per)}
            if st["launches"] != want:
                raise AssertionError(f"{name} rank {r}: launches "
                                     f"{st['launches']}, expected {want}")
            out[name]["ranks"].append({"s": st["s"], "launches": {
                k: want[k] for k in kernels_of[name]}})
    del images, ref, ref2

    # The dryrun parts in this process, on the kernels and on the plain
    # route, for the ranks' parts to be held against.
    one = dryrun_parts(dev, None, terrain["world"])
    plain = dryrun_parts(dev, None, terrain["world"], intersector=PLAIN_ROUTE)

    single = c5_view_step(dev, None)
    c5 = {"single_s": single["s"], "single_launches":
          single["launches"]["fused_hit_shadow"],
          "single_max_memory_allocated_gib":
              single["max_memory_allocated_gib"], "ranks": []}
    for r, rk in enumerate(ranks):
        st = rk["c5"]
        # Pathwise: per (chunk, sample), forward and recompute, A2 selects
        # and A2 shadows at every bounce, around F1 and F2; B once.
        want = {**dict.fromkeys(KERNELS, 0), "fused_hit_shadow":
                st["chunks"] * C5["spp"] * 2 * 2 * C5["max_depth"],
                **diff_bounce_counts(st["chunks"] * C5["spp"],
                                     C5["max_depth"])}
        if st["launches"] != want:
            raise AssertionError(f"config-5 view-step rank {r}: launches "
                                 f"{st['launches']}, expected {want}")
        if not torch.equal(st["loss"], single["loss"]):
            raise AssertionError(f"config-5 view-step rank {r}: loss "
                                 f"{float(st['loss'])} against "
                                 f"{float(single['loss'])}")
        cmp = compare_grads((st["loss"], st["grads"]),
                            (single["loss"], single["grads"]),
                            GRAD_RTOL_PLAIN, f"sharded view-step rank {r}")
        for p, t in st["params"].items():
            if not torch.equal(t, ranks[0]["c5"]["params"][p]):
                raise AssertionError(f"config-5 view-step: {p} differs "
                                     f"between rank {r} and rank 0")
        c5["ranks"].append({"s": st["s"], "fused_hit_shadow":
                            want["fused_hit_shadow"],
                            "max_memory_allocated_gib":
                                st["max_memory_allocated_gib"],
                            "vs_single": cmp})
        # The dryrun parts reach the mesh kernels: the mesh search of the
        # terrain and of the Cornell step, the Cornell step's sphere search.
        dry = rk["dryrun_launches"]
        if not all(dry[k] > 0 for k in ("fused_hit", "fused_hit_shadow",
                                        "mesh_search", "sphere_search")):
            raise AssertionError(f"dryrun parts rank {r}: launches {dry}")
        out.setdefault("dryrun", []).append({
            **dryrun_against(rk["dryrun"], one, plain, f"dryrun rank {r}"),
            "s": rk["dryrun_s"],
            "launches": {k: v for k, v in dry.items() if v}})
        for k in KERNELS:
            launches[k] += sum(rk[name]["launches"][k] for name in frames) \
                + st["launches"][k] + dry[k]
    out["c5_view_step_1x2"] = c5
    out["launches"] = launches
    return out


def main() -> None:
    dev = require_card()

    from qt_raytracer_tpu_torch import RenderConfig, render_linear, scenes
    from qt_raytracer_tpu_torch.accel import mesh as mesh_mod
    from qt_raytracer_tpu_torch.core import render as render_mod
    from qt_raytracer_tpu_torch.core import sampling
    from qt_raytracer_tpu_torch.core import integrator_flat as itg
    from qt_raytracer_tpu_torch.core.scene import LAMBERTIAN
    from qt_raytracer_tpu_torch.kernels import fused_hit as fh
    from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi
    from qt_raytracer_tpu_torch.runtime import cuda_build

    phase("build")
    t0 = time.perf_counter()
    lib = cuda_build.load_library()
    print(f"built and loaded {cuda_build.library_path().name} in "
          f"{time.perf_counter() - t0:.3f} s ({lib._name})")
    for line in cuda_build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            print(line.strip())
    print(f"HMMA instructions per A3 kernel instance (cuobjdump -sass): "
          f"{json.dumps(tensor_core_instructions(cuda_build))}", flush=True)

    def primary(camera, cfg, spb=1, index=0):
        """Chunk `index` of cfg's first sample batch, as render_linear makes
        it."""
        chunk = render_mod.resolve_pixel_chunk(cfg) or cfg.num_pixels
        part = slice(index * chunk, (index + 1) * chunk)
        i, j, pix = render_mod.pixel_grid(cfg, dev)
        pk = sampling.pixel_states(SEED, pix[part], cfg.rng)
        rep = lambda x: torch.cat([x] * spb)
        ids = torch.arange(spb, dtype=torch.int64,
                           device=dev).repeat_interleave(chunk)
        keys = sampling.sample_keys(rep(pk), ids if spb > 1 else 0)
        origins, directions = render_mod._camera_rays(camera, cfg, keys,
                                                      rep(i[part]),
                                                      rep(j[part]))
        return itg.initial_state(origins, directions, keys)

    def chunk_count(cfg):
        chunk = render_mod.resolve_pixel_chunk(cfg)
        return -(-cfg.num_pixels // chunk) if 0 < chunk < cfg.num_pixels else 1

    def rays_of(s):
        return (s.ox, s.oy, s.oz, s.dx, s.dy, s.dz)

    results = {}
    launches = dict.fromkeys(KERNELS, 0)

    # ------------------------------------------------------ sphere path
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1, max_depth=DEPTH,
                       rng="hash")
    scene, camera = scenes.get_scene("random", cfg.aspect_ratio)
    if scene.device != dev or camera.device != dev:
        raise AssertionError("get_scene did not build on the card")

    phase("A1, A2 and A5 vs plain versions (book cover, primary and "
          "bounce wavefronts of chunk 0)")
    tables = fh.prep_fused_spheres(scene)
    si = _sphere_search_module()
    s0 = primary(camera, cfg)
    sweep_fronts, bounced = {"primary_chunk0": s0}, s0
    for depth_idx in range(max(SWEEP_DEPTHS)):
        bounced = itg.bounce(tables, bounced, depth_idx, cfg.t_min,
                             interpret=True)
        if depth_idx + 1 in SWEEP_DEPTHS:
            sweep_fronts[f"bounce{depth_idx + 1}"] = bounced
    a1, a2f, a5 = {}, {}, {}
    for name, s in sweep_fronts.items():
        rays = rays_of(s)
        args = (tables, *rays, s.alive, cfg.t_min)
        kern = fh.fused_hit(*args)
        plain = fh.fused_hit_plain(*args)
        torch.cuda.synchronize()
        st = compare_hits(fh, kern, plain, s.alive)
        if not st["bitwise"]:
            raise AssertionError(f"A1 is not bitwise equal to its plain "
                                 f"version ({name}): {st}")
        # In turns, on the same card and inputs.
        st["ms"] = cuda_ms(lambda: fh.fused_hit(*args))
        st["plain_ms"] = cuda_ms(lambda: fh.fused_hit_plain(*args))
        st["rays"] = s.ox.shape[0]
        work = sweep_work(fh, tables.spheres, tables.boxes, rays, s.alive,
                          cfg.t_min)
        st.update(sweep_bound(st["rays"], st["live"], work,
                              tables.spheres.shape[0], 19, full=True))
        a1[name] = st
        print(f"A1 {name}: {json.dumps(st)}", flush=True)
        # A2 on the same rays: the same sweep, (t, idx) out.
        k2 = fh.fused_hit(*args, shadow_only=True)
        p2 = fh.fused_hit_plain(*args, shadow_only=True)
        sh = compare_t_idx(fh.BIG, (k2["t"], k2["idx"]), (p2["t"], p2["idx"]),
                           s.alive)
        if not sh["bitwise"]:
            raise AssertionError(f"A2 is not bitwise equal to its plain "
                                 f"version ({name}): {sh}")
        sh.update(rays=st["rays"],
                  ms=cuda_ms(lambda: fh.fused_hit(*args, shadow_only=True)),
                  plain_ms=cuda_ms(lambda: fh.fused_hit_plain(
                      *args, shadow_only=True)),
                  **sweep_bound(st["rays"], st["live"], work,
                                tables.spheres.shape[0], 2))
        a2f[name] = sh
        print(f"A2 {name}: {json.dumps(sh)}", flush=True)
        o_s = torch.stack(rays[:3], dim=1)
        d_s = torch.stack(rays[3:], dim=1)
        al = with_dead_lanes(s.alive, 1) if name == "primary_chunk0" \
            else s.alive
        a5[name] = compare_search(si, scene, o_s, d_s, al, cfg.t_min)
        print(f"A5 {name}: {json.dumps(a5[name])}", flush=True)
        del kern, plain, k2, p2, o_s, d_s
    results["fused_hit"] = (max(st["max_abs_err"] for st in a1.values()),
                            a1["primary_chunk0"])

    phase("A1 and A2 with the exclude operand vs plain versions (book "
          "cover, each ray excluding its own winner)")
    args = (tables, *rays_of(s0), s0.alive, cfg.t_min)
    first = fh.fused_hit(*args)
    excl = own_winner(first["idx"], first["t"], s0.alive, fh.BIG)
    kern = fh.fused_hit(*args, exclude=excl)
    plain = fh.fused_hit_plain(*args, exclude=excl)
    torch.cuda.synchronize()
    a1x = compare_hits(fh, kern, plain, s0.alive)
    if not a1x["bitwise"]:
        raise AssertionError(f"A1 with exclude is not bitwise equal to its "
                             f"plain version: {a1x}")
    a1x.update(check_excluded(kern["t"], kern["idx"], excl, s0.alive, fh.BIG,
                              "A1"))
    work_x = sweep_work(fh, tables.spheres, tables.boxes, rays_of(s0),
                        s0.alive, cfg.t_min, excl)
    a1x.update(rays=s0.ox.shape[0],
               ms=cuda_ms(lambda: fh.fused_hit(*args, exclude=excl)),
               no_exclude_ms=cuda_ms(lambda: fh.fused_hit(*args),
                                     EXPLORE_RUNS),
               plain_ms=cuda_ms(lambda: fh.fused_hit_plain(*args,
                                                           exclude=excl)),
               **sweep_bound(s0.ox.shape[0], a1x["live"], work_x,
                             tables.spheres.shape[0], 19, full=True,
                             exclude=True))
    print(f"A1 exclude: {json.dumps(a1x)}", flush=True)
    results["fused_hit[exclude]"] = (a1x["max_abs_err"], a1x)
    kern = fh.fused_hit(*args, shadow_only=True, exclude=excl)
    plain = fh.fused_hit_plain(*args, shadow_only=True, exclude=excl)
    a2x = compare_t_idx(fh.BIG, (kern["t"], kern["idx"]),
                        (plain["t"], plain["idx"]), s0.alive)
    if not a2x["bitwise"]:
        raise AssertionError(f"A2 with exclude is not bitwise equal to its "
                             f"plain version: {a2x}")
    a2x.update(check_excluded(kern["t"], kern["idx"], excl, s0.alive, fh.BIG,
                              "A2"))
    a2x.update(ms=cuda_ms(lambda: fh.fused_hit(*args, shadow_only=True,
                                               exclude=excl)),
               no_exclude_ms=cuda_ms(lambda: fh.fused_hit(
                   *args, shadow_only=True), EXPLORE_RUNS),
               plain_ms=cuda_ms(lambda: fh.fused_hit_plain(
                   *args, shadow_only=True, exclude=excl)),
               **sweep_bound(s0.ox.shape[0], a2x["live"], work_x,
                             tables.spheres.shape[0], 2, exclude=True))
    print(f"A2 exclude: {json.dumps(a2x)}", flush=True)
    del first, excl, kern, plain

    phase("shade_kernel vs its plain version (book cover, primary and "
          "bounce-2 wavefronts of chunk 0)")
    shade = {}
    for name, depth_idx in (("primary_chunk0", 0), ("bounce2", 2)):
        s = sweep_fronts[name]
        h = fh.fused_hit(tables, *rays_of(s), s.alive, cfg.t_min)
        shade[f"book_cover {name}"] = st = shade_wavefront(
            itg, s, h, depth_idx, cfg.rr_start, fh.BIG,
            roulette_at=depth_idx)
        print(f"shade_kernel book_cover {name}: {json.dumps(st)}", flush=True)
        del h

    phase("book-cover 1080p frame through render_linear")
    chunks = chunk_count(cfg)
    img, frame = drive_frame(
        render_linear, scene, camera, cfg,
        {**dict.fromkeys(KERNELS, 0), "fused_hit": chunks * DEPTH,
         "fused_shade": chunks * DEPTH})
    frame.update(against_plain_frame(render_linear, scene, camera, cfg, img))
    print(f"frame: {json.dumps(frame)}", flush=True)
    for k, v in frame["launches"].items():
        launches[k] += v
    # Kept for the phase "intersector='xla'".
    xla_book = dict(scene=scene, camera=camera, cfg=cfg, img=img,
                    frame_s=frame["steady_s"])

    phase("small frame on the card vs the CPU")
    small = RenderConfig(width=64, height=36, spp=2, max_depth=6, rng="hash")
    s_cpu, c_cpu = scenes.get_scene("random", small.aspect_ratio,
                                    device="cpu")
    on_card = render_linear(s_cpu.to(dev), c_cpu.to(dev), small, SEED).cpu()
    on_cpu = render_linear(s_cpu, c_cpu, small, SEED)
    bad = ((on_card - on_cpu).abs() > IMG_ATOL + IMG_RTOL * on_cpu.abs())
    print(f"card vs cpu mismatch_frac {float(bad.float().mean())}")
    if float(bad.float().mean()) > IMG_MISMATCH_MAX:
        raise AssertionError("card render disagrees with the CPU render")

    # ------------------------------------------------- mesh-world path
    cfg_t = RenderConfig(**TERRAIN, rng="hash")
    world, camera = scenes.get_scene("terrain", cfg_t.aspect_ratio)
    print(f"terrain: {world.mesh.num_triangles} triangles, BVH builder "
          f"{mesh_mod.last_builder}", flush=True)
    # With the row boxes and the factor planes of A3's other instances.
    wt = itg.prep_world(world, mt="mxu")
    mc = wt.mesh
    print(f"terrain clusters: k = {mc.k}, {mc.tris_per_cluster} triangles "
          f"each", flush=True)

    phase("A4 mesh_first_cluster and A3 mesh_search vs plain versions "
          "(terrain)")
    t_min = cfg_t.t_min
    # Chunk 0 (the top fifth of the frame) sees the ground sphere beyond
    # the terrain; chunk 2 (the middle) sees the terrain.
    s0 = primary(camera, cfg_t)
    s0c2 = primary(camera, cfg_t, index=2)
    s2 = itg.bounce_world(wt, itg.bounce_world(wt, s0c2, 0, t_min), 1, t_min)
    a3, a4 = {}, {}
    a3b = {"rowgate": {}, "mxu": {}}     # A3's other instances
    body_kw = {"rowgate": dict(visit="rowgate"), "mxu": dict(mt="mxu")}
    wavefronts = {"primary_chunk0": s0, "primary_chunk2": s0c2,
                  "bounce2_chunk2": s2}
    for name, s in wavefronts.items():
        rays, alive = rays_of(s), s.alive
        cap = fh.fused_hit(wt.spheres, *rays, alive, t_min)["t"]
        n = rays[0].shape[0]
        # A4, whole wavefront: bitwise.
        c1 = mi.first_crossed_cluster(mc, *rays, t_min, alive, cap)
        c1_p = mi.first_crossed_cluster(mc, *rays, t_min, alive, cap,
                                        interpret=True)
        if not torch.equal(c1, c1_p):
            raise AssertionError(f"A4 differs from its plain version on "
                                 f"{int((c1 != c1_p).sum())} lanes ({name})")
        tested = torch.where(c1 < mc.k, c1 + 1, mc.k)[alive].sum()
        (walk, _), a4_bound = walk_bound(
            mi, mc, rays, alive, cap, t_min, 1, True,
            n * 33 + mc.box_planes.numel() * 4, float(tested))
        if not torch.equal(c1, walk[:, 0]):
            raise AssertionError(f"A4 differs from its gated plain version "
                                 f"({name})")
        a4[name] = {
            **a4_bound,
            "rays": n, "live": int(alive.sum()), "bitwise": True,
            "crossing_share": float((c1[alive] < mc.k).float().mean()),
            "ms": cuda_ms(lambda: mi.first_crossed_cluster(
                mc, *rays, t_min, alive, cap)),
            "plain_ms": cuda_ms(lambda: mi.first_crossed_cluster(
                mc, *rays, t_min, alive, cap, interpret=True), 3)}
        print(f"A4 {name}: {json.dumps(a4[name])}", flush=True)

        # A3 as the path runs it: sort by the crossing key, A3, unsort.
        kern = mi.mesh_search(mc, *rays, t_min, alive=alive, t_cap=cap)
        perm = mi.crossing_order(mc, *rays, t_min, alive, cap)
        srays = tuple(x[perm] for x in rays)
        salive, scap = alive[perm], cap[perm]
        st = {"rays": n, "live": int(alive.sum()),
              "kernel_ms_sorted": cuda_ms(lambda: mi.mesh_hits(
                  mc, *srays, t_min, salive, scap)),
              "kernel_ms_unsorted": cuda_ms(lambda: mi.mesh_hits(
                  mc, *rays, t_min, alive, cap), EXPLORE_RUNS),
              "pipeline_ms": cuda_ms(lambda: mi.mesh_search(
                  mc, *rays, t_min, alive=alive, t_cap=cap), EXPLORE_RUNS)}
        if name.startswith("primary"):
            # The ungated plain sweep over the whole wavefront, once.
            plain, st["plain_s_full"] = wall_s(lambda: mi.mesh_search_plain(
                mc, *rays, t_min, alive, cap))
            st["full"] = compare_t_idx(fh.BIG, kern, plain, alive)
        # Timing and bounce comparison on a strided subset of the sorted
        # wavefront (the order the kernel sees; the plain sweep ignores it).
        sub = torch.arange(0, n, max(n // SUBSET_RAYS, 1),
                           device=dev)[:SUBSET_RAYS]
        r_sub = tuple(x[sub] for x in srays)
        al_sub, cap_sub = salive[sub], scap[sub]
        kern_sub = mi.mesh_hits(mc, *r_sub, t_min, al_sub, cap_sub)
        plain_sub = mi.mesh_search_plain(mc, *r_sub, t_min, al_sub, cap_sub)
        st["subset"] = compare_t_idx(fh.BIG, kern_sub, plain_sub, al_sub)
        if not st["subset"]["bitwise"] or not st.get(
                "full", {"bitwise": True})["bitwise"]:
            raise AssertionError(f"A3 is not bitwise equal to its plain "
                                 f"version ({name}): {st}")
        st["subset_rays"] = int(sub.shape[0])
        st["subset_ms"] = cuda_ms(lambda: mi.mesh_hits(
            mc, *r_sub, t_min, al_sub, cap_sub))
        st["subset_plain_ms"] = cuda_ms(lambda: mi.mesh_search_plain(
            mc, *r_sub, t_min, al_sub, cap_sub), 3)
        # The work the gate lets through on the subset: its bound.
        tg, ig, visits = mi.mesh_search_gated_plain(mc, *r_sub, t_min, al_sub,
                                                    cap_sub)
        if not (torch.equal(tg, plain_sub[0]) and torch.equal(ig,
                                                              plain_sub[1])):
            raise AssertionError("the gated plain sweep differs from the "
                                 "ungated one")
        st["subset_bound"] = a3_bound(mc, "a3", st["subset_rays"],
                                      int(al_sub.sum()), visits)
        # And on the whole sorted wavefront, from the row-gated plain sweep
        # (the cluster visits are those of the VPU instance): the bounds of
        # A3 and A3r at the shape timed. Its bits must be the kernel's.
        gated, gated_s = wall_s(lambda: mi.mesh_search_gated_plain(
            mc, *srays, t_min, salive, scap, visit="rowgate"))
        whole = mi.mesh_hits(mc, *srays, t_min, salive, scap)
        if not all(torch.equal(a, b) for a, b in zip(gated[:2], whole)):
            raise AssertionError(f"A3 differs from the gated plain sweep on "
                                 f"the whole wavefront ({name})")
        st.update(a3_bound(mc, "a3", n, st["live"], gated[2]),
                  ms=st["kernel_ms_sorted"],
                  plain_ms=st["plain_s_full"] * 1e3 if "plain_s_full" in st
                  else None)
        st["pairs_per_live_ray"] = st["visits_per_live_ray"] \
            * mc.tris_per_cluster
        whole_body = {"rowgate": {"plain_ms": gated_s * 1e3, **a3_bound(
            mc, "rowgate", n, st["live"], gated[2], gated[3])}}
        if name != "primary_chunk0":
            # A3m against the gated exact sweep on the whole sorted
            # wavefront, which counts its tiles and filter passes and holds
            # the plain filter sound on every pair: its bits, its counts,
            # its bound.
            kern_m = mi.mesh_hits(mc, *srays, t_min, salive, scap, mt="mxu")
            gm, gm_s = wall_s(lambda: mi.mesh_search_gated_plain(
                mc, *srays, t_min, salive, scap, mt="mxu"))
            if not all(torch.equal(a, b) for a, b in zip(gm[:2], kern_m)):
                raise AssertionError(f"A3 mxu differs from its gated plain "
                                     f"sweep on the whole wavefront ({name})")
            whole_body["mxu"] = {"plain_ms": gm_s * 1e3, **a3_bound(
                mc, "mxu", n, st["live"], gm[2], work=gm[3])}
            print(f"A3 mxu {name} work: {json.dumps(gm[3])}", flush=True)
            del kern_m, gm
        del gated, whole
        if name != "primary_chunk0":
            # The row-gated and bilinear-form instances on the same subset,
            # and on the whole sorted wavefront beside A3.
            for body, kw in body_kw.items():
                bt = compare_body(mi, mc, body, r_sub, al_sub, cap_sub, t_min,
                                  kern_sub,
                                  time_plain=name == "primary_chunk2")
                bt.update(kernel_ms_sorted=cuda_ms(lambda: mi.mesh_hits(
                    mc, *srays, t_min, salive, scap, **kw)),
                    a3_kernel_ms_sorted=st["kernel_ms_sorted"],
                    pipeline_ms=cuda_ms(lambda: mi.mesh_search(
                        mc, *rays, t_min, alive=alive, t_cap=cap, **kw),
                        EXPLORE_RUNS))
                # Timed and bounded on the whole sorted wavefront, as A3;
                # the subset's numbers kept beside.
                bt.update({f"subset_{k}": bt[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_fp32_form_ms") if k in bt})
                bt.update(whole_body[body], ms=bt["kernel_ms_sorted"])
                a3b[body][name] = bt
                print(f"A3 {body} {name}: {json.dumps(bt)}", flush=True)
        if name == "primary_chunk2":
            # The exclude operand on the sorted route: every ray excludes
            # its own winner; the subset's lanes against the plain version.
            excl = own_winner(kern[1], kern[0], alive, fh.BIG)
            kx = mi.mesh_search(mc, *rays, t_min, alive=alive, t_cap=cap,
                                exclude=excl)
            px = mi.mesh_search_plain(mc, *(x[sub] for x in rays), t_min,
                                      alive[sub], cap[sub], exclude=excl[sub])
            sx = compare_t_idx(fh.BIG, (kx[0][sub], kx[1][sub]), px,
                               alive[sub])
            if not sx["bitwise"]:
                raise AssertionError(f"A3 with exclude is not bitwise equal "
                                     f"to its plain version: {sx}")
            sx.update(check_excluded(kx[0], kx[1], excl, alive, fh.BIG, "A3"))
            sexcl = excl[perm]
            sx.update(
                rays=n, subset_rays=int(sub.shape[0]),
                kernel_ms_sorted=cuda_ms(lambda: mi.mesh_hits(
                    mc, *srays, t_min, salive, scap, exclude=sexcl)),
                kernel_ms_sorted_no_exclude=st["kernel_ms_sorted"],
                pipeline_ms=cuda_ms(lambda: mi.mesh_search(
                    mc, *rays, t_min, alive=alive, t_cap=cap, exclude=excl),
                    EXPLORE_RUNS),
                ms=cuda_ms(lambda: mi.mesh_hits(
                    mc, *r_sub, t_min, al_sub, cap_sub, exclude=sexcl[sub])),
                plain_ms=cuda_ms(lambda: mi.mesh_search_plain(
                    mc, *r_sub, t_min, al_sub, cap_sub,
                    exclude=sexcl[sub]), 3))
            # The second hit lies behind the first: at least as much work.
            sx.update({k: st["subset_bound"][k]
                       for k in ("bound_ms", "bound_by")})
            print(f"A3 exclude {name}: {json.dumps(sx)}", flush=True)
            results["mesh_search[exclude]"] = (sx["max_abs_err"], sx)
            # The other instances with the exclude operand, on the subset.
            ex_sub = sexcl[sub]
            a3x_sub = mi.mesh_hits(mc, *r_sub, t_min, al_sub, cap_sub,
                                   exclude=ex_sub)
            for body in body_kw:
                bx = compare_body(mi, mc, body, r_sub, al_sub, cap_sub, t_min,
                                  a3x_sub, exclude=ex_sub)
                a3b[body][f"{name}_exclude"] = bx
                print(f"A3 {body} exclude {name}: {json.dumps(bx)}",
                      flush=True)
            del a3x_sub
            del excl, kx, px, sexcl
        a3[name] = st
        print(f"A3 {name}: {json.dumps(st)}", flush=True)
    results["mesh_first_cluster"] = (0.0, a4["primary_chunk2"])
    results["mesh_search"] = (
        max(*(st["full"]["max_abs_err"] for st in a3.values() if "full" in st),
            *(st["subset"]["max_abs_err"] for st in a3.values())),
        a3["primary_chunk2"])
    for body, runs in a3b.items():
        results[f"mesh_search[{body}]"] = (
            max(st["max_abs_err"] for st in runs.values()),
            runs["primary_chunk2"])

    phase("A3 and A3 rowgate at clusters of 1, 2 and 4 rows (terrain "
          "bounce-2 wavefront of chunk 2)")
    s = wavefronts["bounce2_chunk2"]
    rays, alive = rays_of(s), s.alive
    cap = fh.fused_hit(wt.spheres, *rays, alive, t_min)["t"]
    ref = mi.mesh_search(mc, *rays, t_min, alive=alive, t_cap=cap)
    cluster_sizes(mi, world, rays, alive, cap, t_min, ref)
    del ref

    phase("A7 mesh_crossing_lists, A8 mesh_pairs and the A4 pair vs plain "
          "versions; the pair search vs the clustered search (terrain)")
    mp = _mesh_pairs_module()
    a4p, a7, a8 = {}, {}, {}
    for name in ("primary_chunk0", "primary_chunk2", "bounce2_chunk2"):
        s = wavefronts[name]
        rays, alive = rays_of(s), s.alive
        cap = fh.fused_hit(wt.spheres, *rays, alive, t_min)["t"]
        n, live = rays[0].shape[0], int(alive.sum())
        box_bytes = mc.box_planes.numel() * 4
        # A4 with its second output, whole wavefront: bitwise.
        c12 = mi.first_crossed_cluster(mc, *rays, t_min, alive, cap,
                                       pair=True)
        c12_p = mi.first_crossed_cluster(mc, *rays, t_min, alive, cap,
                                         pair=True, interpret=True)
        if not all(torch.equal(a, b) for a, b in zip(c12, c12_p)):
            raise AssertionError(f"the A4 pair differs from its plain "
                                 f"version ({name})")
        tested = torch.where(c12[1] < mc.k, c12[1] + 1, mc.k)[alive].sum()
        (walk, _), a4p_bound = walk_bound(mi, mc, rays, alive, cap, t_min, 2,
                                          True, n * 37 + box_bytes,
                                          float(tested))
        if not (torch.equal(c12[0], walk[:, 0])
                and torch.equal(c12[1], walk[:, 1])):
            raise AssertionError(f"the A4 pair differs from its gated plain "
                                 f"version ({name})")
        a4p[name] = {
            **a4p_bound,
            "rays": n, "live": live, "bitwise": True, "max_abs_err": 0.0,
            "second_crossing_share": float((c12[1][alive] < mc.k).float()
                                           .mean()),
            "ms": cuda_ms(lambda: mi.first_crossed_cluster(
                mc, *rays, t_min, alive, cap, pair=True)),
            "plain_ms": cuda_ms(lambda: mi.first_crossed_cluster(
                mc, *rays, t_min, alive, cap, pair=True, interpret=True), 3)}
        print(f"A4 pair {name}: {json.dumps(a4p[name])}", flush=True)

        # A7, whole wavefront: bitwise lists and counts.
        lists, ncross = mp.crossing_lists(mc, *rays, t_min, alive, cap,
                                          PAIR_C)
        lists_p, ncross_p = mp.crossing_lists(mc, *rays, t_min, alive, cap,
                                              PAIR_C, interpret=True)
        if not (torch.equal(lists, lists_p) and torch.equal(ncross,
                                                            ncross_p)):
            raise AssertionError(f"A7 differs from its plain version "
                                 f"({name})")
        if not (torch.equal(lists[:, 0], c12[0])
                and torch.equal(lists[:, 1], c12[1])):
            raise AssertionError("A7's first two ids are not A4's")
        walk, a7_bound = walk_bound(mi, mc, rays, alive, cap, t_min, PAIR_C,
                                    False, n * (33 + 4 * (PAIR_C + 1))
                                    + box_bytes, float(live) * mc.k)
        if not (torch.equal(lists, walk[0]) and torch.equal(ncross,
                                                            walk[1])):
            raise AssertionError(f"A7 differs from its gated plain version "
                                 f"({name})")
        unsafe = ncross > PAIR_C
        pairs = int(torch.clamp_max(ncross, PAIR_C).sum())
        a7[name] = {
            **a7_bound,
            "rays": n, "live": live, "bitwise": True, "max_abs_err": 0.0,
            "crossings_per_live_ray": float(ncross[alive].float().mean()),
            "share_over_c": float(unsafe[alive].float().mean()),
            "max_crossings": int(ncross.max()),
            "pairs": pairs,
            "ms": cuda_ms(lambda: mp.crossing_lists(
                mc, *rays, t_min, alive, cap, PAIR_C)),
            "plain_ms": cuda_ms(lambda: mp.crossing_lists(
                mc, *rays, t_min, alive, cap, PAIR_C, interpret=True), 3)}
        print(f"A7 {name}: {json.dumps(a7[name])}", flush=True)

        # The whole pair search against the clustered search: bitwise on
        # live lanes, (BIG, 0) on dead ones; then its stages' times.
        ref = mi.mesh_search(mc, *rays, t_min, alive=alive, t_cap=cap)
        got = mp.mesh_search_pairs(mc, *rays, t_min, alive, cap,
                                   pair_c=PAIR_C)
        torch.cuda.synchronize()
        st = compare_t_idx(fh.BIG, got, ref, alive)
        if not st["bitwise"]:
            raise AssertionError(f"the pair search is not bitwise equal to "
                                 f"the clustered search ({name}): {st}")
        ray_buf, gmap = mp.pair_slots(lists, mc.k)
        valid = ray_buf >= 0
        tp, ip = mp.pair_hits(mc, *rays, cap, ray_buf, gmap, t_min)
        num_tris = mc.k * mc.tris_per_cluster
        live_tiles = int(valid.view(-1, 128).any(dim=1).sum())
        st.update(
            rays=n, pairs=pairs, slots=int(ray_buf.shape[0]),
            padded_slots=live_tiles * 128, tiles=int(gmap.shape[0]),
            a7_ms=a7[name]["ms"],
            a8_ms=cuda_ms(lambda: mp.pair_hits(mc, *rays, cap, ray_buf, gmap,
                                               t_min)),
            glue_ms=cuda_ms(lambda: (
                mp.pair_slots(lists, mc.k),
                mp.reduce_pairs(ray_buf, tp, ip, n, num_tris)), EXPLORE_RUNS),
            fallback_ms=cuda_ms(lambda: mi.mesh_search(
                mc, *rays, t_min, alive=unsafe, t_cap=cap), EXPLORE_RUNS),
            pair_search_ms=cuda_ms(lambda: mp.mesh_search_pairs(
                mc, *rays, t_min, alive, cap, pair_c=PAIR_C), EXPLORE_RUNS),
            clustered_search_ms=cuda_ms(lambda: mi.mesh_search(
                mc, *rays, t_min, alive=alive, t_cap=cap), EXPLORE_RUNS))
        print(f"pair search {name}: {json.dumps(st)}", flush=True)
        # A8, whole wavefront, on the slots the pair search hands it:
        # bitwise on every slot against its plain version and against the
        # row-gated plain sweep, which counts the rows its gate opens.
        tp_p, ip_p = mp.pair_hits(mc, *rays, cap, ray_buf, gmap, t_min,
                                  interpret=True)
        tp_g, ip_g, rows = mp.pair_hits_gated_plain(mc, *rays, cap, ray_buf,
                                                    gmap, t_min)
        if not all(torch.equal(a, b) for a, b in ((tp, tp_p), (ip, ip_p),
                                                  (tp, tp_g), (ip, ip_g))):
            raise AssertionError(f"A8 differs from its plain versions "
                                 f"({name})")
        a8[name] = {
            **a8_bound(mc, pairs, int(rows.sum()), ray_buf.shape[0]),
            "rays": n, "pairs": pairs, "slots": st["slots"],
            "tiles": st["tiles"], "bitwise": True, "max_abs_err": 0.0,
            "hits": int((tp < fh.BIG).sum()), "ms": st["a8_ms"],
            "plain_ms": cuda_ms(lambda: mp.pair_hits(
                mc, *rays, cap, ray_buf, gmap, t_min, interpret=True), 3)}
        print(f"A8 {name}: {json.dumps(a8[name])}", flush=True)
        del lists, lists_p, ncross, ncross_p, ray_buf, tp, ip, tp_p, ip_p
        del tp_g, ip_g, rows
        del got, ref
    results["mesh_first_cluster[pair]"] = (0.0, a4p["bounce2_chunk2"])
    results["mesh_crossing_lists"] = (0.0, a7["bounce2_chunk2"])
    results["mesh_pairs"] = (0.0, a8["bounce2_chunk2"])

    phase("shade_kernel vs its plain version (terrain, primary and "
          "bounce-2 wavefronts of chunk 2)")
    for name, depth_idx in (("primary_chunk2", 0), ("bounce2_chunk2", 2)):
        s = wavefronts[name]
        h = itg._world_hit_flat(wt, *rays_of(s), s.alive, t_min, False,
                                depth_idx)
        shade[f"terrain {name}"] = st = shade_wavefront(
            itg, s, h, depth_idx, cfg_t.rr_start, fh.BIG,
            roulette_at=depth_idx)
        print(f"shade_kernel terrain {name}: {json.dumps(st)}", flush=True)
        del h
    results["fused_shade"] = (0.0, shade["book_cover primary_chunk0"])

    phase("terrain 1080p frame (BASELINE config 4) through render_linear")
    chunks = chunk_count(cfg_t)
    per = chunks * cfg_t.max_depth
    img_t, frame = drive_frame(
        render_linear, world, camera, cfg_t,
        {"fused_hit": per, "mesh_first_cluster": per, "mesh_search": per,
         "fused_shade": per})
    w, h = TERRAIN_PLAIN_WH
    frame["vs_plain"] = against_plain_frame(
        render_linear, world, camera,
        dataclasses.replace(cfg_t, width=w, height=h))
    print(f"terrain frame: {json.dumps(frame)}", flush=True)
    for k, v in frame["launches"].items():
        launches[k] += v

    phase("terrain 1080p frame with the pair-wavefront mesh search, the "
          "two-cluster sort key, compacted, row-gated and in one-row "
          "clusters: bit-identical; with the bilinear form: in the budget")
    # Every world hit of "pairs" runs A7, A8 and the fallback (A4, A3);
    # "hybrid" runs the clustered search alone at each chunk's bounce 0.
    bounce_hits = chunks * (cfg_t.max_depth - 1)
    variants = {
        "hybrid": (dict(mesh_kernel="hybrid"),
                   {"mesh_crossing_lists": bounce_hits,
                    "mesh_pairs": bounce_hits}),
        "pairs": (dict(mesh_kernel="pairs"),
                  {"mesh_crossing_lists": per, "mesh_pairs": per}),
        "compact": (dict(mesh_compact=True), {}),
        "sort0_off": (dict(mesh_sort0=False),
                      {"mesh_first_cluster": bounce_hits}),
        "crossing2": (dict(mesh_sort_mode="crossing2"),
                      {"mesh_first_cluster": 0,
                       "mesh_first_cluster[pair]": per}),
        "rowgate": (dict(mesh_visit="rowgate"),
                    {"mesh_search[rowgate]": per}),
        "cluster_rows_1": (dict(mesh_cluster_rows=1), {}),
        "mxu": (dict(mesh_mt="mxu"), {"mesh_search[mxu]": per}),
    }
    for name, (option, counts) in variants.items():
        img_v, fr = drive_frame(
            render_linear, world, camera,
            dataclasses.replace(cfg_t, **option),
            {"fused_hit": per, "mesh_first_cluster": per, "mesh_search": per,
             "fused_shade": per, **counts})
        if name == "mxu":
            # Its candidates round otherwise: the flip budget, not the bits.
            bad = (img_v - img_t).abs() > IMG_ATOL + IMG_RTOL * img_t.abs()
            fr["mismatch_frac_vs_default"] = float(bad.float().mean())
            fr["bitwise_frac_vs_default"] = float((img_v == img_t).float()
                                                  .mean())
            if fr["mismatch_frac_vs_default"] > IMG_MISMATCH_MAX:
                raise AssertionError(f"the mxu terrain frame differs from "
                                     f"the default frame: {fr}")
        elif not torch.equal(img_v, img_t):
            raise AssertionError(f"the {name} terrain frame is not "
                                 f"bit-identical to the default frame")
        else:
            fr["bit_identical"] = True
        print(f"terrain frame {name}: {json.dumps(fr)}", flush=True)
        for k, v in fr["launches"].items():
            launches[k] += v
    # Kept for the phase "intersector='xla'".
    xla_terrain = dict(world=world, camera=camera, cfg=cfg_t, img=img_t,
                       frame_s=frame["steady_s"], mc=mc,
                       fronts={k: wavefronts[k] for k in ("primary_chunk2",
                                                          "bounce2_chunk2")})
    del world, wt, mc, s0, s0c2, s2, wavefronts, img_t, img_v

    # ------------------------------------- mesh-world path with NEE
    cfg_c = RenderConfig(**CORNELL, rng="hash")
    world, camera = scenes.get_scene("cornell_mesh", cfg_c.aspect_ratio)
    print(f"cornell_mesh: {world.mesh.num_triangles} triangles, "
          f"{world.mesh.num_lights} emissive, BVH builder "
          f"{mesh_mod.last_builder}", flush=True)
    wt = itg.prep_world(world)

    phase("A2 fused_hit_shadow vs plain version (Cornell mesh shadow rays)")
    t_min = cfg_c.t_min
    s1 = itg.bounce_world(wt, primary(camera, cfg_c, cfg_c.samples_per_batch),
                          0, t_min, nee=True)
    hit = itg._world_hit_flat(wt, *rays_of(s1), s1.alive, t_min, False)
    uni = sampling.stream_uniforms(s1.keys, sampling.STREAM_BOUNCE0 + 1,
                                   sampling.UNIFORMS_PER_BOUNCE)
    diffuse = s1.alive & (hit["t"] < fh.BIG) & (hit["mat"] == LAMBERTIAN)
    ldx, ldy, ldz, cand, *_ = itg._nee_shadow_rays_world(
        wt.lights, hit["px"], hit["py"], hit["pz"], hit["nx"], hit["ny"],
        hit["nz"], diffuse, uni)
    srays = (hit["px"], hit["py"], hit["pz"], ldx, ldy, ldz)
    args = (wt.spheres, *srays, cand, t_min)
    kern = fh.fused_hit(*args, shadow_only=True)
    plain = fh.fused_hit_plain(*args, shadow_only=True)
    a2 = compare_t_idx(fh.BIG, (kern["t"], kern["idx"]),
                       (plain["t"], plain["idx"]), cand)
    if not a2["bitwise"]:
        raise AssertionError(f"A2 is not bitwise equal to its plain version "
                             f"(Cornell shadow rays): {a2}")
    work = sweep_work(fh, wt.spheres.spheres, wt.spheres.boxes, srays, cand,
                      t_min)
    a2.update(rays=srays[0].shape[0], depth_idx=1,
              ms=cuda_ms(lambda: fh.fused_hit(*args, shadow_only=True)),
              plain_ms=cuda_ms(lambda: fh.fused_hit_plain(
                  *args, shadow_only=True)),
              **sweep_bound(srays[0].shape[0], a2["live"], work,
                            wt.spheres.spheres.shape[0], 2))
    print(f"A2 shadow wavefront: {json.dumps(a2)}", flush=True)
    results["fused_hit_shadow"] = (a2["max_abs_err"], a2)
    # The shadow ray's mesh search, capped by A2's unrefined t (one
    # cluster: no sort).
    k3 = mi.mesh_search(wt.mesh, *srays, t_min, alive=cand, t_cap=kern["t"])
    p3 = mi.mesh_search_plain(wt.mesh, *srays, t_min, cand, kern["t"])
    a3_sh = compare_t_idx(fh.BIG, k3, p3, cand)
    if not a3_sh["bitwise"]:
        raise AssertionError(f"A3 is not bitwise equal to its plain version "
                             f"(Cornell shadow rays): {a3_sh}")
    a3_sh.update(
        ms=cuda_ms(lambda: mi.mesh_search(wt.mesh, *srays, t_min, alive=cand,
                                          t_cap=kern["t"])),
        plain_ms=cuda_ms(lambda: mi.mesh_search_plain(
            wt.mesh, *srays, t_min, cand, kern["t"]), 3))
    print(f"A3 Cornell shadow wavefront: {json.dumps(a3_sh)}", flush=True)
    results["mesh_search"] = (max(results["mesh_search"][0],
                                  a3_sh["max_abs_err"]),
                              results["mesh_search"][1])
    del hit, uni, diffuse, ldx, ldy, ldz, cand, srays, args, kern, plain

    phase("Cornell mesh 512x512 64 spp NEE frame (BASELINE config 2)")
    chunks = chunk_count(cfg_c)
    per = chunks * (cfg_c.spp // cfg_c.samples_per_batch) * cfg_c.max_depth
    _, frame = drive_frame(
        render_linear, world, camera, cfg_c,
        {"fused_hit": per, "fused_hit_shadow": per, "mesh_search": 2 * per})
    frame["vs_plain"] = against_plain_frame(
        render_linear, world, camera,
        dataclasses.replace(cfg_c, spp=CORNELL_PLAIN_SPP))
    print(f"cornell_mesh frame: {json.dumps(frame)}", flush=True)
    for k, v in frame["launches"].items():
        launches[k] += v

    phase("sphere-scene NEE on the card vs the CPU")
    nee_cfg = RenderConfig(width=64, height=64, spp=4, max_depth=10,
                           nee=True, rr_start=2, rng="hash")
    s_cpu, c_cpu = scenes.get_scene("cornell", nee_cfg.aspect_ratio,
                                    device="cpu")
    reset_counts()
    on_card = render_linear(s_cpu.to(dev), c_cpu.to(dev), nee_cfg, SEED)
    counts = read_counts()
    on_card = on_card.cpu()
    on_cpu = render_linear(s_cpu, c_cpu, nee_cfg, SEED)
    bad = float(((on_card - on_cpu).abs()
                 > IMG_ATOL + IMG_RTOL * on_cpu.abs()).float().mean())
    print(f"sphere NEE: launches {counts}, card vs cpu mismatch_frac {bad}")
    if counts["fused_hit"] == 0 or counts["fused_hit_shadow"] == 0 or \
            not bool(torch.isfinite(on_card).all()) or bad > IMG_MISMATCH_MAX:
        raise AssertionError("sphere NEE on the card disagrees with the CPU")

    # -------------------------- clustered sphere search (A6) and its frame
    phase(f"A6 sphere_search_clustered vs plain versions ({A6_SPHERES} "
          f"spheres; tied copies and a hollow sphere in 2,112 slots)")
    many, cam6, cfg6 = clustered_scene()
    tab6 = si.prep_sphere_search(many)
    mono6 = si.prep_sphere_search(many, min_chunks=10 ** 6)
    if tab6.num_chunks == 0 or mono6.num_chunks > 0:
        raise AssertionError("the clustered table was not built")
    print(f"clustered scene: {many.num_spheres} slots, {tab6.num_chunks} "
          f"chunks of {si.CHUNK_S}", flush=True)
    fronts6 = {name: (tab6, mono6, *front) for name, front in
               clustered_wavefronts(many, primary(cam6, cfg6, index=2),
                                    cfg6.t_min).items()}
    ties, tie_rays, tie_alive = tie_wavefront(2112, 414720, 8)
    fronts6["ties_2112_slots"] = (
        si.prep_sphere_search(ties),
        si.prep_sphere_search(ties, min_chunks=10 ** 6), tie_rays, tie_alive)
    a6 = {}
    for name, (tab, mono_tab, rays, al) in fronts6.items():
        run = lambda tab_, **kw: si.sphere_search_flat(tab_, *rays, al,
                                                       cfg6.t_min, **kw)
        before = read_counts()["sphere_search_clustered"]
        kern, plain, mono = run(tab), run(tab, interpret=True), run(mono_tab)
        if read_counts()["sphere_search_clustered"] != before + 1:
            raise AssertionError("the clustered table did not take A6")
        gated = si.sphere_search_clustered_gated_plain(tab, *rays, al,
                                                       cfg6.t_min)
        torch.cuda.synchronize()
        st = compare_t_idx(si.BIG, kern, plain, al)
        if not st["bitwise"] or not all(
                torch.equal(a, b) for a, b in zip(kern, gated[:2])) or not (
                torch.equal(kern[0][al], mono[0][al])
                and torch.equal(kern[1][al], mono[1][al])):
            raise AssertionError(f"A6 is not bitwise equal to its plain "
                                 f"versions and to A5 on live lanes "
                                 f"({name}): {st}")
        # The work the gates leave: (live lane, slot of a group its own
        # gate opens in a chunk its row opens), the group gate tests of the
        # row's open chunks, the chunk tests; and the parent's count, every
        # slot of the row's open chunks.
        slots, opened, rows_live = 0, 0, 0
        for lo in range(0, al.shape[0], 65536):
            part = slice(lo, lo + 65536)
            gate = si.chunk_gate(tab, *(x[part] for x in rays), al[part],
                                 cfg6.t_min)
            live_row = al[part].reshape(-1, si.ROW).sum(dim=1)
            slots += int((gate.sum(dim=1) * live_row).sum()) * si.CHUNK_S
            opened += int(gate.sum())
            rows_live += int((live_row > 0).sum())
        tests = slots // si.GROUP_S
        groups = int(gated[2].sum())
        n6, live6 = al.shape[0], st["live"]
        nbytes = n6 * 33 + tab.spheres.numel() * 4 \
            + tab.boxes.numel() * 4 + tab.chunk_boxes.numel() * 4
        st.update(
            rays=n6, dead_lanes=int((~al).sum()), chunks=tab.num_chunks,
            open_chunks_per_live_row=opened / max(rows_live, 1),
            groups_per_live_lane=groups / max(live6, 1),
            ms=cuda_ms(lambda: run(tab)),
            plain_ms=cuda_ms(lambda: run(tab, interpret=True), 3),
            a5_ms=cuda_ms(lambda: run(mono_tab)),
            a5_plain_ms=cuda_ms(lambda: run(mono_tab, interpret=True), 3),
            a5_bound_ms=sweep_bound(
                n6, live6, sweep_work(fh, mono_tab.spheres, mono_tab.boxes,
                                      rays, al, cfg6.t_min),
                mono_tab.spheres.shape[0], 2)["bound_ms"],
            bound_chunks_ms=bound(
                slots * SWEEP_FLOPS + live6 * tab.num_chunks * SLAB_FLOPS,
                nbytes)["bound_ms"],
            **bound(groups * si.GROUP_S * SWEEP_FLOPS
                    + (tests + live6 * tab.num_chunks) * SLAB_FLOPS, nbytes))
        if name.startswith("ties"):
            st["hollow_hits"] = int((plain[1][al] == 45).sum())
            if st["hollow_hits"] == 0:
                raise AssertionError("no ray reached the hollow sphere")
        a6[name] = st
        print(f"A6 {name}: {json.dumps(st)}", flush=True)
    results["sphere_search_clustered"] = (
        max(st["max_abs_err"] for st in a6.values()), a6["primary_chunk2"])
    del fronts6, kern, plain, mono, gated, ties, tie_rays, tie_alive

    phase("clustered-scene 1080p frame through render_linear "
          "(intersector 'pallas')")
    img, frame = drive_frame(
        render_linear, many, cam6, cfg6,
        {"sphere_search_clustered": chunk_count(cfg6) * DEPTH})
    frame.update(against_plain_frame(render_linear, many, cam6, cfg6, img,
                                     plain="pallas_interpret"))
    print(f"clustered frame: {json.dumps(frame)}", flush=True)
    for k, v in frame["launches"].items():
        launches[k] += v
    del img, many, tab6, mono6

    phase("threefry on the card vs the CPU")
    n_pix = cfg.num_pixels
    pix = torch.arange(n_pix, dtype=torch.int64)
    tf = []
    for dev_ in (dev, torch.device("cpu")):
        key = sampling.fold_in(sampling.prng_key(7, dev_), 3)
        pk = sampling.pixel_states(key, pix.to(dev_), "threefry")
        sk = sampling.sample_keys(pk, 1)
        sk_ids = sampling.sample_keys(pk, pix.to(dev_) % 5)
        tf.append([key, pk, sk, sk_ids,
                   sampling.stream_uniforms(sk, sampling.STREAM_BOUNCE0, 8),
                   sampling.hash_pixel_states(key, pix.to(dev_))])
    for a, b in zip(*tf):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("threefry differs between the card and the "
                                 "CPU")
    print(f"threefry: fold_in, pixel_states, sample_keys, stream_uniforms "
          f"and hash states from a folded key bitwise equal over "
          f"{n_pix} pixels", flush=True)
    del tf

    # ----------------------------- gradient path: BASELINE config 5
    from qt_raytracer_tpu_torch.diff import inverse as inv
    from qt_raytracer_tpu_torch.diff import multiview as mv
    from qt_raytracer_tpu_torch.models import meshes
    train_launches = dict.fromkeys(KERNELS, 0)

    phase("A5 sphere_search vs plain version (config-5 NEE shadow rays)")
    cfg5 = RenderConfig(**C5)
    sph = scenes.cornell_box_spheres().to(dev)
    cam5 = scenes.cornell_box_camera(cfg5.aspect_ratio).to(dev)
    sh0 = primary(cam5, cfg5)
    tab5 = fh.prep_fused_spheres(sph)
    hit = fh.fused_hit(tab5, *rays_of(sh0), sh0.alive, cfg5.t_min)
    uni = sampling.stream_uniforms(sh0.keys, sampling.STREAM_BOUNCE0,
                                   sampling.UNIFORMS_PER_BOUNCE)
    lp = tab5.params[sph.light_idx.long()[0]]
    ldx, ldy, ldz, _, ok = itg._cone_sample(
        lp[0], lp[1], lp[2], lp[3], hit["px"], hit["py"], hit["pz"],
        uni[:, 5], uni[:, 6])
    cos_s = hit["nx"] * ldx + hit["ny"] * ldy + hit["nz"] * ldz
    cand = sh0.alive & (hit["t"] < fh.BIG) & (hit["mat"] == LAMBERTIAN) \
        & ok & (cos_s > 0.0)
    o5 = torch.stack([hit["px"], hit["py"], hit["pz"]], dim=1)
    d5 = torch.stack([ldx, ldy, ldz], dim=1)
    a5["c5_shadow_chunk0"] = compare_search(si, sph, o5, d5, cand, cfg5.t_min)
    print(f"A5 c5_shadow_chunk0: {json.dumps(a5['c5_shadow_chunk0'])}",
          flush=True)
    results["sphere_search"] = (max(st["max_abs_err"] for st in a5.values()),
                                a5["primary_chunk0"])
    # The exclude operand: every shadow ray excludes its own blocker (or
    # the light it reaches), so the search shows what lies behind it.
    t5, i5 = si.sphere_search(sph, o5, d5, cfg5.t_min, alive=cand)
    excl = own_winner(i5, t5, cand, si.BIG)
    a5x = compare_search(si, sph, o5, d5, cand, cfg5.t_min, exclude=excl)
    kx = si.sphere_search(sph, o5, d5, cfg5.t_min, alive=cand, exclude=excl)
    a5x.update(check_excluded(kx[0], kx[1], excl, cand, si.BIG, "A5"))
    a5x["no_exclude_ms"] = a5["c5_shadow_chunk0"]["ms"]
    print(f"A5 exclude c5_shadow_chunk0: {json.dumps(a5x)}", flush=True)
    results["sphere_search[exclude]"] = (a5x["max_abs_err"], a5x)
    del o5, d5, t5, i5, excl, kx
    del sh0, hit, uni, ldx, ldy, ldz, ok, cos_s, cand

    phase("differentiable bounce: F1, F2 and B vs the PyTorch route "
          "(config-5 chunk-2 wavefront)")
    from qt_raytracer_tpu_torch.kernels import diff_bounce as db
    dbw = diff_bounce_wavefront(itg, db, fh, cuda_build, tab5,
                                primary(cam5, cfg5, index=2), sph.light_idx,
                                cfg5.t_min)
    print(f"diff_bounce c5_chunk2: {json.dumps(dbw)}", flush=True)
    for name, part in (("diff_bounce", "F2"),
                       ("diff_bounce[shadow_rays]", "F1"),
                       ("diff_bounce[backward]", "B")):
        plain_ms = dbw["bounce_backward_plain_ms"] if part == "B" else \
            dbw["bounce_forward_plain_ms"]
        results[name] = ((dbw["grad_rel_err"] if part == "B" else 0.0),
                         {**dbw[part], "plain_ms": plain_ms})

    # (chunk, sample) evaluations per view-step: forward and recompute.
    evals = chunk_count(cfg5) * cfg5.spp * 2
    bounces = cfg5.max_depth

    phase("config 5, sphere Cornell box, 1920x1080, 4 views: 1 pathwise and "
          "2 edge-aware train steps")
    true_cams = mv.orbit_cameras(cam5, C5_SPHERE_VIEWS)
    key7 = sampling.prng_key(7, dev)
    targets, tgt_s = wall_s(lambda: torch.stack([
        inv.mean_image(sph, c, cfg5, sampling.fold_in(key7, v))
        for v, c in enumerate(true_cams)]))
    albedo = sph.albedo.clone()
    albedo[6] = torch.tensor([0.2, 0.6, 0.8], device=dev)
    emission = sph.emission.clone()
    emission[5] = 8.0
    wrong = dataclasses.replace(sph, albedo=albedo, emission=emission)
    pose_err = torch.tensor(C5_SPHERE_POSE_ERR, device=dev)
    start = tuple(inv.translate_camera(c, pose_err) for c in true_cams)
    make = lambda edge: mv.make_multiview_train_step(
        wrong, start, cfg5, inv.adam(C5_SPHERE_LR),
        trainable=("albedo", "emission"), train_camera="pose",
        edge_aware=edge)
    init, step, rebuild, _ = make(False)
    _, step_edge, _, _ = make(True)
    views = len(true_cams)

    def sphere_errs(st):
        rec = rebuild(st.params["scene"])
        tr = st.params["camera"]["translate"].detach()
        return {"albedo_err": float((rec.albedo[6] - sph.albedo[6]).abs()
                                    .max()),
                "emission_err": float((rec.emission[5] - sph.emission[5])
                                      .abs().max()),
                "pose_err": float((tr + pose_err).abs().max())}

    with torch.no_grad():
        print(f"targets: 4 views in {tgt_s:.3f} s; start "
              f"{json.dumps(sphere_errs(init()))}", flush=True)
    # Pathwise: per evaluation A2 selects and A2 shadows at every bounce,
    # around F1 and F2; B once a (chunk, sample) and bounce.
    units = views * evals // 2
    _, c5s, counts, g_path = train_steps(
        step, init(), targets, key7, sphere_errs, C5_PATHWISE_STEPS,
        {"fused_hit_shadow": views * evals * 2 * bounces,
         **diff_bounce_counts(units, bounces)})
    for k, v in counts.items():
        train_launches[k] += v
    # Edge-aware, per evaluation: the pathwise trace (2 A2 per bounce), A1
    # for the bounce-0 winner, the background re-trace (A1 and an A2 shadow
    # per bounce, the first A1 with the exclude operand) and one A5 for
    # the first vertex's shadow ray. The pathwise trace takes F1, F2 and B.
    print("edge-aware:", flush=True)
    _, c5s_edge, counts, g_edge = train_steps(
        step_edge, init(), targets, key7, sphere_errs, C5_STEPS,
        {"fused_hit": views * evals * (1 + bounces),
         "fused_hit[exclude]": views * evals,
         "fused_hit_shadow": views * evals * 3 * bounces,
         "sphere_search": views * evals,
         **diff_bounce_counts(units, bounces)})
    for k, v in counts.items():
        train_launches[k] += v
    rel = pose_gradient_differs(g_edge, g_path, "sphere Cornell box")
    print(f"pose gradient, edge-aware against pathwise on the same key: "
          f"relative change {rel}", flush=True)
    del targets

    phase("config 5, true Cornell box (mesh), 1920x1080, 2 views: 1 pathwise "
          "and 2 edge-aware per-view train steps")
    world = meshes.cornell_box_world().to(dev)
    camw = meshes.cornell_box_mesh_camera(cfg5.aspect_ratio).to(dev)
    true_w = mv.orbit_cameras(camw, C5_MESH_VIEWS)
    key11 = sampling.prng_key(11, dev)
    targets, tgt_s = wall_s(lambda: torch.stack([
        inv.mean_image(world, c, cfg5, sampling.fold_in(key11, v))
        for v, c in enumerate(true_w)]))
    pose_w = torch.tensor(C5_MESH_POSE_ERR, device=dev)
    start = tuple(inv.translate_camera(c, pose_w) for c in true_w)
    make = lambda edge: mv.make_multiview_train_step_perview(
        world, start, cfg5, inv.adam(2.5e-2), trainable=(),
        train_camera="pose", edge_aware=edge)
    init, step, _, _ = make(False)
    _, step_edge, _, _ = make(True)
    views = len(true_w)

    def mesh_errs(st):
        tr = st.params["camera"]["translate"].detach()
        return {"pose_err": float((tr + pose_w).abs().max())}

    print(f"targets: 2 views in {tgt_s:.3f} s; start "
          f"{json.dumps(mesh_errs(init()))}", flush=True)
    pair_step_wavefront(fh, mi, mp, world, rays_of(primary(camw, cfg5)),
                        cfg5.t_min)
    # Pathwise: per evaluation a world hit and a shadow ray's world hit at
    # every bounce, each A5 then A3 (one cluster: no A4).
    per = views * evals * 2 * bounces
    _, c5m, counts, g_path = train_steps(
        step, init(), targets, key11, mesh_errs, C5_PATHWISE_STEPS,
        {"sphere_search": per, "mesh_search": per})
    for k, v in counts.items():
        train_launches[k] += v
    # Edge-aware, per evaluation: two such traces (the background one with
    # the exclude operands at bounce 0), the bounce-0 winner and the first
    # vertex's shadow ray: 4 * bounces + 2 world hits.
    print("edge-aware:", flush=True)
    per = views * evals * (4 * bounces + 2)
    _, c5m_edge, counts, g_edge = train_steps(
        step_edge, init(), targets, key11, mesh_errs, C5_STEPS,
        {"sphere_search": per, "mesh_search": per,
         "sphere_search[exclude]": views * evals,
         "mesh_search[exclude]": views * evals})
    for k, v in counts.items():
        train_launches[k] += v
    rel = pose_gradient_differs(g_edge, g_path, "true Cornell box")
    print(f"pose gradient, edge-aware against pathwise on the same key: "
          f"relative change {rel}", flush=True)
    # The same pathwise step with the pair-wavefront mesh search: every
    # world hit is A5, then A7, A8 and the fallback's A3 (one cluster: a
    # list of width 1, no A4).
    print("pathwise, mesh_kernel='pairs':", flush=True)
    init_p, step_p, _, _ = mv.make_multiview_train_step_perview(
        world, start, dataclasses.replace(cfg5, mesh_kernel="pairs"),
        inv.adam(2.5e-2), trainable=(), train_camera="pose")
    per = views * evals * 2 * bounces
    _, c5m_pairs, counts, g_pairs = train_steps(
        step_p, init_p(), targets, key11, mesh_errs, C5_PATHWISE_STEPS,
        {"sphere_search": per, "mesh_search": per,
         "mesh_crossing_lists": per, "mesh_pairs": per})
    for k, v in counts.items():
        train_launches[k] += v
    if c5m_pairs[0]["loss"] != c5m[0]["loss"]:
        raise AssertionError(
            f"the pair-search step's loss {c5m_pairs[0]['loss']} is not the "
            f"clustered step's {c5m[0]['loss']}")
    # The hits are the same bits; the backward's atomic adds are not ordered.
    same = compare_grads((torch.tensor(c5m_pairs[0]["loss"]), g_pairs),
                         (torch.tensor(c5m[0]["loss"]), g_path),
                         GRAD_RTOL_PLAIN, "pair-search step vs clustered step")
    print(f"pair-search step against the clustered step: {json.dumps(same)}",
          flush=True)
    del targets

    phase("config-5 gradients, pathwise and edge-aware: kernels vs plain "
          "versions on the card, and the card vs the CPU")
    grad_cmp = {}
    cases = {"sphere": (sph, cam5, ("albedo", "emission", "translate"),
                        key7),
             "mesh": (world, camw, ("translate",), key11)}
    for scene_name, (sc, cm, fields, key) in cases.items():
        cpu_sc, cpu_cm = sc.to("cpu"), cm.to("cpu")
        for est, (w, h) in GRAD_PLAIN_WH.items():
            cfg_e = dataclasses.replace(cfg5, edge_aware=est == "edge_aware")
            cfg_g = dataclasses.replace(cfg_e, width=w, height=h)
            with torch.no_grad():
                tgt = inv.mean_image(sc, cm, cfg_g, key) * 0.9
            kern, kern_s = wall_s(lambda: view_loss_and_grads(
                sc, cm, cfg_g, key, tgt, fields))
            plain_cfg = dataclasses.replace(cfg_g,
                                            intersector="fused_interpret")
            plain, plain_s = wall_s(lambda: view_loss_and_grads(
                sc, cm, plain_cfg, key, tgt, fields))
            name = f"{scene_name} {est}"
            st = {"size": [w, h], "kernel_s": kern_s, "plain_s": plain_s,
                  "vs_plain": compare_grads(kern, plain, GRAD_RTOL_PLAIN,
                                            f"{name} kernel vs plain")}
            w, h = GRAD_CPU_WH
            cfg_c = dataclasses.replace(cfg_e, width=w, height=h)
            with torch.no_grad():
                tgt = inv.mean_image(cpu_sc, cpu_cm, cfg_c, 5) * 0.9
            on_card = view_loss_and_grads(sc, cm, cfg_c, key, tgt.to(dev),
                                          fields)
            on_cpu = view_loss_and_grads(cpu_sc, cpu_cm, cfg_c, key.cpu(),
                                         tgt, fields)
            st["card_vs_cpu"] = compare_grads(on_card, on_cpu, GRAD_RTOL_CPU,
                                              f"{name} card vs CPU")
            grad_cmp[name] = st
            print(f"gradients {name}: {json.dumps(st)}", flush=True)

    phase("intersector='xla': the BVH walk vs its plain version (terrain), "
          "terrain and book-cover 1080p frames, config-5 true-Cornell "
          "view-steps, a small frame vs the f64 oracle")
    xla_out = xla_phase(mi, render_linear, RenderConfig, scenes,
                        xla_terrain, xla_book, world, camw, cfg5, key11,
                        results)
    for k, v in xla_out["launches"].items():
        launches[k] += v
    print(f"xla phase: {json.dumps(xla_out)}", flush=True)
    # Kept for the sharded phase: the terrain world and its 1080p frame.
    shard_terrain = {"world": xla_terrain["world"],
                     "img": xla_terrain["img"].cpu()}
    del xla_terrain, xla_book

    phase("the CLI on the card: bench, a progressive render with a "
          "checkpoint, mesh and NEE renders, invert; each against the "
          "plain route")
    cli_out = cli_phase(scenes, render_linear, RenderConfig)
    print(f"cli phase: {json.dumps(cli_out)}", flush=True)

    phase("sharded render and training (parallel/): the main-path frame over "
          "a world of one on NCCL, then two ranks on the one card over gloo "
          "(they share the card: no scaling is measured)")
    shard_out = sharded_phase(render_linear, dev, shard_terrain)
    del shard_terrain
    print(f"sharded phase: {json.dumps(shard_out)}", flush=True)

    sources = {
        "fused_hit": ("qt_raytracer_tpu_torch/csrc/fused_hit.cu",
                      "qt_raytracer_tpu/kernels/fused_hit.py:50"),
        "fused_hit_shadow": ("qt_raytracer_tpu_torch/csrc/fused_hit.cu",
                             "qt_raytracer_tpu/kernels/fused_hit.py:199"),
        "mesh_first_cluster": ("qt_raytracer_tpu_torch/csrc/mesh_intersect.cu",
                               "qt_raytracer_tpu/kernels/mesh_intersect.py:619"),
        "mesh_search": ("qt_raytracer_tpu_torch/csrc/mesh_intersect.cu",
                        "qt_raytracer_tpu/kernels/mesh_intersect.py:238"),
        "sphere_search": ("qt_raytracer_tpu_torch/csrc/fused_hit.cu",
                          "qt_raytracer_tpu/kernels/sphere_intersect.py:47"),
        "sphere_search_clustered": (
            "qt_raytracer_tpu_torch/csrc/fused_hit.cu",
            "qt_raytracer_tpu/kernels/sphere_intersect.py:108"),
    }
    sources["mesh_crossing_lists"] = (
        "qt_raytracer_tpu_torch/csrc/mesh_pairs.cu",
        "qt_raytracer_tpu/kernels/mesh_pairs.py:136")
    sources["mesh_pairs"] = ("qt_raytracer_tpu_torch/csrc/mesh_pairs.cu",
                             "qt_raytracer_tpu/kernels/mesh_pairs.py:58")
    sources["mesh_search[rowgate]"] = (
        "qt_raytracer_tpu_torch/csrc/mesh_intersect.cu",
        "qt_raytracer_tpu/kernels/mesh_intersect.py:233")
    sources["mesh_search[mxu]"] = (
        "qt_raytracer_tpu_torch/csrc/mesh_intersect.cu",
        "qt_raytracer_tpu/kernels/mesh_intersect.py:324")
    # No TPU kernel: the counterpart of the JAX package's portable walk.
    sources["bvh_walk"] = ("qt_raytracer_tpu_torch/csrc/bvh_walk.cu",
                           "qt_raytracer_tpu/accel/traverse.py:56")
    # No TPU kernel: the counterpart of the JAX flat path's shading after
    # its hit query (_scatter_flat and the bounce body), which XLA fuses.
    sources["fused_shade"] = ("qt_raytracer_tpu_torch/csrc/fused_shade.cu",
                              "qt_raytracer_tpu/core/integrator_flat.py:68")
    # No TPU kernel: the gradient path's bounce after A2's selection
    # (_rederive_hits_flat, the NEE and shading steps), which jax.grad
    # differentiates through XLA's fusions.
    for name in ("diff_bounce", "diff_bounce[shadow_rays]",
                 "diff_bounce[backward]"):
        sources[name] = ("qt_raytracer_tpu_torch/csrc/diff_bounce.cu",
                         "qt_raytracer_tpu/core/integrator_flat.py:712")
    # The exclude and pair variants are template instances of their kernels.
    for name in KERNELS:
        if name.endswith(("[exclude]", "[pair]")):
            sources[name] = sources[name[:name.index("[")]]
    print(f"chip_smoke.py phases done in {time.perf_counter() - START:.1f} s",
          flush=True)
    print(f"launches over the forward paths' counted frames (the xla "
          f"phase's frames and view-steps among them): "
          f"{json.dumps(launches)}; over the seven train steps: "
          f"{json.dumps(train_launches)}; over the CLI phase's runs: "
          f"{json.dumps(cli_out['launches'])}; over the sharded phase's "
          f"ranks: {json.dumps(shard_out['launches'])}")
    for k in KERNELS:
        launches[k] += train_launches[k] + cli_out["launches"][k] + \
            shard_out["launches"][k]
    missing = [name for name in KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the paths: "
                             f"{missing}")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": sources[name][0],
        "replaces": sources[name][1],
        "launches": launches[name],
        "max_abs_err": results[name][0],
        "ms": results[name][1]["ms"],
        "plain_ms": results[name][1]["plain_ms"],
        "bound_ms": results[name][1]["bound_ms"],
        "bound_by": results[name][1]["bound_by"],
        "library_ms": None,
    } for name in KERNELS]}))

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
