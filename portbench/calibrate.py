#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, at a cell's
own size, on the seeds given. Not run by the benchmark's own runs.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13
                                   [--frames-done 200] [--faults]

Frame cells: the control, the reference computed in bfloat16 in the port's
place, on the sampled pixels of the sampled frames that a run with
--frames-done completed frames checks, against the float64 reference.
Train cells: the control's three steps (bfloat16) against the float64
reference's, the port's own (the lower reading) and, with --faults, the
port with each fault of ``faults.py`` planted, each as every number
``runner.compare_steps`` gives: beside ``grad_gap_median`` the first
gradient's gap for each leaf alone (``grad_gap[<leaf>]``), from which a
configuration can set a limit on its own leaf. Both also read the
reference computed in float32 ("f32"): what rounding to the
configuration's own precision alone gives, a second witness beside the
port. Every reading is the configuration's own reference's
(``manifest.reference``). One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.harness import env, manifest  # noqa: E402


def frame_control(cfg: dict, seed: int, done: int, dev) -> dict:
    import torch

    from portbench.harness import check, inputs

    r = cfg["render"]
    w, h = int(r["width"]), int(r["height"])
    ck = cfg["check"]
    picks = inputs.sample_units(seed, done, int(ck["frames"]))
    keys = inputs.unit_keys(seed, done)[picks]
    pix = torch.as_tensor(inputs.sample_pixels(seed, w * h,
                                               int(ck["pixels"])), device=dev)
    scene = inputs.scene_inputs(cfg["scene"])
    ray_keys = keys.to(dev).repeat_interleave(pix.shape[0], dim=0)
    ray_pix = pix.repeat(len(picks))
    plain = manifest.reference(cfg)
    out = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32),
                        ("bf16", torch.bfloat16)):
        sc = plain.make_scene(scene, dtype, dev)
        cam = plain.make_camera(cfg["camera"], w / h, dtype, dev)
        with torch.no_grad():
            out[name] = plain.render_pixels(sc, cam, r, ray_keys, ray_pix,
                                            dtype)
    return {what: {"px_mismatch_share": check.pixel_mismatch_share(
        out[name], out["f64"], float(ck["atol"]), float(ck["rtol"]))}
        for what, name in (("control", "bf16"), ("f32", "f32"))}


def _look(got: dict, ref: dict) -> dict:
    """Per step and per leaf: the relative loss gaps, and each leaf's
    norms of the first gradient and of the change, port and reference."""
    n = lambda t: float(torch_norm(t))
    return {"step_loss_gaps": [abs(a - b) / abs(b) for a, b in
                               zip(got["losses"], ref["losses"])],
            "grad_norms": {k: [n(got["grad"][k]), n(v)]
                           for k, v in ref["grad"].items()},
            "change_norms": {k: [n(got["change"][k]), n(v)]
                             for k, v in ref["change"].items()}}


def torch_norm(t):
    import torch

    return torch.linalg.vector_norm(t.to(torch.float64))


def train_readings(cfg: dict, traffic: dict, seed: int, dev,
                   faults: bool, witnesses: bool = True) -> dict:
    import torch

    from portbench import faults as faults_mod
    from portbench.harness import runner

    n = int(traffic["setup_steps"])
    fs = runner.first_steps(cfg, seed, dev, n, n)
    got = {"port": {k: fs[k] for k in ("losses", "grad", "change")}}
    base = {k: fs[k] for k in ("keys", "tkey", "true_inputs",
                               "start_inputs")}
    del fs
    for fault in (faults_mod.FAULTS if faults else ()):
        undo = faults_mod.plant_train(fault)
        try:
            fs = runner.first_steps(cfg, seed, dev, n, n)
            got[fault] = {k: fs[k] for k in ("losses", "grad", "change")}
            del fs
        finally:
            undo()
    runner._free()
    ref = runner.reference_steps(base, cfg, dev, n)
    if witnesses:
        got["control"] = runner.reference_steps(base, cfg, dev, n,
                                                dtype=torch.bfloat16)
        got["f32"] = runner.reference_steps(base, cfg, dev, n,
                                            dtype=torch.float32)
    out = {k: runner.compare_steps(v, ref) for k, v in got.items()}
    for k, v in got.items():
        out["look:" + k] = _look(v, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames-done", type=int, default=200)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--port-only", action="store_true",
                    help="train cells: the port's readings alone, without "
                         "the control and the float32 witness")
    args = ap.parse_args(argv)
    env.fix_cache_dirs()
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    torch = env.require_cards(int(cell["chips"]))
    if torch is None:
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cfg = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if traffic["kind"] == "frames":
            rows = frame_control(cfg, seed, args.frames_done, dev)
        else:
            rows = train_readings(cfg, traffic, seed, dev, args.faults,
                                  not args.port_only)
        for what, values in rows.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "what": what, **values,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
