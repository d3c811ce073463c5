#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Everything about the cell (its configuration, traffic mix,
metrics, limits) comes from BENCHMARK.json and the files it names under
portbench/. The last line of standard output is one JSON object; the card
is described on an earlier line of standard error, and the numbers that
decided ``correct`` end standard error, each beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.harness import env, manifest  # noqa: E402


def result_line(out: dict, run, kind: str, chips: int) -> dict:
    """The last line's object: correct, attempted, failed, metrics,
    device, the breakdown of a traced run, and the compared numbers last,
    each beside its limit."""
    device = {"platform": "gpu", "kind": kind, "count": int(chips),
              "memory_peak_bytes": run.peak_bytes}
    tr = run.trace_data
    if tr is not None:
        device["busy_s"] = run.busy_s
        device["window_s"] = tr.window_s
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if tr is not None:
        line["breakdown"] = tr.breakdown()
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                      for k, v in run.checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    env.fix_cache_dirs()
    cell = manifest.cell(manifest.load(), args.workload)
    torch = env.require_cards(int(cell["chips"]))
    if torch is None:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); none or too few here", file=sys.stderr)
        return 2
    print(f"portbench: card {env.card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr, flush=True)

    from portbench.harness import runner

    out = runner.run(args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", T_START)
    run = out.pop("run")
    bad = env.forbidden_modules()
    if bad:
        print(f"portbench: JAX modules were loaded: {bad}", file=sys.stderr)
        return 3
    line = result_line(out, run, torch.cuda.get_device_name(0),
                       int(cell["chips"]))
    phases = ", ".join(f"{k} {v:.2f} s" for k, v in run.phases.items())
    print(f"portbench: setup {run.metrics.get('setup_s', 0.0):.2f} s, "
          f"{phases}, whole run {time.perf_counter() - T_START:.2f} s",
          file=sys.stderr)
    print(f"portbench: {args.workload} seed {args.seed}: attempted "
          f"{run.attempted}, failed {run.failed}, correct {out['correct']}",
          file=sys.stderr)
    for k, v in run.checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
