#!/usr/bin/env python3
"""Where a config-5 view-step's time goes on the card: one
``torch.profiler`` trace of one view's loss and backward at 1920x1080, for
the sphere Cornell box and the true Cornell box, with the pathwise and with
the edge-aware estimator.

Usage: python3 chip_trace.py      (from the root of the repository; needs
                                   one CUDA card, like chip_smoke.py)

Per case it prints one JSON line: the untraced seconds of the view-step, the
number of device kernels, the device's busy time (the union of the kernel
intervals) and idle share (1 - busy / (first kernel start to last kernel
end)), the device time and launches of the port's own kernels, and the five
kernel names with the most device time.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import tempfile

import torch

from chip_smoke import C5, require_card, view_loss_and_grads, wall_s
from qt_raytracer_tpu_torch.app.profiling import trace

OURS = ("fused_hit_kernel", "sphere_search_kernel",
        "sphere_search_clustered_kernel", "mesh_search_kernel",
        "first_cluster_kernel")


def kernel_events(fn) -> list[dict]:
    """The device kernels of one call of fn, from the chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            fn()
        events = json.loads(pathlib.Path(prof.trace_path).read_text())
    return [e for e in events["traceEvents"] if e.get("cat") == "kernel"]


def summarise(kernels: list[dict]) -> dict:
    if not kernels:
        raise RuntimeError("the trace holds no device kernel")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    span = max(b for _, b in spans) - spans[0][0]
    by_name: dict[str, list] = {}
    for e in kernels:
        slot = by_name.setdefault(e["name"], [0.0, 0])
        slot[0] += e["dur"]
        slot[1] += 1
    total = sum(v[0] for v in by_name.values())
    ours = {k: [round(sum(v[0] for n, v in by_name.items() if k in n) / 1e3,
                      3),
                sum(v[1] for n, v in by_name.items() if k in n)]
            for k in OURS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"kernels": len(kernels), "busy_ms": busy / 1e3,
            "span_ms": span / 1e3, "idle_share": 1.0 - busy / span,
            "kernel_time_ms": total / 1e3,
            "ours_ms_and_launches": {k: v for k, v in ours.items() if v[1]},
            "ours_share_of_kernel_time": sum(v[0] for v in ours.values())
            * 1e3 / total,
            "top": [[n[:60], round(v[0] / 1e3, 3), v[1]] for n, v in top]}


def main() -> None:
    dev = require_card()
    from qt_raytracer_tpu_torch import RenderConfig, scenes
    from qt_raytracer_tpu_torch.core import sampling
    from qt_raytracer_tpu_torch.diff import inverse as inv
    from qt_raytracer_tpu_torch.models import meshes

    cfg5 = RenderConfig(**C5)
    cases = {
        "sphere": (scenes.cornell_box_spheres(),
                   scenes.cornell_box_camera(cfg5.aspect_ratio),
                   ("albedo", "emission", "translate"), 7),
        "mesh": (meshes.cornell_box_world(),
                 meshes.cornell_box_mesh_camera(cfg5.aspect_ratio),
                 ("translate",), 11)}
    for name, (scene, cam, fields, seed) in cases.items():
        key = sampling.prng_key(seed, dev)
        with torch.no_grad():
            target = inv.mean_image(scene, cam, cfg5, key) * 0.9
        for edge in (False, True):
            cfg = dataclasses.replace(cfg5, edge_aware=edge)
            step = lambda: view_loss_and_grads(scene, cam, cfg, key, target,
                                               fields)
            step()                                   # warm-up
            _, seconds = wall_s(step)
            out = {"case": f"{name} {'edge_aware' if edge else 'pathwise'}",
                   "untraced_view_step_s": seconds,
                   **summarise(kernel_events(step))}
            print(json.dumps(out), flush=True)
    print(json.dumps({"ok": True,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
