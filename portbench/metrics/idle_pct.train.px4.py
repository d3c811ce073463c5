"""``idle_pct.train`` on the four-card cell (rank 0's trace of a step, NCCL's
kernels counted idle). The cell holds no end-to-end step time
(``view_step_s.px4`` is its per-layer reading), so this split of
``idle_pct.train`` names the end-to-end number held there, ``peak_mem_gib``
(PERF.md §2)."""

from portbench.harness import manifest

LAYER = "device"
UNIT = "%"
MOVES = "peak_mem_gib"
WORKLOADS = ("cornell_c5.view_step_px4",)


def read(run):
    return manifest.metric_module("idle_pct.train").read(run)
