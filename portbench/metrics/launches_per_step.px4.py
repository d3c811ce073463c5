"""``launches_per_step`` on the four-card cell (rank 0's trace of a step). The
cell holds no end-to-end step time (``view_step_s.px4`` is its per-layer
reading), so this split of ``launches_per_step`` names the end-to-end
number held there, ``peak_mem_gib`` (PERF.md §2)."""

from portbench.harness import manifest

LAYER = "train steps and autograd"
UNIT = "kernels"
MOVES = "peak_mem_gib"
WORKLOADS = ("cornell_c5.view_step_px4",)


def read(run):
    return manifest.metric_module("launches_per_step").read(run)
