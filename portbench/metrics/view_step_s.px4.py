"""Seconds a sharded train step takes, as ``view_step_s`` reads them on one
card: the window's start to the last step completed in it, over those
steps, on rank 0's clock (a step ends once it has synchronized on every
rank). Read in the traced run, whose window holds the one traced step.

On the four-card cell this is a per-layer reading, not an end-to-end
metric: whole runs there read fast or slow with the host (two sets of six
runs on one host spread 11.4% and 20.5%, past the 12.5% that the largest
bound, 25%, allows), so the end-to-end number held there is
``peak_mem_gib``, which this reading names as the one it moves (PERF.md
§2)."""

LAYER = "train steps and autograd"
UNIT = "s"
MOVES = "peak_mem_gib"
WORKLOADS = ("cornell_c5.view_step_px4",)


def read(run):
    return run.metrics.get("view_step_s")
