"""Device milliseconds a train step spends re-running the forward inside
the backward: kernels launched inside the qtrt.render.chunk spans that lie
within qtrt.train.backward (torch.utils.checkpoint's recompute of each
pixel chunk and sample batch)."""

from portbench.harness import spans

LAYER = "train steps and autograd"
UNIT = "ms"
MOVES = "view_step_s"
WORKLOADS = ("cornell_c5.view_step",)


def read(run):
    return spans.recompute_ms_per_unit(run)
