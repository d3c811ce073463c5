"""Device kernels a train step launches (forward, backward and Adam),
from the trace of a whole step."""

LAYER = "train steps and autograd"
UNIT = "kernels"
MOVES = "view_step_s"
WORKLOADS = ("cornell_c5.view_step",)


def read(run):
    tr = run.trace_data
    return None if tr is None else tr.launches_per_unit
