"""Idle share of the card over a traced train step: 1 - the union of
device operation intervals over the traced interval (the step's call to
its synchronize's end)."""

LAYER = "device"
UNIT = "%"
MOVES = "view_step_s"
WORKLOADS = ("cornell_c5.view_step",)


def read(run):
    tr = run.trace_data
    return None if tr is None else tr.idle_pct
