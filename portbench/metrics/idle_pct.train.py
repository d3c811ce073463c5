"""Idle share of the card over a traced train step: 1 - the union of
device operation intervals over the traced interval (the step's call to
its synchronize's end). A sharded step's NCCL kernels count as idle: they
spin until every rank has arrived, and their time is read by
``allreduce_ms_per_step`` (transfer) and ``allreduce_wait_ms_per_step``
(the wait); a one-card step has none."""

from portbench.harness import trace

LAYER = "device"
UNIT = "%"
MOVES = "view_step_s"
WORKLOADS = ("cornell_c5.view_step",)


def read(run):
    tr = run.trace_data
    if tr is None:
        return None
    busy = tr.busy_s_of(lambda n: not trace.collective(n))
    return 100.0 * (1.0 - busy / tr.window_s)
