"""Device milliseconds a sharded train step spends moving data in NCCL's
collectives: the all-reduce that assembles the image in the forward and
the one that sums the scene's and camera's gradients in the backward.

An NCCL kernel starts when its rank launches it and spins until every
peer has arrived, so a rank's NCCL time is the transfer plus its wait for
the slowest rank. The rank that arrives last at a collective waits least:
the figure is, collective by collective, the shortest of the ranks'
kernels in their traces of the same step (``trace.collective_seconds``;
``allreduce_wait_ms_per_step`` reads the rest). The port opens no span
around them; they are found by name alone (``trace.collective``).

On the four-card cell the step's time is a per-layer reading
(``view_step_s.px4``): its runs spread too widely across hosts for an
end-to-end bound, so the end-to-end number held there is ``peak_mem_gib``
(PERF.md §2), which this metric names as the one it moves."""

from portbench.harness import trace

LAYER = "sharding"
UNIT = "ms"
MOVES = "peak_mem_gib"
WORKLOADS = ("cornell_c5.view_step_px4",)


def read(run):
    got = trace.collective_seconds(run.rank_traces)
    if got is None or got[0] <= 0:
        return None
    return 1e3 * got[0] / run.rank_traces[0].units
