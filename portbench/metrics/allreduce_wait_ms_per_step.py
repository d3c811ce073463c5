"""Device milliseconds a rank of a sharded train step spins in NCCL's
collectives waiting for the slowest rank: a rank's NCCL kernel seconds
beyond the transfer (``allreduce_ms_per_step``), averaged over the ranks'
traces of the same step (``trace.collective_seconds``). Uneven work or
host stalls across ranks raise it; balanced ranks bring it to 0.

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
    if got is None or len(got[1]) < 2:
        return None
    transfer, per_rank = got
    wait = sum(per_rank) / len(per_rank) - transfer
    return 1e3 * wait / run.rank_traces[0].units
