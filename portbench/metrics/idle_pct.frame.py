"""Idle share of the card over a traced stretch of whole frames: 1 - the
union of device operation intervals over the traced interval (first
call's start to the last synchronize's end)."""

LAYER = "device"
UNIT = "%"
MOVES = "frame_msamples_s"
WORKLOADS = ("book_cover.frame", "terrain.frame")


def read(run):
    tr = run.trace_data
    return None if tr is None else tr.idle_pct
