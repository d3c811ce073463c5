"""Device kernels a frame launches, from the trace of whole frames."""

LAYER = "render loop"
UNIT = "kernels"
MOVES = "frame_msamples_s"
WORKLOADS = ("book_cover.frame", "terrain.frame")


def read(run):
    tr = run.trace_data
    return None if tr is None else tr.launches_per_unit
