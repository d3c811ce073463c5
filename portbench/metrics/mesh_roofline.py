"""Share of the mesh kernels' device time (A3, A3m, A4, A7, A8, the walk)
that the frozen rule roofline/mesh.py says the work needs at the card's
peaks."""

LAYER = "mesh kernels and sort"
UNIT = "%"
MOVES = "frame_msamples_s"
WORKLOADS = ("terrain.frame",)


def read(run):
    return run.roofline_pct("mesh")
