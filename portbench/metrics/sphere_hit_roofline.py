"""Share of the sphere hit kernels' device time that the frozen rule
roofline/sphere_hit.py says the work needs at the card's peaks."""

LAYER = "sphere hit kernels"
UNIT = "%"
MOVES = "frame_msamples_s"
WORKLOADS = ("book_cover.frame",)


def read(run):
    return run.roofline_pct("sphere_hit")
