"""Device milliseconds a frame spends in every kernel launched inside the
port's qtrt.hit.mesh span (world.search_mesh, accel.traverse.intersect_mesh):
the first-cluster walk (A4), the crossing-key sort and its gathers, the
mesh search (A3, A3m) or the pair search (A7, A8), the BVH walk."""

from portbench.harness import spans

LAYER = "mesh kernels and sort"
UNIT = "ms"
MOVES = "frame_msamples_s"
WORKLOADS = ("terrain.frame",)


def read(run):
    return spans.within_ms_per_unit(run, spans.HIT_MESH)
