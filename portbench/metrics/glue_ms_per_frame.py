"""Device milliseconds a frame spends in kernels that are not the port's
hand-written CUDA kernels (the __global__ functions of
qt_raytracer_tpu_torch/csrc/*.cu): PyTorch's elementwise, gather, sort and
reduce kernels of the render loop."""

from portbench.harness.trace import names

LAYER = "render loop"
UNIT = "ms"
MOVES = "frame_msamples_s"
WORKLOADS = ("book_cover.frame", "terrain.frame")
HANDWRITTEN = ("fused_hit_kernel", "sphere_search_kernel",
               "sphere_search_clustered_kernel", "first_cluster_kernel",
               "mesh_search_kernel", "mesh_search_mxu_kernel",
               "crossing_lists_kernel", "pair_hits_kernel", "bvh_walk_kernel")


def read(run):
    tr = run.trace_data
    if tr is None:
        return None
    ours = names(HANDWRITTEN)
    return tr.kernel_seconds(lambda n: not ours(n)) * 1e3 / tr.units
