"""Device milliseconds a frame spends in kernels launched inside the
port's qtrt.rng span and no span within it (core/sampling.py: pixel
states, sample keys, stream uniforms), each kernel put under the span
around its launch call (harness/spans.py)."""

from portbench.harness import spans

LAYER = "render loop"
UNIT = "ms"
MOVES = "frame_msamples_s"
WORKLOADS = ("book_cover.frame", "terrain.frame")


def read(run):
    return spans.innermost_ms_per_unit(run, spans.RNG)
