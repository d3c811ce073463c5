"""Device milliseconds a frame spends in kernels launched inside the
port's qtrt.shade span (integrator_flat._shade: scatter, sky and emission,
NEE, roulette) and no span within it: the bounce's uniforms (qtrt.rng) and
the shadow rays' mesh search (qtrt.hit.mesh) count elsewhere."""

from portbench.harness import spans

LAYER = "render loop"
UNIT = "ms"
MOVES = "frame_msamples_s"
WORKLOADS = ("book_cover.frame", "terrain.frame")


def read(run):
    return spans.innermost_ms_per_unit(run, spans.SHADE)
