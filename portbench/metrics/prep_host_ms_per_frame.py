"""Host-clock milliseconds a frame spends inside the port's qtrt.prep
spans: the kernel tables that every trace call builds anew from the scene
(prep_fused_spheres, prep_world), once per pixel chunk and sample batch.
In a host-bound frame this host time is what the rebuild costs."""

from portbench.harness import spans

LAYER = "tables and build"
UNIT = "ms"
MOVES = "frame_msamples_s"
WORKLOADS = ("book_cover.frame", "terrain.frame")


def read(run):
    return spans.host_ms_per_unit(run, spans.PREP)
