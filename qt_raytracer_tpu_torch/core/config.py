"""Render configuration.

The same frozen dataclass as ``qt_raytracer_tpu.core.config``: the same
fields, defaults and clamps, so one configuration describes the same frame in
both packages. The config accepts every value the JAX package accepts;
``require_ported`` is where the renderer refuses a value whose port has not
landed yet, naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses

# Validation ranges mirrored from the reference UI
# (resources/qml/Main.qml:394,426,458,491 and RayTracerFboItem.cpp:189-228).
MIN_DIM = 1
MAX_WIDTH = 3840
MAX_HEIGHT = 2160
MIN_SPP = 1
MAX_SPP = 1000
MIN_DEPTH = 1
MAX_DEPTH = 100

# Intersector values of the JAX package. "auto" and "fused" run the CUDA
# kernel on CUDA tensors and its plain PyTorch version on CPU tensors;
# "fused_interpret" runs the plain version on any device (the counterpart of
# Pallas interpret mode).
_PORTED_INTERSECTORS = ("auto", "fused", "fused_interpret")
_UNPORTED_INTERSECTORS = {
    "xla": "ROADMAP Queue A item 7 (gradient integrator)",
    "pallas": "ROADMAP Queue A item 7 (gradient integrator, kernel A5)",
    "pallas_interpret": "ROADMAP Queue A item 7 (gradient integrator, "
                        "kernel A5)",
    "fused_diff": "ROADMAP Queue A item 7 (gradient integrator, kernel A2)",
    "fused_diff_interpret": "ROADMAP Queue A item 7 (gradient integrator, "
                            "kernel A2)",
}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable).

    Defaults match the reference QML panel (resources/qml/Main.qml:10-13):
    400x225, 24 spp, max depth 10. See the JAX package's RenderConfig for
    the meaning of every field.
    """

    width: int = 400
    height: int = 225
    spp: int = 24
    max_depth: int = 10
    t_min: float = 1.0e-3
    quantizer: str = "cpu"
    samples_per_batch: int = 1
    rr_start: int = 0
    rng: str = "threefry"
    nee: bool = False
    intersector: str = "auto"
    pixel_chunk: int = 0
    edge_aware: bool = False

    def __post_init__(self):
        object.__setattr__(self, "width", _clamp(self.width, MIN_DIM, MAX_WIDTH))
        object.__setattr__(self, "height", _clamp(self.height, MIN_DIM, MAX_HEIGHT))
        object.__setattr__(self, "spp", _clamp(self.spp, MIN_SPP, MAX_SPP))
        object.__setattr__(self, "max_depth", _clamp(self.max_depth, MIN_DEPTH, MAX_DEPTH))
        if self.quantizer not in ("cpu", "gpu"):
            raise ValueError(f"quantizer must be 'cpu' or 'gpu', got {self.quantizer!r}")
        if (self.intersector not in _PORTED_INTERSECTORS
                and self.intersector not in _UNPORTED_INTERSECTORS):
            raise ValueError(f"unknown intersector {self.intersector!r}")
        if self.rng not in ("threefry", "hash"):
            raise ValueError(f"unknown rng {self.rng!r}")
        if self.pixel_chunk < -1:
            raise ValueError(f"pixel_chunk must be >= -1, got {self.pixel_chunk}")
        if self.edge_aware and self.samples_per_batch != 1:
            object.__setattr__(self, "samples_per_batch", 1)
        if self.spp % self.samples_per_batch != 0:
            spb = self.samples_per_batch
            while self.spp % spb != 0:
                spb -= 1
            object.__setattr__(self, "samples_per_batch", spb)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height


def require_ported(cfg: RenderConfig) -> None:
    """Raise NotImplementedError if cfg asks for a feature not yet ported."""
    if cfg.intersector in _UNPORTED_INTERSECTORS:
        raise NotImplementedError(
            f"intersector {cfg.intersector!r} is not ported yet: "
            f"{_UNPORTED_INTERSECTORS[cfg.intersector]}")
    if cfg.rng != "hash":
        raise NotImplementedError(
            "rng='threefry' is not ported yet: ROADMAP Queue A item 6; "
            "use rng='hash'")
    if cfg.nee:
        raise NotImplementedError(
            "nee=True is not ported yet: ROADMAP Queue A item 4 (kernel A2)")
    if cfg.edge_aware:
        raise NotImplementedError(
            "edge_aware=True is not ported yet: ROADMAP Queue A item 8")


def _clamp(x: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(x)))
