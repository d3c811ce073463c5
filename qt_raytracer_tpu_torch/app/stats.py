"""Render statistics — the reference's metric formulas, verbatim
(counterpart of ``qt_raytracer_tpu.app.stats``).

Mirrors the statsText pipeline (src/app/RayTracerFboItem.cpp:397-427 CPU,
:483-490 OpenGL, :562-569 CUDA, :613-620 Vulkan): wall-clock seconds,
throughput Msamples/s = W*H*spp/elapsed, frame/repaint rate, and progress;
plus rays/s (bounce segments traced, an upper bound) and per-card figures.

``Timer`` is a host clock. PyTorch returns before the card has finished,
so a caller reads it only after ``synchronize(device)``.
"""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    max_depth: int
    elapsed_s: float
    frames: int = 1          # progressive steps (repaints analog)
    backend: str = "cuda"
    num_chips: int = 1

    @property
    def samples(self) -> int:
        return self.width * self.height * self.spp

    @property
    def msamples_per_s(self) -> float:
        """Reference formula: W*H*spp / elapsed (RayTracerFboItem.cpp:400-404)."""
        return self.samples / max(self.elapsed_s, 1e-9) / 1e6

    @property
    def fps(self) -> float:
        """Repaint rate analog (RayTracerFboItem.cpp:405,415)."""
        return self.frames / max(self.elapsed_s, 1e-9)

    @property
    def mrays_per_s(self) -> float:
        """Upper-bound ray segments traced (wavefront: spp * depth per pixel)."""
        return self.samples * self.max_depth / max(self.elapsed_s, 1e-9) / 1e6

    @property
    def msamples_per_s_per_chip(self) -> float:
        return self.msamples_per_s / max(self.num_chips, 1)

    def text(self) -> str:
        """statsText-style one-liner (RayTracerFboItem.cpp:412-421 format)."""
        return (f"Render {self.elapsed_s:.2f} s | Throughput "
                f"{self.msamples_per_s:.2f} Msamples/s | "
                f"{self.mrays_per_s:.1f} Mrays/s (bound) | "
                f"{self.fps:.1f} frames/s | Backend {self.backend} "
                f"x{self.num_chips}")


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """QElapsedTimer analog."""

    def __init__(self):
        self.restart()

    def restart(self) -> None:
        self._t0 = time.perf_counter()

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0
