"""Progressive rendering with checkpoint/resume (counterpart of
``qt_raytracer_tpu.app.progressive``).

Subsumes the reference's progressive GPU mode — 1 spp per frame with a
running-mean accumulation image and reset support (GpuPathTracer.cpp:279-282,
resetAccumulation :85-95, frame loop RayTracerFboItem.cpp:467-494) — and adds
what the reference lacks (SURVEY.md §5): the accumulator state
(accum sum, sample count, seed) IS a checkpoint, so long renders survive
restarts and can move between devices.

Checkpoints are ``torch.save`` files holding ``accum``, ``sample_count``
and ``seed``; they load onto the renderer's device. The JAX package's orbax
directories are not read (ROADMAP Queue C, C4): carry a JAX state across
with ``utils.convert.progressive_state_from_arrays``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..core import tonemap
from ..core.config import RenderConfig
from ..core.render import needs_grad, render_sample_batch
from ..core.sampling import prng_key


@dataclasses.dataclass
class ProgressiveState:
    """Resumable accumulator: linear radiance SUM (not mean) + sample count."""

    accum: torch.Tensor     # [H, W, 3] f32 sum of samples
    sample_count: int
    seed: int               # base key seed (stored, key re-derived)


class ProgressiveRenderer:
    """Stateful progressive renderer: call step() per "frame".

    After k steps of n spp each, the accumulation equals a batch
    ``render_linear`` at k*n spp with the same seed: bit for bit in steps
    of 1 spp (the sums run in the same order), within f32 re-association
    otherwise. The render runs on the device of the scene's tensors (a
    SphereScene or a World); the camera must live there too.
    """

    def __init__(self, scene, camera, cfg: RenderConfig, seed: int = 0):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self._start(seed)

    @property
    def device(self) -> torch.device:
        return self.scene.device

    @property
    def seed(self) -> int:
        """The base key seed, read from the state: assigning ``state`` (a
        loaded or carried-over checkpoint) sets it too."""
        return self.state.seed

    def _start(self, seed: int) -> None:
        self.state = ProgressiveState(
            accum=torch.zeros((self.cfg.height, self.cfg.width, 3),
                              dtype=torch.float32, device=self.device),
            sample_count=0,
            seed=seed,
        )

    def reset(self) -> None:
        """resetAccumulation (GpuPathTracer.cpp:85-95)."""
        self._start(self.seed)

    @property
    def frame_index(self) -> int:
        """Progressive frame counter (CudaPathTracer frameIndex analog)."""
        return self.state.sample_count

    @property
    def progress(self) -> float:
        """Percent of cfg.spp completed (RayTracerFboItem.cpp:469-471)."""
        return min(100.0, 100.0 * self.state.sample_count / self.cfg.spp)

    def step(self, num_samples: int = 1) -> torch.Tensor:
        """Trace num_samples more spp; returns current mean linear image."""
        key = prng_key(self.state.seed, self.device)
        with torch.set_grad_enabled(needs_grad(self.scene, self.camera)):
            batch = render_sample_batch(self.scene, self.camera, self.cfg,
                                        key, self.state.sample_count,
                                        num_samples)
            self.state = ProgressiveState(
                accum=self.state.accum + batch,
                sample_count=self.state.sample_count + num_samples,
                seed=self.state.seed,
            )
            return self.state.accum / max(self.state.sample_count, 1)

    def image(self) -> np.ndarray:
        """Current tonemapped uint8 image [H, W, 3], on the host."""
        n = max(self.state.sample_count, 1)
        return tonemap.to_uint8(self.state.accum.detach(), n,
                                self.cfg.quantizer).cpu().numpy()

    # ------------------------------------------------------------ checkpoint
    def save(self, path: str | Path) -> None:
        """Write the resumable triple to one ``torch.save`` file."""
        torch.save({"accum": self.state.accum.detach(),
                    "sample_count": int(self.state.sample_count),
                    "seed": int(self.state.seed)}, Path(path))

    def load(self, path: str | Path) -> None:
        """Restore a checkpoint written by save(), onto this renderer's
        device, whichever device wrote it."""
        saved = torch.load(Path(path), weights_only=True,
                           map_location=self.device)
        accum = saved["accum"]
        want = (self.cfg.height, self.cfg.width, 3)
        if tuple(accum.shape) != want or accum.dtype != torch.float32:
            raise ValueError(f"checkpoint holds a {accum.dtype} "
                             f"{tuple(accum.shape)} accumulation; this "
                             f"renderer needs float32 {want}")
        self.state = ProgressiveState(
            accum=accum,
            sample_count=int(saved["sample_count"]),
            seed=int(saved["seed"]),
        )
