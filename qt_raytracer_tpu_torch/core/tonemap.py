"""Tone mapping and quantization (counterpart of
``qt_raytracer_tpu.core.tonemap``).

  - "cpu": gamma-2 then int(256 * clamp(c, 0, 0.999))
           (src/app/RayTracerFboItem.cpp:115-127) — the canonical one.
  - "gpu": gamma-2 then uint(c * 255) (the reference's GPU shaders).
"""

from __future__ import annotations

import torch


def resolve(accum_linear: torch.Tensor, spp) -> torch.Tensor:
    """Mean + gamma-2 (sqrt) of a summed linear radiance buffer."""
    scale = 1.0 / spp
    return torch.sqrt(torch.clamp_min(accum_linear * scale, 0.0))


def quantize(gamma_img: torch.Tensor, quantizer: str = "cpu") -> torch.Tensor:
    """Gamma-space [*,3] floats -> uint8."""
    if quantizer == "cpu":
        q = torch.floor(256.0 * torch.clamp(gamma_img, 0.0, 0.999))
    elif quantizer == "gpu":
        q = torch.floor(torch.clamp(gamma_img, 0.0, 1.0) * 255.0)
    else:
        raise ValueError(f"unknown quantizer {quantizer!r}")
    return q.to(torch.uint8)


def to_uint8(accum_linear: torch.Tensor, spp,
             quantizer: str = "cpu") -> torch.Tensor:
    return quantize(resolve(accum_linear, spp), quantizer)
