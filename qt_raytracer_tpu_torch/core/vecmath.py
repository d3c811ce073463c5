"""Batched 3-vector math on [..., 3] tensors (the subset the render path
uses; counterpart of ``qt_raytracer_tpu.core.vecmath``)."""

from __future__ import annotations

import math

import torch


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched cross product (RayTracer.h:145-149)."""
    u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([u1 * v2 - u2 * v1, u2 * v0 - u0 * v2,
                        u0 * v1 - u1 * v0], dim=-1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def unit_vector(v: torch.Tensor) -> torch.Tensor:
    """v / |v| (RayTracer.h:151-153)."""
    return v / torch.sqrt(length_squared(v))[..., None]


def degrees_to_radians(deg: torch.Tensor) -> torch.Tensor:
    return deg * (math.pi / 180.0)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)), written as the JAX package's gradient-safe form."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)
