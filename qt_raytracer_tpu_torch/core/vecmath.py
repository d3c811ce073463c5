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


def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis (RayTracer.h:141-143)."""
    return torch.sum(u * v, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection v - 2(v.n)n (RayTracer.h:175-177)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor,
            etai_over_etat: torch.Tensor) -> torch.Tensor:
    """Snell refraction of unit vector uv about n (RayTracer.h:179-184)."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -safe_sqrt(torch.abs(1.0 - length_squared(r_out_perp)))[..., None] * n)
    return r_out_perp + r_out_parallel


class _GatherRows(torch.autograd.Function):
    """table[idx] whose backward sums the rows' gradients with index_add_.

    Autograd's own index backward sorts the ids and walks the duplicates of
    each id serially; with a wavefront of ~4e5 rays over a table of ~10 rows
    (every NEE ray gathers the one light) that took 68 ms per call on an
    H100, against ~0.3 ms for index_add_'s atomic adds."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows, *grad.shape[1:]))
        return out.index_add_(0, idx, grad), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows table[idx] of a [S, ...] table for [N] integer ids."""
    idx = idx.long()
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherRows.apply(table, idx)
    return table[idx]


def safe_unit_vector(v: torch.Tensor) -> torch.Tensor:
    """unit_vector with a NaN-free gradient where |v| ~ 0: dead and masked
    lanes can carry zero vectors, and dividing by |v| = 0 would poison the
    backward pass of every parameter feeding v."""
    n2 = length_squared(v)
    ok = n2 > 1.0e-20
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)
    return v * inv[..., None]
