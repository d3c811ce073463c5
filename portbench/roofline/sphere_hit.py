"""Frozen rule: the work of a closest-hit query against a sphere scene, on
the reference's own wavefronts, whatever kernel implements it.

Spheres sorted along a 3-D Morton curve of their centres (10 bits an axis)
fall into groups of GROUP consecutive spheres, each with its bounding box.
A live ray tests every group's box (GATE_OPS operations) in that order; a
box that the ray enters at or before its running closest hit opens the
group, whose spheres it tests (PAIR_OPS a sphere); then the running hit
takes the group's closest. RAY_OPS more a live ray for the hit's geometry.
Bytes: each live ray's origin and direction in (24) and its hit (t, id)
out (8); the sphere table (32 a sphere) and the group boxes (24) once a
wavefront. Counted on every STRIDE-th pixel and scaled by STRIDE.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _peaks

KERNELS = ("fused_hit_kernel", "sphere_search_kernel",
           "sphere_search_clustered_kernel")
STRIDE = 16
GROUP = 32
GATE_OPS = 20
PAIR_OPS = 25
RAY_OPS = 100
RAY_BYTES = 24 + 8
SPHERE_BYTES = 32
BOX_BYTES = 24


def morton_order(points: np.ndarray) -> np.ndarray:
    lo = points.min(0)
    span = np.maximum(points.max(0) - lo, 1e-12)
    q = np.clip((points - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def slab(lo, hi, o, d, t_min, t_max):
    """Rays [R] that enter the box [lo, hi] at t in [t_min, t_max]."""
    inv = 1.0 / d
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    enter = torch.minimum(t0, t1).amax(dim=1)
    leave = torch.maximum(t0, t1).amin(dim=1)
    return (leave >= torch.clamp_min(enter, t_min)) & (enter <= t_max)


def sphere_roots(center, radius, o, d, t_min):
    """[R, G] closest root >= t_min of each ray against each sphere."""
    oc = o[:, None, :] - center[None]
    a = (d * d).sum(-1)[:, None]
    hb = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - radius[None] ** 2
    disc = hb * hb - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    near, far = (-hb - sq) / a, (-hb + sq) / a
    t = torch.where(near >= t_min, near, far)
    ok = (disc >= 0.0) & (t >= t_min)
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def count(waves: list, inputs: dict, t_min: float = 1e-3):
    """[(live rays, gate tests, sphere tests)] of each wavefront."""
    sp = inputs["spheres"]
    order = morton_order(np.asarray(sp["center"], np.float64))
    out = []
    for w in waves:
        o, d = w["o"], w["d"]
        dev, dt = o.device, o.dtype
        center = torch.as_tensor(np.asarray(sp["center"], np.float64)[order],
                                 device=dev, dtype=dt)
        radius = torch.as_tensor(np.asarray(sp["radius"], np.float64)[order],
                                 device=dev, dtype=dt)
        best = torch.full((o.shape[0],), float("inf"), device=dev, dtype=dt)
        gates = pairs = 0
        for g in range(0, center.shape[0], GROUP):
            c, r = center[g:g + GROUP], radius[g:g + GROUP]
            lo = (c - r[:, None]).amin(0)
            hi = (c + r[:, None]).amax(0)
            opened = slab(lo, hi, o, d, t_min, best)
            gates += o.shape[0]
            pairs += int(opened.sum()) * c.shape[0]
            idx = torch.nonzero(opened).squeeze(1)
            if idx.numel():
                t = sphere_roots(c, r, o[idx], d[idx], t_min).amin(dim=1)
                best[idx] = torch.minimum(best[idx], t)
        out.append((o.shape[0], gates, pairs))
    return out


def bound_s(waves: list, inputs: dict, stride: int) -> float:
    s = len(inputs["spheres"]["radius"])
    groups = -(-s // GROUP)
    total = 0.0
    for rays, gates, pairs in count(waves, inputs):
        flops = stride * (GATE_OPS * gates + PAIR_OPS * pairs
                          + RAY_OPS * rays)
        nbytes = stride * rays * RAY_BYTES + s * SPHERE_BYTES \
            + groups * BOX_BYTES
        total += _peaks.launch_s(flops, nbytes)
    return total
