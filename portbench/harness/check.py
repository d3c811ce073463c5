"""The comparisons that decide ``correct``: the port's outputs against the
plain reference's, each reduced to one number that is held to a limit of
the configuration's.

Frames: the share of sampled pixels (in sampled frames) where some channel
lies more than atol + rtol * |reference| from the reference, or is not
finite. Train steps: the relative gap of each step's loss; the gap between
the norms of the first gradient (as Adam got it) and of the change after
the steps, against the reference's norm of that leaf or of the median leaf,
whichever is larger, by the worst leaf or for one leaf.
"""

from __future__ import annotations

import math
import statistics

import torch


def pixel_mismatch_share(got: torch.Tensor, ref: torch.Tensor,
                         atol: float, rtol: float) -> float:
    """Share of pixels ([..., 3]) with a channel beyond the tolerance."""
    got = got.to(torch.float64).reshape(-1, 3)
    ref = ref.to(torch.float64).reshape(-1, 3).to(got.device)
    bad = ~torch.isfinite(got) | ((got - ref).abs() > atol + rtol * ref.abs())
    return float(bad.any(dim=1).to(torch.float64).mean())


def loss_gap(got: list, ref: list) -> float:
    return max((abs(a - b) / abs(b) if b != 0 else math.inf)
               if math.isfinite(a) else math.inf for a, b in zip(got, ref))


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64)))
            for k, v in leaves.items()}


def leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """max over leaves of | |got| - |ref| | / max(|ref|, median leaf |ref|);
    keep: the leaves to compare (all by default)."""
    ng, nr = _norms(got), _norms(ref)
    names = [k for k in nr if keep is None or k in keep]
    if not names:
        return 0.0
    med = statistics.median(nr[k] for k in nr)
    out = 0.0
    for k in names:
        if not math.isfinite(ng[k]):
            return math.inf
        den = max(nr[k], med)
        out = max(out, abs(ng[k] - nr[k]) / den if den > 0 else
                  (0.0 if ng[k] == 0 else math.inf))
    return out


def median_leaf(ref: dict) -> str:
    """The leaf whose reference norm is the median (the lower middle one
    of an even count)."""
    nr = _norms(ref)
    names = sorted(nr, key=lambda k: nr[k])
    return names[(len(names) - 1) // 2]


def moving_leaves(ref_grad: dict, floor: float = 1e-3) -> list:
    """Leaves whose reference gradient is at least floor x the median
    leaf's: the others move under Adam by rounding alone."""
    nr = _norms(ref_grad)
    med = statistics.median(nr.values())
    return [k for k, v in nr.items() if v >= floor * med]


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value": v, "limit": l}} with v <= l for each compared
    number; a non-finite or missing value fails."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        out[name] = {"value": v, "limit": limit,
                     "ok": bool(math.isfinite(v) and v <= limit)}
    return out
