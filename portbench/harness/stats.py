"""The arithmetic of the end-to-end metrics and of the trace, on plain
numbers: a window's rate, a percentile over every sample, the union of
device intervals, and the spread that sets a bound."""

from __future__ import annotations

import math
import statistics


def window_rate(work_done: float, window_start: float, last_end: float):
    """Work over the time from the window's start to the end of the last
    unit completed in it; None when nothing completed."""
    if last_end <= window_start or work_done <= 0:
        return None
    return work_done / (last_end - window_start)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of every value, by linear
    interpolation between closest ranks (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def clip(intervals, lo: float, hi: float):
    """The parts of (start, end) intervals that lie inside [lo, hi]."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def gaps(intervals, lo: float, hi: float):
    """(start, end) of every stretch of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in sorted(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def spread(values) -> float:
    """Distance between the first and third quartiles over the median
    (statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
