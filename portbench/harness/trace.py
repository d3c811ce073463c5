"""One torch.profiler trace over a short stretch of whole frames or steps,
reduced to what the per-layer metrics read: the device operations in the
traced interval, its length, the device's busy time, and the largest
operations and idle gaps for the breakdown.

The traced interval runs from the first call's start to the end of the last
synchronize (a host annotation around them), so the host time before the
first launch and after the last kernel counts as idle, as a frame or step
loses it. The chrome trace goes to a file under TMPDIR, which is deleted
once read.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

from . import stats

ANNOTATION = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120


@dataclass
class Trace:
    """Device operations of the traced interval, times in seconds from the
    trace's own origin."""

    lo: float
    hi: float
    units: int                                     # frames or steps traced
    kernels: list = field(default_factory=list)    # (name, start, dur)
    other_ops: list = field(default_factory=list)  # memcpy and memset
    host_ops: list = field(default_factory=list)   # (name, start, dur)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return self.busy_s_of(lambda n: True)

    def busy_s_of(self, keep) -> float:
        """Seconds of the traced interval in which a device operation whose
        name keep(name) accepts ran."""
        ops = [op for op in self.kernels + self.other_ops if keep(op[0])]
        return stats.union_length(stats.clip(
            [(s, s + d) for _, s, d in ops], self.lo, self.hi))

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    @property
    def launches_per_unit(self) -> float:
        return len(self.kernels) / self.units

    def kernel_seconds(self, match) -> float:
        """Device seconds of the kernels whose name match(name) accepts."""
        return sum(d for n, _, d in self.kernels if match(n))

    def device_part(self) -> "Trace":
        """This trace without its host operations, each kernel name held
        once, so that it pickles small (a rank hands it to rank 0)."""
        held: dict = {}

        def ops(rows):
            return [(held.setdefault(n, n), s, d) for n, s, d in rows]

        return Trace(self.lo, self.hi, self.units, ops(self.kernels),
                     ops(self.other_ops))

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for n, _, d in self.kernels + self.other_ops:
            by_name[n[:NAME_CHARS]] = by_name.get(n[:NAME_CHARS], 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        spans = [(s, s + d) for _, s, d in self.kernels + self.other_ops]
        idle = sorted(stats.gaps(spans, self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_at((a + b) / 2.0), b - a]
                              for a, b in idle]}

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at time t."""
        best = None
        for n, s, d in self.host_ops:
            if s <= t <= s + d and (best is None or d < best[1]):
                best = (n, d)
        return f"host: {best[0][:NAME_CHARS]}" if best else "host: none"


def collective(name: str) -> bool:
    """True for a kernel of NCCL's (its name begins with "nccl", in any
    case): a collective of a sharded step, which spins on the card until
    every rank has arrived."""
    return name.lower().startswith("nccl")


def collective_seconds(traces: list):
    """(transfer, per-rank) seconds of the collectives in the ranks'
    traces of the same steps. Every rank runs the same collectives in the
    same order, and the last rank to arrive at one waits least, so the
    transfer is, collective by collective, the shortest of the ranks'
    kernels; where the profiler lost a record and the ranks' counts
    differ, the smallest rank's total. per-rank: each rank's whole NCCL
    time, transfer and wait. None without a trace that holds one."""
    per = [[d for n, _, d in sorted(tr.kernels, key=lambda k: k[1])
            if collective(n)] for tr in traces]
    if not per or not all(per):
        return None
    if len({len(p) for p in per}) == 1:
        return sum(min(col) for col in zip(*per)), [sum(p) for p in per]
    return min(sum(p) for p in per), [sum(p) for p in per]


def names(kernels):
    """name -> True when a trace kernel name is one of kernels, as whole
    words (mesh_search_kernel does not match mesh_search_mxu_kernel)."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, kernels)) + r")\b")
    return lambda n: pat.search(n) is not None


def read_chrome_trace(path: str, units: int) -> Trace:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    window = [e for e in events if e.get("name") == ANNOTATION
              and e.get("ph") == "X"]
    if not window:
        raise RuntimeError(f"the trace holds no {ANNOTATION!r} annotation")
    lo = float(window[0]["ts"]) * 1e-6
    hi = lo + float(window[0]["dur"]) * 1e-6
    tr = Trace(lo, hi, units)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        if start + dur < lo or start > hi:
            continue
        cat = e.get("cat", "")
        row = (str(e.get("name", "")), start, dur)
        if cat == "kernel":
            tr.kernels.append(row)
        elif cat in DEVICE_CATS:
            tr.other_ops.append(row)
        elif cat in ("cpu_op", "cuda_runtime", "user_annotation") \
                and row[0] != ANNOTATION:
            tr.host_ops.append(row)
    return tr


@contextlib.contextmanager
def traced(units: int, out: list):
    """Profile the body, which runs `units` whole frames or steps and ends
    in a synchronize; appends the reduced Trace to out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(ANNOTATION):
            yield
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out.append(read_chrome_trace(path, units))
    finally:
        os.unlink(path)
