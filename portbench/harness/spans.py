"""The port's spans in a reduced trace, and each kernel put under them.

The port opens ``torch.profiler.record_function`` spans named ``qtrt.*``
at its layer boundaries (``qt_raytracer_tpu_torch/runtime/spans.py``); in
a ``Trace`` they are among ``host_ops`` (the ``user_annotation`` events),
beside the host runtime calls that launch the kernels.

A kernel's launch point is the start of its launch call. The ``Trace``
keeps names and times alone, no correlation ids, so the launch calls are
paired with the kernels by order (``launch_points``). A kernel belongs to
every ``qtrt.`` span that holds its launch point, the innermost (shortest)
first. Only one host thread launches at a time in the port (the calling
thread waits inside ``qtrt.train.backward`` while the autograd thread runs
the backward), so containment in time stands for containment on the
launching thread.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

# The port's span names (its runtime/spans.py), written out: the benchmark
# also runs ports that have no such module, and then reads no span.
PREFIX = "qtrt."
CHUNK = "qtrt.render.chunk"
PREP = "qtrt.prep"
RNG = "qtrt.rng"
SHADE = "qtrt.shade"
HIT_MESH = "qtrt.hit.mesh"
TRAIN_BACKWARD = "qtrt.train.backward"

# The runtime calls that put one kernel on a stream.
LAUNCH = re.compile(r"^cudaLaunch(Kernel|KernelExC|CooperativeKernel)"
                    r"(_v\d+)?$")
BLOCK = 256          # kernels whose launches share one offset
MIN_ANCHORS = 8      # idle-start kernels a block needs to judge an offset
SEARCH = 4           # offsets tried either side of the last
JUMP = 4.0           # a best fit this many times the usual: records lost
TIE = 1.25           # fits within this factor of the best count as equal
SWITCH = 2.0         # the last offset gives way to a fit this much better
QUEUE_SLACK_S = 10e-6  # a delay this far under the line breaks the order
IDLE_GAP_S = 20e-6   # an idle stretch before a kernel at least this long


@dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float


@dataclass
class Attribution:
    """Each kernel of a Trace ([name, start, dur], the Trace's order) with
    its launch point (None where unpaired) and the spans that hold it,
    innermost first."""

    spans: list          # every qtrt. Span, in start order
    launch: list         # per kernel: launch point in seconds, or None
    chains: list         # per kernel: tuple of Spans, innermost first

    def kernel_seconds(self, kernels, take, keep=None) -> float:
        """Device seconds of the kernels whose chain take(chain) accepts
        and, given keep, whose name keep(name) accepts."""
        return sum(k[2] for k, c in zip(kernels, self.chains)
                   if take(c) and (keep is None or keep(k[0])))


def program_spans(tr) -> list:
    return sorted((Span(n, s, s + d) for n, s, d in tr.host_ops
                   if n.startswith(PREFIX)), key=lambda sp: sp.start)


def launch_points(tr) -> list:
    """Per kernel of tr, the start of its launch call, or None.

    One stream runs kernels in launch order, so the i-th kernel is the
    (i + offset)-th launch call, with an offset that changes only where a
    launch or a kernel went unrecorded (the first launches of a capture
    can miss their kernels, the window can clip the last ones, and a
    capture can drop a run of records). The offset is chosen block by
    block: the one under which the delays from launch call to kernel start
    of the block's idle-start kernels (which begin a few microseconds
    after their launch) lie closest to a line over time. The line takes up
    the drift of the device clock from the host's, up to 0.1% of a trace.
    Where no offset near the last fits, records went missing, and the
    search widens to the surplus of calls over kernels. Where the offset
    changes, the change goes to the kernel that fits both sides best;
    where that leaves one call to two kernels, the worse fit gets None, as
    does a kernel whose call would fall outside the launch calls."""
    calls = sorted(s for n, s, _ in tr.host_ops if LAUNCH.match(n))
    order = sorted(range(len(tr.kernels)), key=lambda i: tr.kernels[i][1])
    starts = [tr.kernels[i][1] for i in order]
    out = [None] * len(starts)
    if not starts or not calls:
        return out
    fit = _Fit(starts, calls, _idle_starts(tr, starts))
    offsets, expect = fit.offsets()
    owner: dict = {}
    for i, off in enumerate(offsets):
        j = i + off
        if not 0 <= j < len(calls):
            continue
        miss = abs(starts[i] - calls[j] - expect[i])
        if j in owner and owner[j][1] <= miss:
            continue
        if j in owner:
            out[order[owner[j][0]]] = None
        owner[j] = (i, miss)
        out[order[i]] = calls[j]
    return out


class _Fit:
    """The offsets of launch_points: kernel starts and call starts, both
    sorted, and which kernels found the device idle (the anchors)."""

    def __init__(self, starts, calls, idle):
        self.starts, self.calls, self.idle = starts, calls, idle

    def line(self, anchors, off):
        """(median distance of the anchors' delays from a line through
        them over time, the line as (a, b): delay = a + b * start), or
        None with too few anchors under offset off. The line follows the
        clocks' drift; the distance from it is what an offset is judged
        by."""
        pts = [(self.starts[i], self.starts[i] - self.calls[i + off])
               for i in anchors if 0 <= i + off < len(self.calls)]
        if len(pts) < MIN_ANCHORS:
            return None
        half = len(pts) // 2
        t0, d0 = _median([t for t, _ in pts[:half]]), \
            _median([d for _, d in pts[:half]])
        t1, d1 = _median([t for t, _ in pts[half:]]), \
            _median([d for _, d in pts[half:]])
        b = (d1 - d0) / (t1 - t0) if t1 > t0 else 0.0
        a = _median([d - b * t for t, d in pts])
        return _median([abs(d - a - b * t) for t, d in pts]), (a, b)

    def offsets(self):
        """Per kernel, its offset and the delay its block's line
        predicts."""
        n_k, extra = len(self.starts), len(self.calls) - len(self.starts)

        def wide(off):
            return range(off - SEARCH, off + max(SEARCH, extra) + 1)

        blocks, offset, fit, seen = [], 0, (0.0, 0.0), []
        tries = wide(0)
        for lo in range(0, n_k, BLOCK):
            hi = min(lo + BLOCK, n_k)
            anchors = [i for i in range(lo, hi) if self.idle[i]]
            scores = self.scores(anchors, tries)
            usual = _median(seen[-16:]) if seen else None

            def broken():
                return usual is not None and \
                    min(v[0] for v in scores.values()) > JUMP * usual

            if scores and broken():
                scores.update(self.scores(anchors, wide(offset)))
            if not scores or broken():
                # Too few anchors, or a block that straddles lost records:
                # the blocks on either side place the change.
                blocks.append((lo, hi, offset, fit, False))
                tries = wide(offset) if scores else tries
                continue
            low = min(v[0] for v in scores.values())
            best = min((o for o, v in scores.items() if v[0] <= TIE * low),
                       key=lambda o: abs(o - offset))
            if offset not in scores or \
                    scores[offset][0] > SWITCH * scores[best][0]:
                offset = best
            fit = scores[offset][1]
            seen.append(scores[offset][0])
            blocks.append((lo, hi, offset, fit, True))
            tries = range(offset - SEARCH, offset + SEARCH + 1)
        offsets, lines = [], []
        for lo, hi, off, f, _ in blocks:
            offsets += [off] * (hi - lo)
            lines += [f] * (hi - lo)
        good = [blk for blk in blocks if blk[4]]
        for x, y in zip(good, good[1:]):
            if x[2] != y[2]:
                self.place_change(offsets, lines, x, y)
        return offsets, [a + b * t for (a, b), t in zip(lines, self.starts)]

    def scores(self, anchors, tries) -> dict:
        out = {}
        for off in tries:
            f = self.line(anchors, off)
            if f is not None:
                out[off] = f
        return out

    def place_change(self, offsets, lines, x, y):
        """Move the change from block x's offset to block y's, anywhere
        from x's start to y's end, to the kernel where the anchors on
        either side fit their own block's line best."""
        lo, hi = x[0], y[1]
        anchors = [i for i in range(lo, hi) if self.idle[i]]

        def miss(i, blk):
            j = i + blk[2]
            if not 0 <= j < len(self.calls):
                return 1.0       # a second: worse than any real miss
            a, b = blk[3]
            t = self.starts[i]
            return abs(t - self.calls[j] - a - b * t)

        before = sum(miss(i, y) for i in anchors)
        best, cut = before, lo
        for i in anchors:
            before += miss(i, x) - miss(i, y)
            if before < best:
                best, cut = before, i + 1
        # Between that anchor and the next, a queued kernel starts no
        # sooner after its launch than an idle one: place the change
        # where the fewest kernels would break that.
        nxt = next((i for i in anchors if i >= cut), hi)

        def early(i, blk):
            j = i + blk[2]
            if not 0 <= j < len(self.calls):
                return True
            a, b = blk[3]
            t = self.starts[i]
            return t - self.calls[j] < a + b * t - QUEUE_SLACK_S

        cut = min(range(cut, nxt + 1), key=lambda c: sum(
            early(i, x if i < c else y) for i in range(cut, nxt)))
        for i in range(lo, hi):
            blk = x if i < cut else y
            offsets[i], lines[i] = blk[2], blk[3]


def _idle_starts(tr, starts) -> list:
    """Per kernel start (sorted), True where no device operation ran in
    the IDLE_GAP_S before it."""
    device = sorted((s, s + d) for _, s, d in tr.kernels + tr.other_ops)
    out, busy_until, p = [], float("-inf"), 0
    for start in starts:
        while p < len(device) and device[p][0] < start:
            busy_until = max(busy_until, device[p][1])
            p += 1
        out.append(start - busy_until > IDLE_GAP_S)
    return out


def _median(values) -> float:
    xs = sorted(values)
    return xs[len(xs) // 2]


def _spread(values) -> float:
    """Median absolute deviation from the median."""
    med = _median(values)
    return _median([abs(x - med) for x in values])


def attribute(tr) -> Attribution:
    """The Attribution of tr, computed once per Trace. A kernel without a
    launch point was launched between its neighbours on the stream, so it
    takes the spans that hold both of theirs."""
    cached = getattr(tr, "_qtrt_attribution", None)
    if cached is not None:
        return cached
    sps = program_spans(tr)
    launch = launch_points(tr)
    paired = sorted((t, i) for i, t in enumerate(launch) if t is not None)
    times = [t for t, _ in paired]
    holders: list = [[] for _ in launch]
    for sp in sps:
        lo = bisect.bisect_left(times, sp.start)
        hi = bisect.bisect_right(times, sp.end)
        for _, i in paired[lo:hi]:
            holders[i].append(sp)
    chains = [tuple(sorted(h, key=lambda sp: sp.end - sp.start))
              for h in holders]
    order = sorted(range(len(launch)), key=lambda i: tr.kernels[i][1])
    known = [i for i in order if launch[i] is not None]
    rank = {i: r for r, i in enumerate(order)}
    ranks = [rank[i] for i in known]
    for i in order:
        if launch[i] is None and known:
            r = bisect.bisect_left(ranks, rank[i])
            prev = chains[known[r - 1]] if r > 0 else ()
            nxt = chains[known[r]] if r < len(known) else ()
            chains[i] = tuple(sp for sp in prev if sp in nxt)
    att = Attribution(sps, launch, chains)
    tr._qtrt_attribution = att
    return att


def innermost_ms_per_unit(run, name: str):
    """Device ms a unit of kernels whose innermost span is name; None
    without a trace or a span of that name in it."""
    return _ms_per_unit(run, name, lambda c: bool(c) and c[0].name == name)


def within_ms_per_unit(run, name: str, keep=None):
    """Device ms a unit of kernels launched inside a span named name,
    nested spans included, and, given keep, whose name keep(name) accepts;
    None as innermost_ms_per_unit."""
    return _ms_per_unit(run, name, lambda c: any(sp.name == name for sp in c),
                        keep)


def _ms_per_unit(run, name, take, keep=None):
    tr = run.trace_data
    if tr is None:
        return None
    att = attribute(tr)
    if not any(sp.name == name for sp in att.spans):
        return None
    return att.kernel_seconds(tr.kernels, take, keep) * 1e3 / tr.units


def recompute_ms_per_unit(run):
    """Device ms a unit of kernels inside the chunk spans that lie within
    a backward span: the checkpoint's recompute."""
    tr = run.trace_data
    if tr is None:
        return None
    att = attribute(tr)
    backs = [sp for sp in att.spans if sp.name == TRAIN_BACKWARD]
    inner = {sp for sp in att.spans if sp.name == CHUNK and any(
        b.start <= sp.start and sp.end <= b.end for b in backs)}
    if not inner:
        return None
    return att.kernel_seconds(
        tr.kernels, lambda c: any(sp in inner for sp in c)) * 1e3 / tr.units


def host_ms_per_unit(run, name: str):
    """Host-clock ms a unit inside spans named name; None as
    innermost_ms_per_unit."""
    tr = run.trace_data
    if tr is None:
        return None
    found = [sp.end - sp.start for sp in program_spans(tr) if sp.name == name]
    if not found:
        return None
    return sum(found) * 1e3 / tr.units
