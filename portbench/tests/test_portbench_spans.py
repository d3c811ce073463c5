"""The span metrics on a synthetic Chrome trace written by the test: host
runtime calls and kernels tied by correlation ids (which the reduced Trace
drops), a launch whose kernel went unrecorded, a kernel whose runtime call
went unrecorded (only its aten op's External id names it), a device clock
that drifts from the host's, nested ``qtrt.`` spans, and a backward whose
kernels a second thread launches. The six span readers are held against
what the ids say; the Trace's own fields and the seven earlier metrics
against numbers the test works out from the events itself."""

import json
import random
import types

import pytest

from portbench.harness import manifest, spans, stats
from portbench.harness import trace as trace_mod

UNITS = 2
DRIFT = 1.0008          # device clock over host clock
MAIN, AUTOGRAD = 1, 2   # thread ids
HANDWRITTEN = "void (anonymous namespace)::mesh_search_kernel<false, 0>(float)"
SPHERE = "void (anonymous namespace)::fused_hit_kernel<false, false>(float)"
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"


class Program:
    """Writes the events of a small traced program: each launch is an aten
    op around a runtime call on the host, and a kernel on the one stream,
    which starts after its launch and after the kernel before it."""

    def __init__(self, seed, with_spans=True, lost=()):
        self.rnd = random.Random(seed)
        self.with_spans = with_spans
        self.lost = set(lost)                # launches whose kernel is lost
        self.events, self.kernels = [], []   # kernels: truth per kernel
        self.t, self.device_free, self.corr = 1000.0, 0.0, 0
        self.open = []                       # (name, start, tid) stack

    def device(self, host_us):
        return 1000.0 + (host_us - 1000.0) * DRIFT

    def launch(self, tid=MAIN, name=None, long=False, record_call=True,
               record_kernel=True):
        self.corr += 1
        record_kernel = record_kernel and self.corr not in self.lost
        t0 = self.t
        call = t0 + 2.0
        self.events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mul",
                            "ts": t0, "dur": 9.0, "tid": tid,
                            "args": {"External id": self.corr}})
        if record_call:
            self.events.append({"ph": "X", "cat": "cuda_runtime",
                                "name": "cudaLaunchKernel", "ts": call,
                                "dur": 4.0, "tid": tid,
                                "args": {"correlation": self.corr,
                                         "External id": self.corr}})
        start = max(self.device(call) + 5.0 + self.rnd.uniform(0.0, 2.0),
                    self.device_free + 1.0)
        dur = self.rnd.uniform(300.0, 900.0) if long \
            else self.rnd.uniform(2.0, 30.0)
        if record_kernel:
            self.device_free = start + dur
            kname = name or f"void at::native::elementwise_kernel_{self.corr}"
            self.events.append({"ph": "X", "cat": "kernel", "name": kname,
                                "ts": start, "dur": dur, "tid": 7,
                                "args": {"correlation": self.corr,
                                         "External id": self.corr}})
            chain = [n for n, s, th in reversed(self.open)]
            self.kernels.append({"name": kname, "start": start, "dur": dur,
                                 "launch": call if record_call else None,
                                 "op": t0, "chain": chain})
        self.t += 9.0 + self.rnd.uniform(3.0, 25.0)

    def memcpy(self):
        self.events.append({"ph": "X", "cat": "cuda_runtime",
                            "name": "cudaMemcpyAsync", "ts": self.t,
                            "dur": 20.0, "tid": MAIN, "args": {}})
        start = max(self.device(self.t) + 5.0, self.device_free + 1.0)
        self.events.append({"ph": "X", "cat": "gpu_memcpy",
                            "name": "Memcpy DtoH (Device -> Pinned)",
                            "ts": start, "dur": 15.0, "tid": 7, "args": {}})
        self.device_free = start + 15.0
        self.t += 40.0

    def push(self, name, tid=MAIN):
        self.open.append((name, self.t, tid))
        self.t += 1.0

    def pop(self):
        name, start, tid = self.open.pop()
        self.t += 1.0
        if self.with_spans:
            self.events.append({"ph": "X", "cat": "user_annotation",
                                "name": name, "ts": start,
                                "dur": self.t - start, "tid": tid})
        self.t += 1.0

    def idle(self, us):
        self.t += us


def program(seed=17, with_spans=True, frames=UNITS, lost=(), nccl=False):
    """Frames and a backward; returns (Program, chrome trace dict). lost:
    the launches (counted from 1) whose kernel records are dropped; nccl:
    the backward ends in a long NCCL kernel, as a sharded step's does."""
    p = Program(seed, with_spans, lost)
    lo = p.t
    p.t += 5.0
    p.launch(record_kernel=False)          # the capture missed its kernel
    p.idle(300.0)
    for unit in range(frames):
        p.push(spans.CHUNK)
        p.push(spans.PREP)
        p.idle(120.0)
        p.pop()
        p.push(spans.RNG)
        for _ in range(12):
            p.launch()
        p.pop()
        for bounce in range(3):
            p.launch(name=SPHERE)
            p.push(spans.HIT_MESH)
            for _ in range(6):
                p.launch()
            p.launch(name=HANDWRITTEN, long=True)
            for _ in range(10):
                p.launch()                 # queued behind the long kernel
            p.pop()
            p.idle(900.0)
            p.push(spans.SHADE)
            for k in range(12):
                p.launch(record_call=not (unit == 1 and bounce == 1
                                          and k == 6))
            p.push(spans.RNG)
            for _ in range(8):
                p.launch()
            p.pop()
            for _ in range(6):
                p.launch()
            p.pop()
        p.pop()
        p.memcpy()
        p.idle(500.0)
    # The backward: the calling thread waits in its span while the autograd
    # thread launches, and opens the recompute's chunk spans.
    p.push(spans.TRAIN_BACKWARD)
    for _ in range(20):
        p.launch(tid=AUTOGRAD)
    p.push(spans.CHUNK, tid=AUTOGRAD)
    p.push(spans.RNG, tid=AUTOGRAD)
    for _ in range(10):
        p.launch(tid=AUTOGRAD)
    p.pop()
    for _ in range(30):
        p.launch(tid=AUTOGRAD)
    p.pop()
    for _ in range(15):
        p.launch(tid=AUTOGRAD)
    if nccl:
        p.launch(tid=AUTOGRAD, name=NCCL, long=True)
    p.pop()
    p.idle(200.0)
    p.events.append({"ph": "X", "cat": "cuda_runtime",
                     "name": "cudaDeviceSynchronize", "ts": p.t,
                     "dur": max(p.device_free - p.t, 0.0) + 5.0,
                     "tid": MAIN, "args": {}})
    p.t = max(p.t, p.device_free) + 10.0
    p.events.append({"ph": "X", "cat": "user_annotation",
                     "name": trace_mod.ANNOTATION, "ts": lo,
                     "dur": p.t - lo, "tid": MAIN})
    return p, {"traceEvents": p.events}


def _read(tmp_path, doc):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    return trace_mod.read_chrome_trace(str(path), UNITS)


def _run(tr):
    return types.SimpleNamespace(trace_data=tr)


def _truth_ms(p, take):
    return sum(k["dur"] for k in p.kernels if take(k)) * 1e-3 / UNITS


@pytest.fixture
def traced(tmp_path):
    p, doc = program()
    return p, _read(tmp_path, doc)


def test_launch_points_match_the_correlation_ids(traced):
    p, tr = traced
    found = spans.launch_points(tr)
    assert len(found) == len(p.kernels)
    for k, got in zip(p.kernels, found):
        want = None if k["launch"] is None else k["launch"] * 1e-6
        assert got == pytest.approx(want, abs=1e-12), k


def test_a_run_of_lost_kernel_records_mid_trace(tmp_path):
    # Forty kernels in a row missing from a capture of eight frames: the
    # offset between calls and kernels jumps by forty there.
    p, doc = program(frames=8, lost=range(600, 640))
    tr = _read(tmp_path, doc)
    found = spans.launch_points(tr)
    total = sum(k["dur"] for k in p.kernels)
    right = sum(k["dur"] for k, got in zip(p.kernels, found)
                if got is not None and k["launch"] is not None
                and abs(got - k["launch"] * 1e-6) < 1e-12)
    assert len(p.kernels) > 1000 and right > 0.99 * total


def test_the_clock_drifts_and_kernels_queue(traced):
    # The trace is what makes the pairing hard: launches recorded without
    # a kernel and a kernel without its call, a device clock that runs
    # ahead, and kernels that wait behind a long one.
    p, tr = traced
    delays = [k["start"] - k["launch"] for k in p.kernels
              if k["launch"] is not None]
    assert max(delays) > 500.0 and min(delays) < 10.0
    assert len([e for e in p.events if e["name"] == "cudaLaunchKernel"]) \
        == len(p.kernels)


def test_missing_call_takes_its_neighbours_spans(traced):
    p, tr = traced
    att = spans.attribute(tr)
    i = next(n for n, k in enumerate(p.kernels) if k["launch"] is None)
    assert att.launch[i] is None
    assert [sp.name for sp in att.chains[i]] == [spans.SHADE, spans.CHUNK]


def test_span_readers_read_what_the_ids_say(traced):
    p, tr = traced
    run = _run(tr)

    def innermost(name):
        return lambda k: bool(k["chain"]) and k["chain"][0] == name

    def within(name):
        return lambda k: name in k["chain"]

    def recompute(k):
        return spans.TRAIN_BACKWARD in k["chain"] and spans.CHUNK in k["chain"]

    want = {
        "rng_ms_per_frame": _truth_ms(p, innermost(spans.RNG)),
        "shade_ms_per_frame": _truth_ms(p, innermost(spans.SHADE)),
        "mesh_ms_per_frame": _truth_ms(p, within(spans.HIT_MESH)),
        "backward_ms_per_step": _truth_ms(p, within(spans.TRAIN_BACKWARD)),
        "recompute_ms_per_step": _truth_ms(p, recompute),
    }
    prep = [e for e in p.events if e["name"] == spans.PREP]
    want["prep_host_ms_per_frame"] = sum(e["dur"] for e in prep) \
        * 1e-3 / UNITS
    for name, value in want.items():
        assert value > 0
        got = manifest.metric_module(name).read(run)
        assert got == pytest.approx(value, rel=1e-9), name
    # The recompute is part of the backward, and every kernel is in a
    # span or not, once.
    assert want["recompute_ms_per_step"] < want["backward_ms_per_step"]
    att = spans.attribute(tr)
    assert sum(k[2] for k in tr.kernels) == pytest.approx(
        att.kernel_seconds(tr.kernels, lambda c: True))


def test_collectives_leave_the_backward_and_count_as_idle(tmp_path):
    # A sharded step's NCCL kernel inside the backward: the backward's
    # metric leaves it out, and the train idle share counts it as idle.
    p, doc = program(nccl=True)
    tr = _read(tmp_path, doc)
    run = _run(tr)
    back = manifest.metric_module("backward_ms_per_step").read(run)
    assert back == pytest.approx(_truth_ms(
        p, lambda k: spans.TRAIN_BACKWARD in k["chain"]
        and k["name"] != NCCL), rel=1e-9)
    assert back < _truth_ms(p, lambda k: spans.TRAIN_BACKWARD in k["chain"])
    spin = sum(k["dur"] for k in p.kernels if k["name"] == NCCL) * 1e-6
    idle = manifest.metric_module("idle_pct.train").read(run)
    assert idle - tr.idle_pct == pytest.approx(100.0 * spin / tr.window_s,
                                               rel=1e-6)
    # Without one, both read what they read before.
    _, plain = program()
    tr = _read(tmp_path, plain)
    assert manifest.metric_module("idle_pct.train").read(_run(tr)) == \
        tr.idle_pct


def test_mesh_kernels_fall_inside_the_mesh_span(traced):
    p, tr = traced
    att = spans.attribute(tr)
    mesh = trace_mod.names(manifest.roofline_rule("mesh").KERNELS)
    inside = att.kernel_seconds(
        tr.kernels, lambda c: any(sp.name == spans.HIT_MESH for sp in c))
    assert tr.kernel_seconds(mesh) > 0
    assert all(any(sp.name == spans.HIT_MESH for sp in c)
               for k, c in zip(tr.kernels, att.chains) if mesh(k[0]))
    assert inside >= tr.kernel_seconds(mesh)


@pytest.mark.parametrize("name", ["rng_ms_per_frame", "shade_ms_per_frame",
                                  "prep_host_ms_per_frame",
                                  "mesh_ms_per_frame", "backward_ms_per_step",
                                  "recompute_ms_per_step"])
def test_span_readers_are_silent_without_spans(tmp_path, name):
    # The parent's program opens no span: the metric is left out.
    _, doc = program(with_spans=False)
    mod = manifest.metric_module(name)
    assert mod.read(_run(_read(tmp_path, doc))) is None
    assert mod.read(_run(None)) is None


def test_trace_fields_and_earlier_metrics_read_the_events(traced):
    p, tr = traced
    events = p.events
    win = next(e for e in events if e["name"] == trace_mod.ANNOTATION)
    assert tr.lo == win["ts"] * 1e-6
    assert tr.hi == pytest.approx((win["ts"] + win["dur"]) * 1e-6)
    kern = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6) for e in events
            if e["cat"] == "kernel"]
    other = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6) for e in events
             if e["cat"] == "gpu_memcpy"]
    host = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6) for e in events
            if e["cat"] in ("cpu_op", "cuda_runtime", "user_annotation")
            and e["name"] != trace_mod.ANNOTATION]
    assert tr.kernels == kern and tr.other_ops == other
    assert tr.host_ops == host
    busy = stats.union_length((s, s + d) for _, s, d in kern + other)
    assert tr.busy_s == pytest.approx(busy)
    assert tr.window_s == pytest.approx(win["dur"] * 1e-6)
    run = _run(tr)
    read = lambda name: manifest.metric_module(name).read(run)  # noqa: E731
    idle = 100.0 * (1.0 - busy / (win["dur"] * 1e-6))
    assert read("idle_pct.frame") == pytest.approx(idle)
    assert read("idle_pct.train") == pytest.approx(idle)
    assert read("launches_per_frame") == len(kern) / UNITS
    assert read("launches_per_step") == len(kern) / UNITS
    glue = sum(d for n, _, d in kern if n not in (HANDWRITTEN, SPHERE))
    assert read("glue_ms_per_frame") == pytest.approx(glue * 1e3 / UNITS)
    # The rooflines divide by their rule's kernels' device time.
    for layer, name in (("mesh", HANDWRITTEN), ("sphere_hit", SPHERE)):
        rule = manifest.roofline_rule(layer)
        assert tr.kernel_seconds(trace_mod.names(rule.KERNELS)) == \
            pytest.approx(sum(d for n, _, d in kern if n == name))
    calls = []
    stub = types.SimpleNamespace(
        trace_data=tr, roofline_pct=lambda layer: calls.append(layer) or 1.5)
    assert manifest.metric_module("mesh_roofline").read(stub) == 1.5
    assert manifest.metric_module("sphere_hit_roofline").read(stub) == 1.5
    assert calls == ["mesh", "sphere_hit"]
    # The breakdown names an idle gap inside a span, outside any aten op,
    # by the span.
    gaps = [g[0] for g in tr.breakdown()["idle_gaps"]]
    assert f"host: {spans.CHUNK}" in gaps
