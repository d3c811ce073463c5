"""The port's spans (``runtime.spans``) in a ``torch.profiler`` capture, on
the CPU: where each opens, how they nest, that the backward's recompute
opens the chunk span again, and that with no profiler running ``annotate``
opens no ``record_function`` at all."""

import json

import pytest
import torch

from qt_raytracer_tpu_torch import RenderConfig, render_linear, scenes
from qt_raytracer_tpu_torch.app import profiling
from qt_raytracer_tpu_torch.core import sampling
from qt_raytracer_tpu_torch.diff import inverse
from qt_raytracer_tpu_torch.runtime import spans

from torch_helpers import _one_thread  # noqa: F401

# 16x12 = 192 pixels in chunks of 64: 3 chunks.
CHUNKED = dict(width=16, height=12, max_depth=3, pixel_chunk=64)


def _spans(tmp_path, fn):
    """fn() inside profiling.trace: the capture's qtrt. spans as
    (name, start, end, tid), in start order."""
    with profiling.trace(str(tmp_path)) as prof:
        fn()
    with open(prof.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
            e.get("tid")) for e in events
           if e.get("cat") == "user_annotation"
           and str(e.get("name", "")).startswith("qtrt.")]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return inner[3] == outer[3] and outer[1] <= inner[1] \
        and inner[2] <= outer[2]


def _count(found, name):
    return sum(1 for s in found if s[0] == name)


def _sphere_render():
    scene, cam = scenes.get_scene("three_sphere", 16 / 12, device="cpu")
    return scene, cam


@pytest.mark.parametrize("spp,spb", [(2, 1), (2, 2)])
def test_chunked_render_spans(tmp_path, spp, spb):
    cfg = RenderConfig(spp=spp, samples_per_batch=spb, **CHUNKED)
    scene, cam = _sphere_render()
    found = _spans(tmp_path, lambda: render_linear(scene, cam, cfg, 0))
    batches = 3 * (spp // spb)
    chunks = [s for s in found if s[0] == spans.CHUNK]
    assert len(chunks) == batches
    # A forward render builds its tables once, before its chunks, and
    # hands them to every (chunk, batch).
    preps = [s for s in found if s[0] == spans.PREP]
    assert len(preps) == 1
    assert not any(_inside(preps[0], c) for c in chunks)
    assert all(preps[0][2] <= c[1] for c in chunks)
    # Every bounce shades once, inside its chunk; the RNG runs inside the
    # chunks (sample keys, camera jitter) and inside the shading (the
    # bounce's uniforms), bar the pixel states made once before them.
    shades = [s for s in found if s[0] == spans.SHADE]
    assert len(shades) == batches * cfg.max_depth
    assert all(any(_inside(s, c) for c in chunks) for s in shades)
    rngs = [s for s in found if s[0] == spans.RNG]
    outside = [r for r in rngs if not any(_inside(r, c) for c in chunks)]
    assert len(outside) == 1
    in_shade = [r for r in rngs if any(_inside(r, s) for s in shades)]
    assert len(in_shade) == len(shades)
    assert _count(found, spans.HIT_MESH) == 0


def test_mesh_world_render_spans(tmp_path):
    cfg = RenderConfig(spp=1, **CHUNKED)
    world, cam = scenes.get_scene("terrain", cfg.aspect_ratio, device="cpu")
    found = _spans(tmp_path, lambda: render_linear(world, cam, cfg, 0))
    chunks = [s for s in found if s[0] == spans.CHUNK]
    assert len(chunks) == 3
    preps = [s for s in found if s[0] == spans.PREP]
    assert len(preps) == 1
    assert all(preps[0][2] <= c[1] for c in chunks)
    # The mesh search of every bounce, inside its chunk.
    hits = [s for s in found if s[0] == spans.HIT_MESH]
    assert len(hits) == 3 * cfg.max_depth
    assert all(any(_inside(h, c) for c in chunks) for h in hits)


def test_portable_walk_opens_the_mesh_span(tmp_path):
    cfg = RenderConfig(spp=1, width=8, height=6, max_depth=2,
                       intersector="xla")
    world, cam = scenes.get_scene("terrain", cfg.aspect_ratio, device="cpu")
    found = _spans(tmp_path, lambda: render_linear(world, cam, cfg, 0))
    assert _count(found, spans.HIT_MESH) >= cfg.max_depth
    assert _count(found, spans.CHUNK) == 1


def _train_once(cfg):
    scene, cam = _sphere_render()
    target = torch.zeros((cfg.height, cfg.width, 3))
    init, step, _, _ = inverse.make_train_step(
        scene, cam, cfg, inverse.adam(0.05), trainable=("albedo",))
    state = init()
    return lambda: step(state, target, 1)


def test_train_step_backward_holds_the_recompute(tmp_path):
    cfg = RenderConfig(spp=2, samples_per_batch=1, nee=True, **CHUNKED)
    found = _spans(tmp_path, _train_once(cfg))
    back = [s for s in found if s[0] == spans.TRAIN_BACKWARD]
    assert len(back) == 1
    chunks = [s for s in found if s[0] == spans.CHUNK]
    # The forward opens a chunk span a (chunk, batch); the checkpoint's
    # recompute opens each again inside the backward.
    within = [c for c in chunks if back[0][1] <= c[1] and c[2] <= back[0][2]]
    assert len(within) == 6
    assert len(chunks) == 12
    assert all(c[2] <= back[0][1] for c in chunks if c not in within)
    # Under grad every (chunk, batch) builds its own tables, the recompute
    # too: one table prep inside every chunk span.
    preps = [s for s in found if s[0] == spans.PREP]
    assert len(preps) == len(chunks)
    assert all(sum(_inside(p, c) for p in preps) == 1 for c in chunks)


def test_spans_names_every_span_the_port_opens(tmp_path):
    cfg = RenderConfig(spp=1, **CHUNKED)
    world, cam = scenes.get_scene("terrain", cfg.aspect_ratio, device="cpu")
    names = {s[0] for s in _spans(tmp_path,
                                  lambda: render_linear(world, cam, cfg, 0))}
    names |= {s[0] for s in _spans(tmp_path, _train_once(
        RenderConfig(spp=1, **CHUNKED)))}
    assert names == set(spans.SPANS)
    assert len(spans.SPANS) == len(set(spans.SPANS))


def test_annotate_is_the_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = spans.annotate(spans.RNG)
    assert first is spans.annotate(spans.SHADE)
    with first, spans.annotate(spans.CHUNK):
        keys = sampling.pixel_states(0, torch.arange(4))
    assert keys.shape == (4,)
    scene, cam = _sphere_render()
    render_linear(scene, cam, RenderConfig(spp=1, width=8, height=6,
                                           max_depth=2), 0)


def test_annotate_records_inside_a_profiler(tmp_path):
    with profiling.trace(str(tmp_path)):
        cm = spans.annotate(spans.PREP)
        assert isinstance(cm, torch.profiler.record_function)
    assert spans.annotate(spans.PREP) is spans.annotate(spans.RNG)


def test_profiling_annotate_is_the_spans_helper():
    assert profiling.annotate is spans.annotate


def test_spanned_keeps_the_function_and_its_result():
    assert sampling.stream_uniforms.__name__ == "stream_uniforms"
    assert "uniforms" in sampling.stream_uniforms.__doc__
    calls = []

    @spans.spanned(spans.SHADE)
    def f(a, b=2):
        calls.append((a, b))
        return a + b

    assert f(1, b=3) == 4 and calls == [(1, 3)]
