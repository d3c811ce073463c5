"""The port's render path (trace_flat, render_linear, render) on the CPU,
through the plain version of the fused hit kernel, against the JAX package
with its Pallas kernel in interpret mode.

Budgets, as in tests/test_oracle_golden.py: f32 paths that graze a sphere
or sit on a discrete branch (Schlick choice, metal absorption) can flip on
an ulp, and the two packages round some multiply-adds differently, so at
most 1% of rays (or channels of per-sample means) may differ by more than
2e-3 + 2e-3 |ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu import render as j_render
from qt_raytracer_tpu import render_linear as j_render_linear
from qt_raytracer_tpu.core import camera as jcam
from qt_raytracer_tpu.core import sampling as jsam
from qt_raytracer_tpu.core.integrator_flat import trace_flat as j_trace_flat
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch import RenderConfig as TConfig
from qt_raytracer_tpu_torch import render as t_render
from qt_raytracer_tpu_torch import render_linear as t_render_linear
from qt_raytracer_tpu_torch import render_sample_batch as t_render_sample_batch
from qt_raytracer_tpu_torch import scenes as tscenes
from qt_raytracer_tpu_torch.core import integrator_flat as t_itg
from qt_raytracer_tpu_torch.core import render as t_render_mod
from qt_raytracer_tpu_torch.core import sampling as tsam
from qt_raytracer_tpu_torch.core.integrator_flat import trace_flat as t_trace_flat
from qt_raytracer_tpu_torch.diff import inverse as t_inverse
from qt_raytracer_tpu_torch.runtime import spans
from qt_raytracer_tpu_torch.utils.convert import camera_from_arrays, scene_from_arrays
from torch_helpers import _one_thread  # noqa: F401

ATOL = RTOL = 2e-3
MAX_MISMATCH = 0.01
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (CLAUDE.md).
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(name, aspect):
    js, jc = jscenes.get_scene(name, aspect)
    return (js, jc), (scene_from_arrays(_arrays(js), device="cpu"),
                      camera_from_arrays(_arrays(jc), device="cpu"))


def _mismatch(got, want):
    return np.abs(got - want) > ATOL + RTOL * np.abs(want)


@pytest.fixture(scope="module")
def rays():
    """1,024 book-cover camera rays with their hash sample states."""
    (js, jc), _ = _both("random", 16 / 9)
    rng = np.random.default_rng(9)
    n = 1024
    pix = rng.integers(0, 1920 * 1080, n).astype(np.uint32)
    keys = jsam.sample_keys(
        jsam.hash_pixel_states(jax.random.PRNGKey(SEED), jnp.asarray(pix)), 0)
    gen = np.asarray(jsam.stream_uniforms(keys, jsam.STREAM_GEN, 4))
    s = ((pix % 1920) + gen[:, 0]) / 1919.0
    t = ((1079 - pix // 1920) + gen[:, 1]) / 1079.0
    o, d = jcam.get_rays(jc, jnp.asarray(s, jnp.float32),
                         jnp.asarray(t, jnp.float32), jnp.asarray(gen[:, 2]),
                         jnp.asarray(gen[:, 3]))
    return js, np.asarray(o), np.asarray(d), np.asarray(keys)


@pytest.mark.parametrize("rr_start", [0, 2])
def test_trace_flat_matches_jax(rays, rr_start):
    js, o, d, keys = rays
    want = np.asarray(j_trace_flat(js, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(keys), 5, 1e-3,
                                   rr_start=rr_start, interpret=True))
    got = t_trace_flat(scene_from_arrays(_arrays(js),
                                         device="cpu"), torch.tensor(o),
                       torch.tensor(d), torch.tensor(keys.astype(np.int64)),
                       5, 1e-3,
                       rr_start=rr_start)
    assert got.shape == (o.shape[0], 3) and got.dtype == torch.float32
    bad_rays = _mismatch(got.numpy(), want).any(axis=1)
    assert bad_rays.mean() <= MAX_MISMATCH, bad_rays.mean()


RENDER_CASES = {
    "random_spb1": ("random", dict(width=32, height=32, spp=2, max_depth=4,
                                   samples_per_batch=1)),
    "random_spb2": ("random", dict(width=32, height=32, spp=2, max_depth=4,
                                   samples_per_batch=2)),
    "glossy_dof": ("glossy_dof", dict(width=16, height=16, spp=2,
                                      max_depth=6)),
}


def _configs(kw):
    common = dict(rng="hash", intersector="fused_interpret", pixel_chunk=512)
    return JConfig(**common, **kw), TConfig(**common, **kw)


@pytest.fixture(scope="module")
def jax_linear():
    """JAX renders, shared by the tests below (each costs seconds)."""
    cache = {}

    def get(case):
        if case not in cache:
            name, kw = RENDER_CASES[case]
            jcfg, _ = _configs(kw)
            (js, jc), _ = _both(name, jcfg.aspect_ratio)
            cache[case] = np.asarray(
                j_render_linear(js, jc, jcfg, jax.random.PRNGKey(SEED)))
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_linear_matches_jax(case, jax_linear):
    name, kw = RENDER_CASES[case]
    jcfg, tcfg = _configs(kw)
    _, (ts, tc) = _both(name, tcfg.aspect_ratio)
    got = t_render_linear(ts, tc, tcfg, SEED)
    assert got.shape == (tcfg.height, tcfg.width, 3)
    assert torch.isfinite(got).all()
    want = jax_linear(case) / jcfg.spp
    mismatch = _mismatch(got.numpy() / tcfg.spp, want)
    assert mismatch.mean() <= MAX_MISMATCH, mismatch.mean()


def test_render_uint8_matches_jax(jax_linear):
    name, kw = RENDER_CASES["random_spb1"]
    jcfg, tcfg = _configs(kw)
    (js, jc), (ts, tc) = _both(name, jcfg.aspect_ratio)
    jax_linear("random_spb1")       # warm the shared executable
    want = np.asarray(j_render(js, jc, jcfg, jax.random.PRNGKey(SEED)))
    got = t_render(ts, tc, tcfg, SEED)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    levels = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert (levels > 1).mean() <= MAX_MISMATCH, (levels > 1).mean()


def test_image_invariant_to_chunking_and_sample_batches():
    # Bitwise, as in the JAX package: per-ray RNG keyed on pixel and sample.
    _, (ts, tc) = _both("glossy_dof", 16 / 16)
    # One merged batch of all spp samples sums them in the same order as
    # the one-sample-at-a-time loop.
    base = dict(width=16, height=16, spp=2, max_depth=3, rng="hash")
    ref = t_render_linear(ts, tc, TConfig(pixel_chunk=-1, **base), SEED)
    for kw in (dict(pixel_chunk=96), dict(samples_per_batch=2),
               dict(pixel_chunk=100, samples_per_batch=2)):
        got = t_render_linear(ts, tc, TConfig(**base, **kw), SEED)
        assert torch.equal(got, ref), kw


def test_trace_flat_is_forward_only():
    # A forward trace of tensors that require grad runs; differentiating it
    # raises instead of returning silently zero gradients.
    _, (ts, _) = _both("three_sphere", 1.0)
    o = torch.zeros((4, 3), requires_grad=True)
    d = torch.ones((4, 3))
    out = t_trace_flat(ts, o, d, torch.zeros(4, dtype=torch.int64), 2)
    assert out.shape == (4, 3) and out.requires_grad
    with pytest.raises(ValueError, match="forward-only"):
        out.sum().backward()


# 16x12 = 192 pixels in chunks of 96: 2 chunks.
SHARED = dict(width=16, height=12, max_depth=2, rng="hash", pixel_chunk=96)


def _builds(fn):
    """(fn(), the kernel-table builds it made)."""
    before = spans.counts["table_builds"]
    out = fn()
    return out, spans.counts["table_builds"] - before


@pytest.mark.parametrize("spb", [1, 2])
@pytest.mark.parametrize("name", ["three_sphere", "terrain"])
def test_forward_render_builds_its_tables_once(name, spb, monkeypatch):
    cfg = TConfig(spp=2, samples_per_batch=spb, **SHARED)
    sc, cam = tscenes.get_scene(name, cfg.aspect_ratio, device="cpu")
    img, builds = _builds(lambda: t_render_linear(sc, cam, cfg, SEED))
    assert builds == 1
    # Each (chunk, batch) building its own tables gives the same bits.
    monkeypatch.setattr(t_render_mod, "shared_tables", lambda *a: None)
    own, builds = _builds(lambda: t_render_linear(sc, cam, cfg, SEED))
    assert builds == 2 * (cfg.spp // spb)
    assert torch.equal(img, own)


@pytest.mark.parametrize("name", ["three_sphere", "terrain"])
def test_forward_sample_batch_builds_its_tables_once(name):
    cfg = TConfig(spp=3, **SHARED)
    sc, cam = tscenes.get_scene(name, cfg.aspect_ratio, device="cpu")
    _, builds = _builds(
        lambda: t_render_sample_batch(sc, cam, cfg, SEED, 0, 3))
    assert builds == 1


def test_grad_render_builds_its_tables_in_every_batch():
    # Under autograd each (chunk, batch) rebuilds its differentiable table,
    # in the forward and again in the checkpoint's recompute.
    cfg = TConfig(spp=2, samples_per_batch=1, nee=True, **SHARED)
    sc, cam = tscenes.get_scene("three_sphere", cfg.aspect_ratio,
                                device="cpu")
    init, step, _, _ = t_inverse.make_train_step(
        sc, cam, cfg, t_inverse.adam(0.05), trainable=("albedo",))
    state = init()
    target = torch.zeros((cfg.height, cfg.width, 3))
    _, builds = _builds(lambda: step(state, target, 1))
    assert builds == 2 * 2 * 2


# (scene, cfg fields, table builds of a 2-chunk 2-spp forward render): the
# routes that build their own tables. The [N,3] integrator builds none of
# trace_flat's; edge-aware builds two a (chunk, batch), its two flat traces.
OWN_TABLES = {
    "pallas": ("three_sphere", dict(intersector="pallas"), 0),
    "xla": ("terrain", dict(intersector="xla"), 0),
    "fused_diff_world": ("terrain", dict(intersector="fused_diff"), 0),
    "edge_aware": ("three_sphere", dict(edge_aware=True), 2 * 2 * 2),
}


@pytest.mark.parametrize("case", sorted(OWN_TABLES))
def test_other_routes_build_their_own_tables(case):
    name, kw, want = OWN_TABLES[case]
    cfg = TConfig(spp=2, **SHARED, **kw)
    sc, cam = tscenes.get_scene(name, cfg.aspect_ratio, device="cpu")
    assert t_render_mod.shared_tables(sc, cfg) is None
    _, builds = _builds(lambda: t_render_linear(sc, cam, cfg, SEED))
    assert builds == want


@pytest.mark.parametrize("name", ["three_sphere", "terrain"])
def test_trace_with_tables_gives_the_bits_of_its_own_build(name):
    cfg = TConfig(spp=1, nee=True, **SHARED)
    sc, cam = tscenes.get_scene(name, cfg.aspect_ratio, device="cpu")
    i, j, pixel_index = t_render_mod.pixel_grid(cfg)
    keys = tsam.sample_keys(tsam.pixel_states(SEED, pixel_index, cfg.rng), 0)
    o, d = t_render_mod._camera_rays(cam, cfg, keys, i, j)
    if name == "terrain":
        kw = dict(nee=True, mesh_cluster_rows=2)
        trace = t_itg.trace_flat_world
        tables = t_itg.build_tables(sc, 2, "vpu")
        wrong = t_itg.build_tables(sc.spheres)
    else:
        kw = dict(nee=True)
        trace = t_itg.trace_flat
        tables = t_itg.build_tables(sc)
        wrong = tuple(tables)
    own, builds = _builds(lambda: trace(sc, o, d, keys, 3, **kw))
    assert builds == 1
    shared, builds = _builds(lambda: trace(sc, o, d, keys, 3, tables=tables,
                                           **kw))
    assert builds == 0
    assert torch.equal(own, shared)
    with pytest.raises(TypeError, match="tables"):
        trace(sc, o, d, keys, 1, tables=wrong, **kw)
