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
from qt_raytracer_tpu_torch.core.integrator_flat import trace_flat as t_trace_flat
from qt_raytracer_tpu_torch.utils.convert import camera_from_arrays, scene_from_arrays

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
    return (js, jc), (scene_from_arrays(_arrays(js)),
                      camera_from_arrays(_arrays(jc)))


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
    got = t_trace_flat(scene_from_arrays(_arrays(js)), torch.tensor(o),
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
    _, (ts, _) = _both("three_sphere", 1.0)
    o = torch.zeros((4, 3), requires_grad=True)
    d = torch.ones((4, 3))
    with pytest.raises(ValueError, match="forward-only"):
        t_trace_flat(ts, o, d, torch.zeros(4, dtype=torch.int64), 2)
