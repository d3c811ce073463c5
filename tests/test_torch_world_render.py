"""The port's mesh-world render path (trace_flat_world, render_linear on a
World) on the CPU, through the plain versions of kernels A1-A4, against the
JAX package with its Pallas kernels in interpret mode: the true Cornell box
with next-event estimation, and the icosphere world without.

Budget, as in tests/test_torch_render.py: f32 paths that graze an edge or a
sphere, or sit on a discrete branch (a shadow test, the Schlick choice, the
Moller-Trumbore accept test), can flip on an ulp, and the two packages round
some multiply-adds differently, so at most 1% of rays (or channels of
per-sample means) may differ by more than 2e-3 + 2e-3 |ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu import render_linear as j_render_linear
from qt_raytracer_tpu.core import camera as jcam
from qt_raytracer_tpu.core import sampling as jsam
from qt_raytracer_tpu.core.integrator_flat import trace_flat_world as j_trace_world
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu_torch import RenderConfig as TConfig
from qt_raytracer_tpu_torch import render_linear as t_render_linear
from qt_raytracer_tpu_torch.core.integrator_flat import trace_flat_world as t_trace_world
from qt_raytracer_tpu_torch.runtime import spans
from qt_raytracer_tpu_torch.utils.convert import camera_from_arrays, world_from_arrays
from torch_helpers import _one_thread  # noqa: F401

ATOL = RTOL = 2e-3
MAX_MISMATCH = 0.01
SEED = 3

WORLDS = {
    "cornell_mesh": (lambda: jmeshes.cornell_box_world(builder="numpy"),
                     jmeshes.cornell_box_mesh_camera),
    "icosphere": (lambda: jmeshes.icosphere_world(builder="numpy"),
                  jmeshes.icosphere_camera),
}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py: one process
    # that holds too many XLA:CPU executables aborts.
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(name, aspect):
    build, camera = WORLDS[name]
    jw, jc = build(), camera(aspect)
    tw = world_from_arrays(_arrays(jw.spheres), _arrays(jw.mesh), device="cpu")
    return (jw, jc), (tw, camera_from_arrays(_arrays(jc), device="cpu"))


def _mismatch(got, want):
    return np.abs(got - want) > ATOL + RTOL * np.abs(want)


def _camera_rays(jc, n, width, height):
    """n camera rays at random pixels, with their hash sample states."""
    rng = np.random.default_rng(9)
    pix = rng.integers(0, width * height, n).astype(np.uint32)
    keys = jsam.sample_keys(
        jsam.hash_pixel_states(jax.random.PRNGKey(SEED), jnp.asarray(pix)), 0)
    gen = np.asarray(jsam.stream_uniforms(keys, jsam.STREAM_GEN, 4))
    s = ((pix % width) + gen[:, 0]) / (width - 1.0)
    t = ((height - 1 - pix // width) + gen[:, 1]) / (height - 1.0)
    o, d = jcam.get_rays(jc, jnp.asarray(s, jnp.float32),
                         jnp.asarray(t, jnp.float32), jnp.asarray(gen[:, 2]),
                         jnp.asarray(gen[:, 3]))
    return np.asarray(o), np.asarray(d), np.asarray(keys)


# (world, rays, depth, nee, rr_start): 2,048 icosphere rays run the A4 sort
# (3 clusters); the Cornell box is one cluster and never sorts.
TRACE_CASES = {
    "cornell_mesh_nee": ("cornell_mesh", 1024, 4, True, 2),
    "icosphere": ("icosphere", 2048, 3, False, 0),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_flat_world_matches_jax(case):
    name, n, depth, nee, rr_start = TRACE_CASES[case]
    (jw, jc), (tw, _) = _both(name, 1.0)
    o, d, keys = _camera_rays(jc, n, 64, 64)
    want = np.asarray(j_trace_world(jw, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(keys), depth, 1e-3, nee=nee,
                                    rr_start=rr_start, interpret=True))
    spans.counts.clear()
    got = t_trace_world(tw, torch.tensor(o), torch.tensor(d),
                        torch.tensor(keys.astype(np.int64)), depth, 1e-3,
                        nee=nee, rr_start=rr_start)
    # On the CPU the wrappers take the plain versions and count nothing.
    assert tuple(spans.counts[k] for k in (
        "fused_hit", "fused_hit_shadow", "mesh_search",
        "mesh_first_cluster")) == (0, 0, 0, 0)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert float((want > 0).mean()) > 0.3          # the rays do carry light
    bad_rays = _mismatch(got.numpy(), want).any(axis=1)
    assert bad_rays.mean() <= MAX_MISMATCH, bad_rays.mean()


def test_nee_changes_the_world_estimate():
    # Same expectation, other samples: NEE must reach the radiance.
    _, (tw, tc) = _both("cornell_mesh", 1.0)
    cfg = TConfig(width=12, height=12, spp=1, max_depth=3, rng="hash")
    a = t_render_linear(tw, tc, cfg, SEED)
    b = t_render_linear(tw, tc, dataclasses.replace(cfg, nee=True), SEED)
    assert not torch.equal(a, b)
    assert bool(torch.isfinite(b).all())


@pytest.mark.parametrize("nee", [False, True])
def test_render_linear_on_a_world_matches_jax(nee):
    kw = dict(width=24, height=24, spp=1, max_depth=3, nee=nee, rng="hash",
              intersector="fused_interpret", pixel_chunk=512)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    (jw, jc), (tw, tc) = _both("cornell_mesh", jcfg.aspect_ratio)
    want = np.asarray(j_render_linear(jw, jc, jcfg, jax.random.PRNGKey(SEED)))
    got = t_render_linear(tw, tc, tcfg, SEED)
    assert got.shape == (24, 24, 3) and bool(torch.isfinite(got).all())
    mismatch = _mismatch(got.numpy(), want)
    assert mismatch.mean() <= MAX_MISMATCH, mismatch.mean()


def test_world_without_mesh_renders_its_spheres():
    _, (tw, tc) = _both("cornell_mesh", 1.0)
    bare = dataclasses.replace(tw, mesh=None)
    cfg = TConfig(width=8, height=8, spp=1, max_depth=2, rng="hash")
    assert torch.equal(t_render_linear(bare, tc, cfg, SEED),
                       t_render_linear(tw.spheres, tc, cfg, SEED))


def test_trace_flat_world_is_forward_only():
    _, (tw, _) = _both("cornell_mesh", 1.0)
    o = torch.zeros((4, 3), requires_grad=True)
    d = torch.ones((4, 3))
    keys = torch.zeros(4, dtype=torch.int64)
    # A forward trace of tensors that require grad runs; differentiating it
    # raises instead of returning silently zero gradients.
    with pytest.raises(ValueError, match="forward-only"):
        t_trace_world(tw, o, d, keys, 2).sum().backward()
    grad_mesh = dataclasses.replace(
        tw, mesh=dataclasses.replace(tw.mesh,
                                     v0=tw.mesh.v0.clone().requires_grad_()))
    out = t_trace_world(grad_mesh, o.detach(), d, keys, 2)
    assert out.requires_grad and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="forward-only"):
        out.sum().backward()
    # The compacted trace is forward-only too, and the same radiance.
    packed = t_trace_world(grad_mesh, o.detach(), d, keys, 2, compact=True)
    assert torch.equal(packed, out)
    with pytest.raises(ValueError, match="forward-only"):
        packed.sum().backward()
    with pytest.raises(TypeError):
        t_trace_world(tw.spheres, o.detach(), d, keys, 2)
