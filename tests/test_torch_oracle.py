"""The port's float64 oracles (qt_raytracer_tpu_torch.testing.oracle and
oracle_vec) against the JAX package's, and the port's renders against them.

- The scalar and the vector oracle equal the JAX package's bit for bit, as
  arrays of float64, on the golden scenes of tests/test_oracle_golden.py
  and tests/test_oracle_vec.py: they are the same numpy code on uniforms
  that the port's RNG draws bitwise equal to JAX's.
- The port's vector oracle equals its scalar one within rtol 1e-12 (numpy's
  small-vector reductions reassociate in f64).
- The port's default route (plain versions of its kernels on the CPU) and
  its xla route fall within the golden budgets against the port's oracle:
  at most the scene's fraction of channels beyond atol + rtol |ref| of
  tests/test_oracle_golden.py.

tests/test_torch_hollow_chunk.py holds the one known difference between
the oracle and a kernel the port keeps from the reference.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu.testing import oracle as joracle
from qt_raytracer_tpu.testing import oracle_vec as joracle_vec
from qt_raytracer_tpu_torch import RenderConfig as TConfig
from qt_raytracer_tpu_torch import render_linear
from qt_raytracer_tpu_torch.testing import oracle, oracle_vec
from qt_raytracer_tpu_torch.utils.convert import (camera_from_arrays,
                                                  key_from_words,
                                                  scene_from_arrays,
                                                  world_from_arrays)
from torch_helpers import _one_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's (ROADMAP.md).
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(name, aspect, **kw):
    """(JAX scene, JAX camera), (port scene, port camera)."""
    if name == "cornell_mesh":
        js = jmeshes.cornell_box_world(builder="numpy")
        jc = jmeshes.cornell_box_mesh_camera(aspect)
        ts = world_from_arrays(_arrays(js.spheres), _arrays(js.mesh),
                               device="cpu")
    elif name == "random_seed3":
        js = jscenes.random_scene(seed=3, pad_to=None)
        jc = jscenes.random_scene_camera(aspect)
        ts = scene_from_arrays(_arrays(js), device="cpu")
    else:
        js, jc = jscenes.get_scene(name, aspect, **kw)
        ts = scene_from_arrays(_arrays(js), device="cpu")
    return (js, jc), (ts, camera_from_arrays(_arrays(jc), device="cpu"))


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, key_from_words(np.asarray(jax.random.key_data(jk)))


def _bits(x):
    return np.ascontiguousarray(x, np.float64).view(np.int64)


# tests/test_oracle_golden.py: (scene, config, key, atol = rtol,
# max_mismatch) of each golden test against the scalar oracle.
GOLDEN = {
    "three_sphere": ("three_sphere", dict(width=16, height=12, spp=2,
                                          max_depth=4), 0, 2e-3, 0.01),
    "four_sphere_gpu": ("four_sphere_gpu", dict(width=16, height=12, spp=2,
                                                max_depth=4), 0, 2e-3, 0.0),
    "glossy_dof": ("glossy_dof", dict(width=16, height=12, spp=2,
                                      max_depth=6), 0, 4e-3, 0.01),
    "cornell": ("cornell", dict(width=12, height=12, spp=2, max_depth=5), 0,
                4e-3, 0.0),
    "cornell_nee": ("cornell", dict(width=12, height=12, spp=2, max_depth=5,
                                    nee=True), 0, 4e-3, 0.03),
    "random": ("random_seed3", dict(width=12, height=8, spp=1, max_depth=4),
               1, 4e-3, 0.01),
}

# tests/test_oracle_vec.py: (scene, config, key) of the vector oracle's
# cases.
VEC = {
    "three_sphere": ("three_sphere", dict(width=16, height=12, spp=2,
                                          max_depth=4), 1),
    "glossy_dof": ("glossy_dof", dict(width=16, height=12, spp=2,
                                      max_depth=4), 1),
    "random_rr": ("random", dict(width=16, height=12, spp=2, max_depth=4,
                                 rr_start=2), 1),
    "cornell_nee": ("cornell", dict(width=12, height=12, spp=2, max_depth=4,
                                    nee=True), 5),
    "cornell_mesh_nee": ("cornell_mesh", dict(width=12, height=12, spp=2,
                                              max_depth=4, nee=True), 5),
}


def _golden_kw(name):
    # The golden tests build their scenes unpadded.
    return {} if name in ("cornell_mesh", "random_seed3") \
        else dict(pad_to=None)


@pytest.fixture(scope="module")
def golden():
    """The port's scalar oracle image of every golden case, with its
    scene."""
    out = {}
    for case, (name, kw, seed, _, _) in GOLDEN.items():
        cfg = TConfig(**kw)
        both = _both(name, cfg.aspect_ratio, **_golden_kw(name))
        _, tk = _keys(seed)
        out[case] = (both, oracle.render_oracle_linear(*both[1], cfg, tk))
    return out


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_scalar_oracle_equals_jax_bitwise(golden, case):
    name, kw, seed, _, _ = GOLDEN[case]
    ((js, jc), _), got = golden[case]
    jk, _ = _keys(seed)
    want = joracle.render_oracle_linear(js, jc, JConfig(**kw), jk)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("case", sorted(VEC))
def test_vector_oracle_equals_jax_bitwise(case):
    name, kw, seed = VEC[case]
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    (js, jc), (ts, tc) = _both(name, jcfg.aspect_ratio)
    jk, tk = _keys(seed)
    got = oracle_vec.render_oracle_vec(ts, tc, tcfg, tk)
    want = joracle_vec.render_oracle_vec(js, jc, jcfg, jk)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(np.abs(got).max()) > 0


@pytest.mark.parametrize("case", sorted(VEC))
def test_vector_oracle_matches_scalar_oracle(case):
    name, kw, seed = VEC[case]
    cfg = TConfig(**kw)
    _, (ts, tc) = _both(name, cfg.aspect_ratio)
    _, tk = _keys(seed)
    a = oracle.render_oracle_linear(ts, tc, cfg, tk)
    b = oracle_vec.render_oracle_vec(ts, tc, cfg, tk)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("intersector", ["auto", "xla"])
@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_port_routes_match_oracle(golden, case, intersector):
    name, kw, seed, tol, max_mismatch = GOLDEN[case]
    cfg = TConfig(intersector=intersector, **kw)
    (_, (ts, tc)), want = golden[case]
    _, tk = _keys(seed)
    got = render_linear(ts, tc, cfg, tk).double().numpy() / cfg.spp
    want = want / cfg.spp
    mismatch = np.abs(got - want) > tol + tol * np.abs(want)
    assert mismatch.mean() <= max_mismatch, mismatch.mean()


@pytest.mark.parametrize("intersector", ["auto", "xla"])
def test_port_routes_match_vector_oracle(intersector):
    # The glass scene with Russian roulette and the true Cornell box with
    # NEE, against the vector oracle: glossy_dof's golden budget, and
    # tests/test_oracle_vec.py's per-pixel budget for the mesh world.
    kw = dict(width=16, height=12, spp=2, max_depth=6, rr_start=2)
    cfg = TConfig(intersector=intersector, **kw)
    _, (ts, tc) = _both("glossy_dof", cfg.aspect_ratio)
    got = render_linear(ts, tc, cfg, 3).double().numpy()
    want = oracle_vec.render_oracle_vec(ts, tc, cfg, 3)
    assert (np.abs(got - want) > 4e-3 + 4e-3 * np.abs(want)).mean() <= 0.01
    cfg = TConfig(intersector=intersector, width=32, height=32, spp=2,
                  max_depth=4, nee=True)
    _, (tw, tc) = _both("cornell_mesh", cfg.aspect_ratio)
    img = render_linear(tw, tc, cfg, 7).double().numpy()
    ref = oracle_vec.render_oracle_vec(tw, tc, cfg, 7)
    per = np.max(np.abs(img - ref), axis=-1) / (np.max(ref, axis=-1) + 1e-3)
    assert float((per > 2e-3).mean()) < 0.04
