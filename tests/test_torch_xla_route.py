"""The portable route, ``intersector="xla"``, of the port on the CPU against
the JAX package's own xla route: the [N, S] sphere search
(``core.intersect.intersect_spheres(backend="xla")``), the merged world hit
with the BVH walk (``core.world.intersect_world(backend="xla")``) and
renders through ``render_linear``; tests/test_torch_xla_step.py holds
a config-5 view-step the same way. JAX's xla route runs no Pallas kernel,
so nothing here goes through interpret mode.

Tolerances. Hits: hit flags equal on every lane, winner ids on 99.9% of
them; on lanes with the same winner t within rtol 1e-5 plus 32 ulps of the
error bound of the expanded-form roots (the rule of
tests/test_torch_sphere_search.py: XLA:CPU contracts multiply-adds that
PyTorch rounds one by one, and the discriminant amplifies that), every
other float field within 1e-4 + 1e-4 |ref|. Renders: the golden flip budget
of tests/test_oracle_golden.py, at most 1% of channels beyond 2e-3 +
2e-3 |ref|. (A glass scene is held against the f64 oracle instead,
tests/test_torch_oracle.py: there the port's routes and JAX's each differ
from the oracle by a few branch flips, on different pixels.)

Also here, the meaning of the mesh-search options on the [N,3] integrator:
under "xla" no ``mesh_kernel`` changes a bit (the mesh search is the walk,
as the JAX package switches mesh kernels only under Pallas), and under
"pallas" ``"hybrid"`` is the clustered search there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu import render_linear as j_render_linear
from qt_raytracer_tpu.core.intersect import intersect_spheres as j_isect
from qt_raytracer_tpu.core.world import intersect_world as j_isect_world
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch import RenderConfig as TConfig
from qt_raytracer_tpu_torch import render_linear as t_render_linear
from qt_raytracer_tpu_torch.core.integrator import trace
from qt_raytracer_tpu_torch.core.intersect import intersect_spheres
from qt_raytracer_tpu_torch.core.world import intersect_world
from qt_raytracer_tpu_torch.kernels import mesh_pairs
from qt_raytracer_tpu_torch.runtime import spans
from qt_raytracer_tpu_torch.utils.convert import (camera_from_arrays,
                                                  scene_from_arrays,
                                                  world_from_arrays)
from test_torch_sphere_search import _t_tol
from torch_helpers import _one_thread  # noqa: F401

T_MIN = 1e-3
ATOL = RTOL = 2e-3
MAX_MISMATCH = 0.01
SIZE = dict(width=16, height=12, spp=2, max_depth=4, rng="hash")


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


def _both(name, aspect):
    """(JAX scene, JAX camera), (port scene, port camera)."""
    if name == "cornell_mesh":
        js = jmeshes.cornell_box_world(builder="numpy")
        jc = jmeshes.cornell_box_mesh_camera(aspect)
        ts = world_from_arrays(_arrays(js.spheres), _arrays(js.mesh),
                               device="cpu")
    else:
        js, jc = jscenes.get_scene(name, aspect)
        ts = scene_from_arrays(_arrays(js), device="cpu")
    return (js, jc), (ts, camera_from_arrays(_arrays(jc), device="cpu"))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.05, 1.9, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) >= 0.1
    return o, d, alive


def _hits_np(h):
    return {k: np.asarray(v) if not isinstance(v, torch.Tensor)
            else v.detach().numpy() for k, v in h._asdict().items()}


def _assert_hits_match(got, want, o, d, centers, radii, lanes):
    np.testing.assert_array_equal(got["hit"], want["hit"])
    same = lanes & (got["prim_idx"] == want["prim_idx"])
    assert same.sum() >= 0.999 * lanes.sum()
    hit = same & want["hit"]
    assert 0.2 < hit[lanes].mean()
    for k in ("mat_type", "front_face"):
        np.testing.assert_array_equal(got[k][hit], want[k][hit])
    if centers is not None:
        k = want["prim_idx"][hit]
        tol = _t_tol(o[hit], d[hit], centers[k], radii[k], want["t"][hit])
        err = np.abs(got["t"][hit].astype(np.float64) - want["t"][hit])
        assert (err <= tol).all(), (err / tol).max()
    else:
        np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-4,
                                   atol=1e-4)
    for k in ("point", "normal", "albedo", "emission", "radius", "area"):
        np.testing.assert_allclose(got[k][hit], want[k][hit], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("excluded", [False, True])
@pytest.mark.parametrize("name", ["random", "cornell"])
def test_sphere_search_matches_jax(name, excluded):
    (js, _), (ts, _) = _both(name, 1.0)
    o, d, _ = _rays(2048, seed=len(name))
    s = ts.num_spheres
    excl = np.where(np.random.default_rng(3).random(2048) < 0.5,
                    np.random.default_rng(4).integers(0, s, 2048),
                    -1).astype(np.int32) if excluded else None
    want = j_isect(js, jnp.asarray(o), jnp.asarray(d), T_MIN, backend="xla",
                   exclude=None if excl is None else jnp.asarray(excl))
    got = intersect_spheres(ts, torch.from_numpy(o), torch.from_numpy(d),
                            T_MIN, backend="xla",
                            exclude=None if excl is None
                            else torch.from_numpy(excl))
    got, want = _hits_np(got), _hits_np(want)
    a = _arrays(js)
    _assert_hits_match(got, want, o, d, a["center"], a["radius"],
                       np.ones(2048, bool))
    if excluded:
        assert not np.any(got["hit"] & (got["prim_idx"] == excl))
        assert np.any(want["hit"] & (excl >= 0))


@pytest.mark.parametrize("excluded", [False, True])
def test_world_hit_matches_jax(excluded):
    (js, _), (ts, _) = _both("cornell_mesh", 1.0)
    o, d, alive = _rays(2048, seed=9)
    o[:, 2] = np.random.default_rng(1).uniform(0.5, 0.95, 2048)
    n_prims = ts.spheres.num_spheres + ts.mesh.num_triangles
    excl = np.where(np.random.default_rng(2).random(2048) < 0.5,
                    np.random.default_rng(5).integers(0, n_prims, 2048),
                    -1).astype(np.int32) if excluded else None
    want = j_isect_world(js, jnp.asarray(o), jnp.asarray(d), T_MIN,
                         backend="xla", alive=jnp.asarray(alive),
                         exclude=None if excl is None else jnp.asarray(excl))
    got = intersect_world(ts, torch.from_numpy(o), torch.from_numpy(d),
                          T_MIN, backend="xla", alive=torch.from_numpy(alive),
                          exclude=None if excl is None
                          else torch.from_numpy(excl))
    got, want = _hits_np(got), _hits_np(want)
    # Hit flags on every lane (the xla sphere search ignores alive, as in
    # JAX), the rest on live lanes.
    _assert_hits_match(got, want, o, d, None, None, alive)
    assert np.any(got["hit"] & (got["prim_idx"] >= ts.spheres.num_spheres))
    if excluded:
        assert not np.any(alive & got["hit"] & (got["prim_idx"] == excl))


RENDER_CASES = {
    "random": ("random", dict(SIZE, max_depth=4)),
    "cornell_mesh_nee": ("cornell_mesh", dict(SIZE, width=12, height=12,
                                              nee=True)),
    "three_sphere_rr": ("three_sphere", dict(SIZE, max_depth=6, rr_start=2)),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_matches_jax(case):
    name, kw = RENDER_CASES[case]
    jcfg = JConfig(intersector="xla", **kw)
    tcfg = TConfig(intersector="xla", **kw)
    (js, jc), (ts, tc) = _both(name, jcfg.aspect_ratio)
    want = np.asarray(j_render_linear(js, jc, jcfg, jax.random.PRNGKey(3)))
    before = spans.counts["bvh_walk"]
    got = t_render_linear(ts, tc, tcfg, 3)
    assert spans.counts["bvh_walk"] == before
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((want > 0).mean()) > 0.3
    mismatch = np.abs(got.numpy() - want) > ATOL + RTOL * np.abs(want)
    assert mismatch.mean() <= MAX_MISMATCH, mismatch.mean()


def _cornell_rays():
    (_, jc), (tw, tc) = _both("cornell_mesh", 1.0)
    from qt_raytracer_tpu_torch.core import camera as cam_mod
    rng = np.random.default_rng(12)
    s, t = (torch.from_numpy(rng.random(1024, dtype=np.float32))
            for _ in range(2))
    o, d = cam_mod.get_rays(tc, s, t, torch.zeros(1024), torch.zeros(1024))
    return tw, o, d


def test_mesh_options_change_nothing_under_xla():
    # C3: JAX's intersect_world switches mesh kernels only under Pallas, so
    # under "xla" every mesh-search option gives the walk's bits.
    tw, o, d = _cornell_rays()
    keys = torch.arange(1024, dtype=torch.int64)
    want = trace(tw, o, d, keys, 3, intersector="xla", nee=True)
    for opts in (dict(mesh_kernel="pairs"), dict(mesh_kernel="hybrid"),
                 dict(mesh_visit="rowgate", mesh_cluster_rows=1),
                 dict(mesh_sort_mode="morton", mesh_mt="mxu")):
        got = trace(tw, o, d, keys, 3, intersector="xla", nee=True, **opts)
        assert torch.equal(got, want), opts
        hits = intersect_world(tw, o, d, T_MIN, backend="xla", **opts)
        ref = intersect_world(tw, o, d, T_MIN, backend="xla")
        for k, v in hits._asdict().items():
            assert torch.equal(v, getattr(ref, k)), (opts, k)


def test_hybrid_is_the_clustered_search_on_the_integrator(monkeypatch):
    # C3: under "pallas" the [N,3] integrator passes no bounce index, so
    # "hybrid" takes the clustered search at every bounce, as JAX's
    # intersect_world does for anything but "pairs".
    tw, o, d = _cornell_rays()
    keys = torch.arange(1024, dtype=torch.int64)
    want = trace(tw, o, d, keys, 3, intersector="pallas", nee=True,
                 mesh_kernel="clustered")

    def no_pairs(*args, **kwargs):
        raise AssertionError("the pair search ran under 'hybrid'")

    monkeypatch.setattr(mesh_pairs, "mesh_search_pairs", no_pairs)
    got = trace(tw, o, d, keys, 3, intersector="pallas", nee=True,
                mesh_kernel="hybrid")
    assert torch.equal(got, want)
    with pytest.raises(AssertionError, match="pair search"):
        trace(tw, o, d, keys, 3, intersector="pallas", nee=True,
              mesh_kernel="pairs")
