"""The port's BVH build checks and the escape-index walk
(qt_raytracer_tpu_torch.accel.traverse, the plain version of the walk
kernel on CPU tensors) against brute force, against the JAX package's
``intersect_mesh`` and against the port's clustered search (kernel A3's
plain version); the cases of tests/test_bvh_mesh.py, ported.

Against JAX: on the icosphere, the true Cornell box and a 48x48 crop of the
terrain, 4,096 rays with dead lanes, an excluded triangle on a tenth of
the lanes and a finite t_max. Hit flags agree on every lane. Winner ids are
equal but within the tie window: where they differ, the two winners' t
must agree by the rule of tests/test_torch_mesh_kernel.py (rtol 1e-5 plus
32 ulps times the condition number of t = (q . e2) / det), since XLA:CPU
contracts some of Moller-Trumbore's multiply-adds where the port rounds
each op. On lanes with the same winner t agrees by the same rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.accel import mesh as jmesh
from qt_raytracer_tpu.accel import traverse as jtrav
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu_torch.accel.bvh import build_bvh, validate_bvh
from qt_raytracer_tpu_torch.accel.mesh import build_mesh, moller_trumbore
from qt_raytracer_tpu_torch.accel.traverse import (BIG, intersect_mesh,
                                                   intersect_mesh_brute)
from qt_raytracer_tpu_torch.kernels import bvh_walk as bw
from qt_raytracer_tpu_torch.kernels import mesh_intersect as tmi
from qt_raytracer_tpu_torch.runtime import spans
from qt_raytracer_tpu_torch.utils.convert import mesh_from_arrays
from torch_helpers import _one_thread  # noqa: F401

N = 4096
T_MIN = 1e-3
T_MAX = 6.0
EPS32 = 2.0 ** -24


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


def _random_tris(f, seed=0, spread=5.0):
    rng = np.random.default_rng(seed)
    tri = rng.uniform(-spread, spread, (f, 1, 3)) \
        + rng.uniform(-0.4, 0.4, (f, 3, 3))
    return tri.reshape(-1, 3), np.arange(3 * f).reshape(f, 3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


# ---------------------------------------------- tests/test_bvh_mesh.py cases
def test_bvh_build_invariants():
    rng = np.random.default_rng(1)
    lo = rng.uniform(-10, 10, (257, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 2.0, (257, 3)).astype(np.float32)
    bvh = build_bvh(lo, hi, max_leaf=4)
    validate_bvh(bvh, lo, hi)
    np.testing.assert_allclose(bvh.bbox_min[0], lo.min(0), atol=1e-6)
    np.testing.assert_allclose(bvh.bbox_max[0], hi.max(0), atol=1e-6)
    assert bvh.prim_count.max() <= 4


def test_validate_bvh_catches_a_broken_tree():
    rng = np.random.default_rng(2)
    lo = rng.uniform(-10, 10, (40, 3)).astype(np.float32)
    hi = lo + 1.0
    bvh = build_bvh(lo, hi)
    escape = bvh.escape.copy()
    escape[1] = 0                         # points backwards
    with pytest.raises(AssertionError):
        validate_bvh(bvh._replace(escape=escape), lo, hi)
    shrunk = bvh.bbox_max.copy()
    shrunk[np.nonzero(bvh.prim_count)[0][0]] -= 0.5
    with pytest.raises(AssertionError):
        validate_bvh(bvh._replace(bbox_max=shrunk), lo, hi)


def test_bvh_empty_raises():
    with pytest.raises(ValueError):
        build_bvh(np.zeros((0, 3)), np.zeros((0, 3)))


def test_bvh_single_primitive():
    lo = np.array([[0.0, 0.0, 0.0]], np.float32)
    hi = np.array([[1.0, 1.0, 1.0]], np.float32)
    validate_bvh(build_bvh(lo, hi), lo, hi)


def test_traversal_matches_brute_force():
    mesh = build_mesh(*_random_tris(300, seed=2), builder="numpy",
                      device="cpu")
    rng = np.random.default_rng(3)
    o, d = _t(rng.uniform(-8, 8, (512, 3))), _t(rng.normal(size=(512, 3)))
    hb = intersect_mesh_brute(mesh, o, d, T_MIN)
    ht = intersect_mesh(mesh, o, d, T_MIN)
    assert torch.equal(hb.hit, ht.hit) and 0.05 < float(hb.hit.float().mean())
    np.testing.assert_allclose(ht.t[hb.hit].numpy(), hb.t[hb.hit].numpy(),
                               rtol=1e-5, atol=1e-6)
    # ids differ only at an exact tie (coplanar shared edges)
    same = (ht.tri_idx == hb.tri_idx)[hb.hit]
    assert float(same.float().mean()) > 0.99


def test_traversal_nearest_of_two():
    verts = np.array([[-1, -1, -2], [1, -1, -2], [0, 1, -2],
                      [-1, -1, -5], [1, -1, -5], [0, 1, -5]], np.float64)
    mesh = build_mesh(verts, np.array([[0, 1, 2], [3, 4, 5]]),
                      builder="numpy", device="cpu")
    h = intersect_mesh(mesh, torch.zeros(1, 3),
                       torch.tensor([[0.0, 0.0, -1.0]]), T_MIN)
    assert bool(h.hit[0]) and abs(float(h.t[0]) - 2.0) < 1e-6
    # the nearer triangle left out: the farther one wins
    h = intersect_mesh(mesh, torch.zeros(1, 3),
                       torch.tensor([[0.0, 0.0, -1.0]]), T_MIN,
                       exclude=h.tri_idx)
    assert bool(h.hit[0]) and abs(float(h.t[0]) - 5.0) < 1e-6
    # a cap below both: a miss; at the near hit (inclusive): the hit
    zeros, down = torch.zeros(1, 3), torch.tensor([[0.0, 0.0, -1.0]])
    assert not bool(intersect_mesh(mesh, zeros, down, T_MIN, 1.5).hit[0])
    assert bool(intersect_mesh(mesh, zeros, down, T_MIN, 2.0).hit[0])


def test_traversal_miss():
    mesh = build_mesh(*_random_tris(50, seed=4), builder="numpy",
                      device="cpu")
    h = intersect_mesh(mesh, torch.tensor([[100.0, 100.0, 100.0]]),
                       torch.tensor([[0.0, 1.0, 0.0]]), T_MIN)
    assert not bool(h.hit[0])
    assert float(h.t[0]) == BIG and int(h.tri_idx[0]) == 0


def test_alive_mask_forces_miss():
    verts, faces = _random_tris(50, seed=5)
    mesh = build_mesh(verts, faces, builder="numpy", device="cpu")
    rng = np.random.default_rng(6)
    o = rng.uniform(-6, 6, (64, 3))
    # aimed at triangle centroids, so the live lanes hit
    aim = verts[faces[rng.integers(0, 50, 64)]].mean(axis=1)
    o, d = _t(o), _t(aim - o)
    alive = torch.arange(64) % 2 == 0
    h = intersect_mesh(mesh, o, d, T_MIN, alive=alive)
    assert not bool(h.hit[1::2].any()) and bool(h.hit[0::2].any())
    assert bool((h.t[1::2] == BIG).all() and (h.tri_idx[1::2] == 0).all())
    full = intersect_mesh(mesh, o, d, T_MIN)
    assert torch.equal(h.t[0::2], full.t[0::2])


# ------------------------------------------------------------ against JAX
def _jax_world(name):
    if name == "icosphere":
        return jmeshes.icosphere_world(2, builder="numpy")
    if name == "cornell":
        return jmeshes.cornell_box_world(builder="numpy")
    return jmeshes.terrain_world(48, 48, builder="numpy")


@pytest.fixture(scope="module", params=["icosphere", "cornell", "terrain48"])
def case(request):
    jm = _jax_world(request.param).mesh
    tm = mesh_from_arrays(_arrays(jm), device="cpu")
    rng = np.random.default_rng(11)
    lo, hi = np.asarray(jm.bvh_min[0]), np.asarray(jm.bvh_max[0])
    o = rng.uniform(lo - 0.5, hi + 0.5, (N, 3)).astype(np.float32)
    if request.param == "terrain48":
        o[:, 1] += 1.5                          # above the height field
    d = rng.normal(size=(N, 3)).astype(np.float32)
    alive = rng.random(N) < 0.8
    excl = np.where(rng.random(N) < 0.1,
                    rng.integers(0, tm.num_triangles, N), -1).astype(np.int32)
    return dict(name=request.param, jm=jm, tm=tm, o=o, d=d, alive=alive,
                excl=excl)


def _cond_rtol(tm, o, d, tri):
    """Per-lane rtol of t: 1e-5 + 32 ulps x the condition number of
    t = (q . e2) / det, in float64 (tests/test_torch_mesh_kernel.py)."""
    v0, e1, e2 = (getattr(tm, k).numpy().astype(np.float64)[tri]
                  for k in ("v0", "e1", "e2"))
    o, d = o.astype(np.float64), d.astype(np.float64)
    pv = np.cross(d, e2)
    qv = np.cross(o - v0, e1)
    det_terms, t_terms = pv * e1, qv * e2
    cond = (np.abs(det_terms).sum(1) / np.abs(det_terms.sum(1))
            + np.abs(t_terms).sum(1) / np.abs(t_terms.sum(1)))
    return 1e-5 + 32 * EPS32 * cond


@pytest.mark.parametrize("opts", ["plain", "alive_exclude_tmax"])
def test_walk_matches_jax(case, opts):
    full = opts != "plain"
    o, d = case["o"], case["d"]
    alive = case["alive"] if full else np.ones(N, bool)
    t_max = T_MAX if full else BIG
    jkw = dict(alive=jnp.asarray(alive), exclude=jnp.asarray(case["excl"])) \
        if full else {}
    tkw = dict(alive=torch.from_numpy(alive),
               exclude=torch.from_numpy(case["excl"])) if full else {}
    want = jtrav.intersect_mesh(case["jm"], jnp.asarray(o), jnp.asarray(d),
                                T_MIN, t_max=np.float32(t_max), **jkw)
    before = spans.counts["bvh_walk"]
    got = intersect_mesh(case["tm"], _t(o), _t(d), T_MIN, t_max, **tkw)
    assert spans.counts["bvh_walk"] == before   # CPU tensors: the plain walk
    assert got.t.dtype == torch.float32 and got.tri_idx.dtype == torch.int32
    wt, wi, wh = (np.asarray(x) for x in want)
    gt, gi, gh = got.t.numpy(), got.tri_idx.numpy(), got.hit.numpy()
    np.testing.assert_array_equal(gh, wh)
    assert 0.02 < wh[alive].mean() < 0.95, wh[alive].mean()
    assert not gh[~alive].any() and (gi[~alive] == 0).all()
    hit = wh & alive
    # Ties: where the ids differ, the two winners' t agree.
    for mine in (gi, wi):
        tol = _cond_rtol(case["tm"], o[hit], d[hit], mine[hit])
        np.testing.assert_array_less(
            np.abs(gt[hit].astype(np.float64) - wt[hit]),
            tol * np.abs(wt[hit]) + 1e-30)
    assert (gi == wi)[hit].mean() > 0.99
    if full:
        assert (gt[hit] <= t_max).all()
        ex = case["excl"]
        assert not np.any(hit & (gi == ex))
        assert np.any(alive & (ex >= 0))


def test_moller_trumbore_and_brute_force_match_jax(case):
    o, d = case["o"][:512], case["d"][:512]
    jm, tm = case["jm"], case["tm"]
    want = np.asarray(jmesh.moller_trumbore(jm.v0, jm.e1, jm.e2,
                                            jnp.asarray(o), jnp.asarray(d),
                                            T_MIN, T_MAX))
    got = moller_trumbore(tm.v0, tm.e1, tm.e2, _t(o), _t(d), T_MIN,
                          T_MAX).numpy()
    np.testing.assert_array_equal(got < BIG, want < BIG)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    wb = jtrav.intersect_mesh_brute(jm, jnp.asarray(o), jnp.asarray(d), T_MIN)
    gb = intersect_mesh_brute(tm, _t(o), _t(d), T_MIN)
    np.testing.assert_array_equal(gb.hit.numpy(), np.asarray(wb.hit))
    hit = np.asarray(wb.hit)
    assert (gb.tri_idx.numpy() == np.asarray(wb.tri_idx))[hit].mean() > 0.99
    np.testing.assert_allclose(gb.t.numpy()[hit], np.asarray(wb.t)[hit],
                               rtol=1e-4)


def test_walk_agrees_with_clustered_search(case):
    # As tests/test_mesh_kernel.py holds the JAX package's clustered kernel
    # to its walk: hit flags and winners agree on 99.9% of lanes.
    o, d = case["o"], case["d"]
    th = intersect_mesh(case["tm"], _t(o), _t(d), T_MIN)
    mc = tmi.prep_mesh_clusters(case["tm"])
    t, idx = tmi.mesh_search(mc, *(_t(x[:, a]) for x in (o, d)
                                   for a in range(3)), T_MIN)
    h = t < BIG
    assert float((h == th.hit).float().mean()) > 0.999
    both = h & th.hit
    assert float((idx == th.tri_idx)[both].float().mean()) > 0.999
    same = both & (idx == th.tri_idx)
    np.testing.assert_allclose(t[same].numpy(), th.t[same].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_walk_counts_its_work(case):
    o, d = _t(case["o"]), _t(case["d"])
    alive = torch.from_numpy(case["alive"])
    t, idx, boxes, tris = bw.bvh_walk_plain(case["tm"], o, d, T_MIN,
                                            alive=alive, count=True)
    plain = bw.bvh_walk_plain(case["tm"], o, d, T_MIN, alive=alive)
    assert torch.equal(t, plain[0]) and torch.equal(idx, plain[1])
    live = int(alive.sum())
    # Every live ray tests the root; no leaf holds more than 4 triangles.
    assert live <= boxes <= live * case["tm"].bvh_escape.shape[0]
    assert 0 < tris <= 4 * boxes


def test_leaves_larger_than_max_leaf_raise():
    verts, faces = _random_tris(200, seed=7)
    big_leaves = build_mesh(verts, faces, max_leaf=8, builder="numpy",
                            device="cpu")
    assert bw.largest_leaf(big_leaves) > 4
    o, d = torch.zeros(4, 3), torch.ones(4, 3)
    with pytest.raises(ValueError, match="leaf"):
        intersect_mesh(big_leaves, o, d, T_MIN)
    # walked with leaves that large, it runs and equals brute force
    h = intersect_mesh(big_leaves, o, d, T_MIN, max_leaf=8)
    assert torch.equal(h.hit, intersect_mesh_brute(big_leaves, o, d,
                                                   T_MIN).hit)


def test_walk_wrapper_refuses_bad_operands():
    mesh = build_mesh(*_random_tris(20, seed=8), builder="numpy",
                      device="cpu")
    o, d = torch.zeros(4, 3), torch.ones(4, 3)
    with pytest.raises(ValueError, match="float32"):
        bw.bvh_walk(mesh, o.double(), d, T_MIN)
    with pytest.raises(ValueError, match="alive"):
        bw.bvh_walk(mesh, o, d, T_MIN, alive=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="exclude"):
        bw.bvh_walk(mesh, o, d, T_MIN, exclude=torch.zeros(4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        bw.bvh_walk(mesh.to("meta"), o.to("meta"), d.to("meta"), T_MIN)


@pytest.mark.parametrize("field, bad", [
    ("bvh_escape", lambda x: x.long()),
    ("bvh_count", lambda x: x.long()),
    ("v0", lambda x: x.double()),
    ("bvh_min", lambda x: x[:-1]),
    ("e2", lambda x: x[:, :2]),
])
def test_walk_wrapper_refuses_bad_mesh_tables(field, bad):
    """The kernel reads the index tables as int32 and the geometry as f32
    [M, 3] / [T, 3]: any other table is refused, never reinterpreted."""
    mesh = build_mesh(*_random_tris(20, seed=8), builder="numpy",
                      device="cpu")
    mesh = dataclasses.replace(mesh, **{field: bad(getattr(mesh, field))})
    o, d = torch.zeros(4, 3), torch.ones(4, 3)
    with pytest.raises(ValueError, match=f"mesh.{field} must be"):
        bw.bvh_walk(mesh, o, d, T_MIN)


def test_kernel_route_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a machine without CUDA")
    mesh = build_mesh(*_random_tris(20, seed=9), builder="numpy",
                      device="cpu")
    o, d = torch.zeros(4, 3), torch.ones(4, 3)
    before = spans.counts["bvh_walk"]
    with pytest.raises(RuntimeError, match="nvcc"):
        bw._launch(mesh, o, d, torch.ones(4, dtype=torch.bool), None, T_MIN,
                   BIG, 4)
    assert spans.counts["bvh_walk"] == before
