"""Plain versions of the mesh kernels (qt_raytracer_tpu_torch.kernels.
mesh_intersect: A4 first_crossed_cluster, A3 mesh_search) against the JAX
package's Pallas kernels in interpret mode, on 4,096 rays with 60% alive,
with and without a per-lane cap, on terrain_world(48, 48) (4,418 triangles,
9 clusters) and on the true Cornell box (36 triangles, 1 cluster).

Tolerances. A4 compares slab entries and exits only, so it is bitwise.
A3's winner ids agree on at least 99.9% of live lanes; on lanes with the
same winner t agrees within rtol 1e-5 widened by 32 ulps times the
condition number of t = (qv . e2) / det (the sums of the magnitudes of the
terms of numerator and determinant over their values): XLA:CPU contracts
some of Moller-Trumbore's multiply-adds into FMAs where the port rounds
each op, and a grazing ray (small det) amplifies that ulp. The Cornell rays
start in front of the boxes: a box's bottom face lies in the floor's plane,
so a ray from below the floor, or from inside a box, meets two coplanar
triangles at the same t, and which one wins is decided by that ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.kernels import mesh_intersect as jmi
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu_torch.kernels import mesh_intersect as tmi
from qt_raytracer_tpu_torch.utils.convert import mesh_from_arrays
from torch_helpers import _one_thread  # noqa: F401

N = 4096
T_MIN = 1e-3
EPS32 = 2.0 ** -24
BIG = tmi.BIG


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py: one process
    # that holds too many XLA:CPU executables aborts.
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _rays(name, lo, hi, rng):
    if name == "terrain48":
        o = rng.uniform(lo - 0.5, hi + 0.5, (N, 3)).astype(np.float32)
        o[:, 1] += 1.5                       # above the height field
    else:                                    # in front of both boxes
        o = np.stack([rng.uniform(-0.95, 0.95, N), rng.uniform(0.05, 1.95, N),
                      rng.uniform(0.8, 3.0, N)], 1).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    if name == "cornell":
        d[:, 2] = -np.abs(d[:, 2])           # into the box
    return o, d


@pytest.fixture(scope="module", params=["terrain48", "cornell"])
def case(request):
    name = request.param
    jw = (jmeshes.terrain_world(48, 48, builder="numpy") if name == "terrain48"
          else jmeshes.cornell_box_world(builder="numpy"))
    jm = jw.mesh
    rng = np.random.default_rng(7)
    o, d = _rays(name, np.asarray(jm.bvh_min[0]), np.asarray(jm.bvh_max[0]),
                 rng)
    alive = rng.random(N) < 0.6
    # Half the lanes capped somewhere along the ray, the rest at BIG.
    cap = np.where(rng.random(N) < 0.5, rng.uniform(0.3, 3.0, N),
                   BIG).astype(np.float32)
    mc = tmi.prep_mesh_clusters(mesh_from_arrays(_arrays(jm), device="cpu"))
    comps = [np.ascontiguousarray(x[:, a]) for x in (o, d) for a in range(3)]
    return dict(name=name, jm=jm, mc=mc, o=o, d=d, alive=alive, cap=cap,
                j_rays=(tuple(map(jnp.asarray, comps[:3])),
                        tuple(map(jnp.asarray, comps[3:]))),
                t_rays=[torch.from_numpy(c) for c in comps])


def _cap(case, capped):
    return (jnp.asarray(case["cap"]) if capped else None,
            torch.from_numpy(case["cap"]) if capped else None)


@pytest.mark.parametrize("capped", [False, True])
def test_first_crossed_cluster_bitwise(case, capped):
    j_cap, t_cap = _cap(case, capped)
    want = np.asarray(jmi.first_crossed_cluster(
        case["jm"], *case["j_rays"], T_MIN, alive=jnp.asarray(case["alive"]),
        t_cap=j_cap, interpret=True))
    got = tmi.first_crossed_cluster(case["mc"], *case["t_rays"], T_MIN,
                                    torch.from_numpy(case["alive"]), t_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    live = case["alive"]
    assert (want[live] < case["mc"].k).mean() > 0.3   # the gate does pass
    assert np.all(got.numpy()[~live] == case["mc"].k)


def _mt_rtol(case, lanes, tri):
    """Per-lane rtol of t: 1e-5 + 32 ulps x the condition number of
    t = (qv . e2) / det, in float64."""
    tp = case["mc"].tri_planes.numpy().astype(np.float64)
    v0, e1, e2 = tp[0:3, tri].T, tp[3:6, tri].T, tp[6:9, tri].T
    o = case["o"][lanes].astype(np.float64)
    d = case["d"][lanes].astype(np.float64)
    pv = np.cross(d, e2)
    s = o - v0
    qv = np.cross(s, e1)
    det_terms, t_terms = pv * e1, qv * e2
    cond = (np.abs(det_terms).sum(1) / np.abs(det_terms.sum(1))
            + np.abs(t_terms).sum(1) / np.abs(t_terms.sum(1)))
    return 1e-5 + 32 * EPS32 * cond


@pytest.mark.parametrize("sort,capped", [(False, False), (True, True)])
def test_mesh_search_matches_jax(case, sort, capped):
    j_cap, t_cap = _cap(case, capped)
    alive = case["alive"]
    tj, ij = jmi.mesh_search_pallas(
        case["jm"], *case["j_rays"], T_MIN, interpret=True,
        alive=jnp.asarray(alive), t_cap=j_cap, sort=sort)
    tj, ij = np.asarray(tj), np.asarray(ij)
    tt, it = tmi.mesh_search(case["mc"], *case["t_rays"], T_MIN,
                             alive=torch.from_numpy(alive), t_cap=t_cap,
                             sort=sort)
    tt, it = tt.numpy(), it.numpy()
    agree = (it == ij)[alive]
    assert agree.mean() >= 0.999, agree.mean()
    hit = alive & (tj < BIG)
    assert 0.2 < hit[alive].mean() < 0.9    # hits and misses both occur
    if capped:                              # the cap prunes some lanes
        assert np.any(alive & (tj >= BIG) & (case["cap"] < BIG))
    same = hit & (it == ij)
    np.testing.assert_array_equal(tt[alive & (tj >= BIG)],
                                  tj[alive & (tj >= BIG)])
    lanes = np.nonzero(same)[0]
    rtol = _mt_rtol(case, lanes, ij[lanes])
    err = np.abs(tt[lanes].astype(np.float64) - tj[lanes])
    assert np.all(err <= rtol * np.abs(tj[lanes])), \
        np.max(err / (rtol * np.abs(tj[lanes])))
    # Dead lanes: BIG and 0 (the JAX kernel leaves them unspecified).
    assert np.all(tt[~alive] == np.float32(BIG)) and np.all(it[~alive] == 0)


@pytest.mark.parametrize("capped", [False, True])
def test_sorted_and_unsorted_bitwise_on_live_lanes(case, capped):
    _, t_cap = _cap(case, capped)
    alive = torch.from_numpy(case["alive"])
    a = tmi.mesh_search(case["mc"], *case["t_rays"], T_MIN, alive=alive,
                        t_cap=t_cap, sort=False)
    b = tmi.mesh_search(case["mc"], *case["t_rays"], T_MIN, alive=alive,
                        t_cap=t_cap, sort=True)
    for x, y in zip(a, b):
        assert torch.equal(x[alive], y[alive])


def test_all_dead_gives_big_and_zero(case):
    dead = torch.zeros(N, dtype=torch.bool)
    t, i = tmi.mesh_search(case["mc"], *case["t_rays"], T_MIN, alive=dead)
    assert torch.all(t == BIG) and torch.all(i == 0)
    c1 = tmi.first_crossed_cluster(case["mc"], *case["t_rays"], T_MIN, dead)
    assert torch.all(c1 == case["mc"].k)


def test_plain_blocks_do_not_change_results(case):
    alive = torch.from_numpy(case["alive"])
    t_cap = torch.from_numpy(case["cap"])
    ref = tmi.mesh_search_plain(case["mc"], *case["t_rays"], T_MIN, alive,
                                t_cap)
    small = tmi.mesh_search_plain(case["mc"], *case["t_rays"], T_MIN, alive,
                                  t_cap, slice_rays=300, slice_tris=100)
    for x, y in zip(ref, small):
        assert torch.equal(x, y)
    c1 = tmi.first_crossed_cluster_plain(case["mc"], *case["t_rays"], T_MIN,
                                         alive, t_cap)
    c1_small = tmi.first_crossed_cluster_plain(
        case["mc"], *case["t_rays"], T_MIN, alive, t_cap, slice_rays=77)
    assert torch.equal(c1, c1_small)


def test_wrappers_refuse_what_is_not_ported(case):
    mc, rays = case["mc"], case["t_rays"]
    # Ported since: the other Moller-Trumbore engine and visit modes run
    # (on clusters built with the tables they read), and unknown values of
    # those options raise.
    tables = tmi.prep_mesh_clusters(
        mesh_from_arrays(_arrays(case["jm"]), device="cpu"), mt="mxu")
    few = [r[:64] for r in rays]
    for kw in (dict(mt="mxu"), dict(visit="rowgate"), dict(visit="subtile"),
               dict(visit="sliced")):
        t, idx = tmi.mesh_search(tables, *few, T_MIN, **kw)
        assert t.shape == idx.shape == (64,)
    for kw, what in ((dict(mt="tpu"), "mt"), (dict(visit="rows"), "visit"),
                     (dict(pipe="sort"), "pipe")):
        with pytest.raises(ValueError, match=what):
            tmi.mesh_search(tables, *rays, T_MIN, **kw)
    # Ported since: the sort keys and A4's second output run.
    for mode in ("crossing2", "morton"):
        t, idx = tmi.mesh_search(mc, *rays, T_MIN, sort_mode=mode)
        assert t.shape == idx.shape == (N,)
    c1, c2 = tmi.first_crossed_cluster(mc, *rays, T_MIN, pair=True)
    assert c1.shape == c2.shape == (N,)
    with pytest.raises(ValueError, match="sort_mode"):
        tmi.mesh_search(mc, *rays, T_MIN, sort_mode="fused")
    with pytest.raises(ValueError):       # the exclude operand is integer
        tmi.mesh_search(mc, *rays, T_MIN, exclude=torch.zeros(N))
    with pytest.raises(ValueError):
        tmi.mesh_search(mc, *rays[:5], rays[5].double(), T_MIN)
    with pytest.raises(ValueError):
        tmi.mesh_hits(mc, *rays, T_MIN, torch.ones(N, dtype=torch.int32))
    with pytest.raises(ValueError):
        tmi.mesh_hits(mc, *rays[:5], torch.ones(2 * N)[::2], T_MIN)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tmi.mesh_hits(mc._replace(tri_planes=mc.tri_planes.to("meta"),
                                  box_planes=mc.box_planes.to("meta"),
                                  group_boxes=mc.group_boxes.to("meta")),
                      *(r.to("meta") for r in rays), T_MIN)


@pytest.mark.parametrize("capped", [False, True])
def test_gated_plain_sweep_counts_visits_and_keeps_results(case, capped):
    # The measuring aid behind A3's bound: the kernel's per-lane gate in
    # plain PyTorch gives the ungated sweep's results and counts the
    # (ray, cluster) pairs it lets through.
    _, t_cap = _cap(case, capped)
    alive = torch.from_numpy(case["alive"])
    t_cap = torch.full((N,), BIG) if t_cap is None else t_cap
    ref = tmi.mesh_search_plain(case["mc"], *case["t_rays"], T_MIN, alive,
                                t_cap)
    t, idx, visits = tmi.mesh_search_gated_plain(
        case["mc"], *case["t_rays"], T_MIN, alive, t_cap)
    assert torch.equal(t, ref[0]) and torch.equal(idx, ref[1])
    live = int(alive.sum())
    if case["mc"].k == 1:
        assert 0 < visits <= live
    else:       # the gate prunes: fewer visits than the ungated sweep makes
        assert live < visits < 0.8 * live * case["mc"].k
