"""The per-lane exclude operand of the port's kernels, through their plain
versions on the CPU, against the JAX package's Pallas kernels in interpret
mode: the fused hit in full and shadow mode (A1, A2), the sphere search
(A5) and the clustered mesh search (A3), sorted and unsorted.

The operand leaves one primitive out of each lane's search (-1: none): the
background re-trace of the edge-aware estimator. Each case excludes every
hitting ray's own winner, which reveals the second hit, and checks that the
excluded id never wins.

Tolerances, those of the kernels' own tests: hit flags agree on every live
lane and winner ids on at least 99.9%; on lanes with the same winner t
agrees within rtol 1e-5 widened by 32 ulps times the condition number of the
root (sphere sweeps: the expanded form |o|^2 - 2 o.c + |c|^2 - r^2 rounds
differently under XLA:CPU's contracted multiply-adds; mesh: the same for
t = (qv . e2) / det). Within the port the routes are bitwise: sorted against
unsorted mesh search, and a lane whose exclude id is -1 against the search
without the operand.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.kernels import mesh_intersect as jmi
from qt_raytracer_tpu.kernels.fused_hit import fused_hit_pallas
from qt_raytracer_tpu.kernels.sphere_intersect import sphere_search_pallas
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch.core.intersect import sphere_hit_ts
from qt_raytracer_tpu_torch.kernels import fused_hit as tfh
from qt_raytracer_tpu_torch.kernels import mesh_intersect as tmi
from qt_raytracer_tpu_torch.kernels import sphere_intersect as tsi
from qt_raytracer_tpu_torch.utils.convert import (mesh_from_arrays,
                                                  scene_from_arrays)
from test_torch_mesh_kernel import _mt_rtol
from test_torch_sphere_search import _t_tol
from torch_helpers import _one_thread  # noqa: F401

T_MIN = 1e-3
BIG = tfh.BIG
N_SPHERE = 1024     # fused_hit_pallas takes multiples of 1,024 rays
N_MESH = 4096       # >= 2,048 rays and 9 clusters: the sorted route


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's: a pool first started
    # after XLA has run was seen to take its first vectorised sqrt a few
    # 1e-5 off in one thread, which the expanded-form roots amplify.
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def spheres():
    """The book-cover scene (512 slots), 1,024 rays among its spheres with
    scattered dead lanes and a dead 128-ray row, and the JAX kernel's own
    winners as the exclude operand."""
    js = jscenes.random_scene(seed=5, pad_to=128)
    rng = np.random.default_rng(11)
    o = rng.uniform(-8.0, 8.0, (N_SPHERE, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.01, 3.0, N_SPHERE)
    d = rng.normal(size=(N_SPHERE, 3)).astype(np.float32)
    alive = rng.random(N_SPHERE) >= 0.1
    alive[256:384] = False
    jt, ji = sphere_search_pallas(js, jnp.asarray(o), jnp.asarray(d), T_MIN,
                                  interpret=True, alive=jnp.asarray(alive))
    jt, ji = np.asarray(jt), np.asarray(ji)
    excl = np.where(alive & (jt < BIG), ji, -1).astype(np.int32)
    ts = scene_from_arrays(_arrays(js), device="cpu")
    comps = [np.ascontiguousarray(x[:, k]) for x in (o, d) for k in range(3)]
    return dict(js=js, ts=ts, o=o, d=d, alive=alive, excl=excl, first=ji,
                center=_arrays(js)["center"], radius=_arrays(js)["radius"],
                j_comps=[jnp.asarray(c) for c in comps],
                t_comps=[torch.from_numpy(c) for c in comps])


def _check_sweep(c, got_t, got_i, want_t, want_i):
    """(t, idx) of a sphere sweep with the exclude operand against JAX."""
    alive, excl = c["alive"], c["excl"]
    np.testing.assert_array_equal((got_t < BIG)[alive], (want_t < BIG)[alive])
    hit = alive & (want_t < BIG)
    assert 0.05 < hit[alive].mean() < 1.0     # behind the winner: fewer hits
    assert ((got_i == want_i)[alive]).mean() >= 0.999
    # The excluded sphere never wins, and a second hit shows behind it.
    assert not np.any(hit & (got_i == excl))
    assert np.any(hit & (excl >= 0) & (got_i != c["first"]))
    same = hit & (got_i == want_i)
    k = want_i[same]
    tol = _t_tol(c["o"][same], c["d"][same], c["center"][k],
                       c["radius"][k], want_t[same])
    err = np.abs(got_t[same].astype(np.float64) - want_t[same])
    assert (err <= tol).all(), (err / tol).max()


def test_sphere_search_exclude_matches_pallas_interpret(spheres):
    c = spheres
    jt, ji = sphere_search_pallas(
        c["js"], jnp.asarray(c["o"]), jnp.asarray(c["d"]), T_MIN,
        interpret=True, alive=jnp.asarray(c["alive"]),
        exclude=jnp.asarray(c["excl"]))
    tt, ti = tsi.sphere_search(
        c["ts"], torch.from_numpy(c["o"]), torch.from_numpy(c["d"]), T_MIN,
        alive=torch.from_numpy(c["alive"]),
        exclude=torch.from_numpy(c["excl"]))
    _check_sweep(c, tt.numpy(), ti.numpy(), np.asarray(jt), np.asarray(ji))
    assert (tt.numpy()[~c["alive"]] == BIG).all()
    assert (ti.numpy()[~c["alive"]] == 0).all()


def test_sphere_search_exclude_is_the_masked_ns_search(spheres):
    # An independent form of the same semantics: the [N,S] candidates of
    # intersect.sphere_hit_ts with the excluded column masked, then argmin.
    c = spheres
    o, d = torch.from_numpy(c["o"]), torch.from_numpy(c["d"])
    excl = torch.from_numpy(c["excl"])
    tt, ti = tsi.sphere_search(c["ts"], o, d, T_MIN, exclude=excl)
    ts = sphere_hit_ts(c["ts"], o, d, T_MIN)
    cols = torch.arange(ts.shape[1])
    ts = torch.where(cols[None, :] == excl[:, None], BIG, ts)
    want_t, want_i = ts.min(dim=1)
    hit = want_t < BIG
    assert torch.equal(tt < BIG, hit)
    assert float((ti == want_i.to(torch.int32))[hit].float().mean()) >= 0.999
    assert bool((ti[~hit] == 0).all())


@pytest.mark.parametrize("shadow_only", [False, True])
def test_fused_hit_exclude_matches_pallas_interpret(spheres, shadow_only):
    c = spheres
    want = fused_hit_pallas(c["js"], *c["j_comps"], jnp.asarray(c["alive"]),
                            T_MIN, shadow_only=shadow_only, interpret=True,
                            exclude=jnp.asarray(c["excl"]))
    want = {k: np.asarray(v) for k, v in want.items()}
    tables = tfh.prep_fused_spheres(c["ts"])
    got = tfh.fused_hit(tables, *c["t_comps"], torch.from_numpy(c["alive"]),
                        T_MIN, shadow_only=shadow_only,
                        exclude=torch.from_numpy(c["excl"]))
    got = {k: v.numpy() for k, v in got.items()}
    assert sorted(got) == sorted(want)
    if shadow_only:
        _check_sweep(c, got["t"], got["idx"], want["t"], want["idx"])
        return
    # Full mode: t is the refined root; the winner's parameters and the
    # geometry follow the winner.
    alive = c["alive"]
    np.testing.assert_array_equal((got["t"] < BIG)[alive],
                                  (want["t"] < BIG)[alive])
    hit = alive & (want["t"] < BIG)
    assert ((got["idx"] == want["idx"])[alive]).mean() >= 0.999
    assert not np.any(hit & (got["idx"] == c["excl"]))
    same = alive & (got["idx"] == want["idx"])
    for k in ("mat", "ff"):
        np.testing.assert_array_equal(got[k][same], want[k][same], err_msg=k)
    for k in ("ax", "ay", "az", "fuzz", "ior", "ex", "ey", "ez", "rw"):
        np.testing.assert_array_equal(got[k][same], want[k][same], err_msg=k)
    lanes = same & hit
    np.testing.assert_allclose(got["t"][lanes], want["t"][lanes], rtol=1e-4)
    for k in ("px", "py", "pz", "nx", "ny", "nz"):
        np.testing.assert_allclose(got[k][lanes], want[k][lanes], rtol=1e-4,
                                   atol=1e-3, err_msg=k)
    # A lane whose only hit was the excluded sphere is a miss with sphere
    # 0's parameters.
    lost = alive & (c["excl"] >= 0) & (got["t"] >= BIG)
    assert lost.any() and (got["idx"][lost] == 0).all()


def test_exclude_of_minus_one_changes_no_lane(spheres):
    # Only the lanes that name a sphere change; a wrong pairing of operand
    # and ray would move the others.
    c = spheres
    tables = tfh.prep_fused_spheres(c["ts"])
    alive = torch.from_numpy(c["alive"])
    half = c["excl"].copy()
    half[1::2] = -1
    for kw in (dict(), dict(shadow_only=True)):
        base = tfh.fused_hit(tables, *c["t_comps"], alive, T_MIN, **kw)
        got = tfh.fused_hit(tables, *c["t_comps"], alive, T_MIN,
                            exclude=torch.from_numpy(half), **kw)
        untouched = torch.from_numpy(half < 0)
        for k in base:
            assert torch.equal(base[k][untouched], got[k][untouched]), k
        changed = torch.from_numpy(half >= 0) & alive
        assert bool((base["idx"][changed] != got["idx"][changed]).any())


# ------------------------------------------------------------ mesh (A3)
@pytest.fixture(scope="module")
def terrain():
    """terrain_world(48, 48): 4,418 triangles in 9 clusters, 4,096 rays
    from above it with 60% alive and half the lanes capped, and the JAX
    kernel's own winners as the exclude operand."""
    jm = jmeshes.terrain_world(48, 48, builder="numpy").mesh
    rng = np.random.default_rng(7)
    lo, hi = np.asarray(jm.bvh_min[0]), np.asarray(jm.bvh_max[0])
    o = rng.uniform(lo - 0.5, hi + 0.5, (N_MESH, 3)).astype(np.float32)
    o[:, 1] += 1.5
    d = rng.normal(size=(N_MESH, 3)).astype(np.float32)
    alive = rng.random(N_MESH) < 0.6
    cap = np.where(rng.random(N_MESH) < 0.5, rng.uniform(0.3, 3.0, N_MESH),
                   BIG).astype(np.float32)
    comps = [np.ascontiguousarray(x[:, a]) for x in (o, d) for a in range(3)]
    j_rays = (tuple(map(jnp.asarray, comps[:3])),
              tuple(map(jnp.asarray, comps[3:])))
    jt, ji = jmi.mesh_search_pallas(jm, *j_rays, T_MIN, interpret=True,
                                    alive=jnp.asarray(alive),
                                    t_cap=jnp.asarray(cap))
    jt, ji = np.asarray(jt), np.asarray(ji)
    excl = np.where(alive & (jt < BIG), ji, -1).astype(np.int32)
    mc = tmi.prep_mesh_clusters(mesh_from_arrays(_arrays(jm), device="cpu"))
    assert mc.k == 9
    return dict(jm=jm, mc=mc, o=o, d=d, alive=alive, cap=cap, excl=excl,
                first_t=jt, first_i=ji, j_rays=j_rays,
                t_rays=[torch.from_numpy(x) for x in comps])


@pytest.mark.parametrize("sort", [True, False])
def test_mesh_search_exclude_matches_jax(terrain, sort):
    c = terrain
    alive, excl = c["alive"], c["excl"]
    tj, ij = jmi.mesh_search_pallas(
        c["jm"], *c["j_rays"], T_MIN, interpret=True,
        alive=jnp.asarray(alive), t_cap=jnp.asarray(c["cap"]), sort=sort,
        exclude=jnp.asarray(excl))
    tj, ij = np.asarray(tj), np.asarray(ij)
    tt, it = tmi.mesh_search(
        c["mc"], *c["t_rays"], T_MIN, alive=torch.from_numpy(alive),
        t_cap=torch.from_numpy(c["cap"]), sort=sort,
        exclude=torch.from_numpy(excl))
    tt, it = tt.numpy(), it.numpy()
    assert ((it == ij)[alive]).mean() >= 0.999
    hit = alive & (tj < BIG)
    assert hit.any()
    # The excluded triangle never wins; the terrain behind it shows on some
    # lanes, and the hits are no nearer than the first ones.
    assert not np.any(alive & (tt < BIG) & (it == excl))
    assert np.all(tt[hit] >= c["first_t"][hit] * (1 - 1e-5))
    np.testing.assert_array_equal(tt[alive & (tj >= BIG)],
                                  tj[alive & (tj >= BIG)])
    lanes = np.nonzero(hit & (it == ij))[0]
    rtol = _mt_rtol(c, lanes, ij[lanes])
    err = np.abs(tt[lanes].astype(np.float64) - tj[lanes])
    assert np.all(err <= rtol * np.abs(tj[lanes]))
    assert np.all(tt[~alive] == np.float32(BIG)) and np.all(it[~alive] == 0)


def test_mesh_exclude_rides_through_the_sort(terrain):
    # The sorted route (n >= 2,048, 9 clusters), the unsorted route and the
    # short-wavefront route (n < 2,048: no sort) give the same live lanes bit
    # for bit, and a lane whose operand is -1 keeps its result: an operand
    # that was not permuted with its ray would exclude another ray's
    # triangle.
    c = terrain
    alive = torch.from_numpy(c["alive"])
    cap = torch.from_numpy(c["cap"])
    half = c["excl"].copy()
    half[1::2] = -1
    excl = torch.from_numpy(half)
    args = (c["mc"], *c["t_rays"], T_MIN)
    base = tmi.mesh_search(*args, alive=alive, t_cap=cap)
    srt = tmi.mesh_search(*args, alive=alive, t_cap=cap, exclude=excl)
    uns = tmi.mesh_search(*args, alive=alive, t_cap=cap, exclude=excl,
                          sort=False)
    for a, b in zip(srt, uns):
        assert torch.equal(a[alive], b[alive])
    untouched = alive & (excl < 0)
    for a, b in zip(srt, base):
        assert torch.equal(a[untouched], b[untouched])
    named = alive & (excl >= 0)
    assert bool((srt[1][named] != base[1][named]).any())
    assert not bool(((srt[0] < BIG) & (srt[1] == excl) & named).any())
    n = 1000
    short = tmi.mesh_search(c["mc"], *(r[:n] for r in c["t_rays"]), T_MIN,
                            alive=alive[:n], t_cap=cap[:n],
                            exclude=excl[:n])
    for a, b in zip(short, srt):
        assert torch.equal(a[alive[:n]], b[:n][alive[:n]])


def test_exclude_operand_is_checked(terrain, spheres):
    rays = terrain["t_rays"]
    with pytest.raises(ValueError, match="integer"):
        tmi.mesh_search(terrain["mc"], *rays, T_MIN,
                        exclude=torch.zeros(N_MESH))
    with pytest.raises(ValueError, match="integer"):
        tmi.mesh_hits(terrain["mc"], *rays, T_MIN,
                      exclude=torch.zeros(3, dtype=torch.int32))
    tables = tfh.prep_fused_spheres(spheres["ts"])
    with pytest.raises(ValueError, match="integer"):
        tfh.fused_hit(tables, *spheres["t_comps"],
                      torch.from_numpy(spheres["alive"]), T_MIN,
                      exclude=torch.zeros(N_SPHERE, dtype=torch.bool))
    # int64 ids are taken (and narrowed to int32).
    ok = tfh.fused_hit(tables, *spheres["t_comps"],
                       torch.from_numpy(spheres["alive"]), T_MIN,
                       shadow_only=True,
                       exclude=torch.from_numpy(spheres["excl"]).long())
    assert ok["idx"].dtype == torch.int32
