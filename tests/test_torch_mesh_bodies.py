"""The clustered mesh search's other kernel bodies and options
(qt_raytracer_tpu_torch.kernels.mesh_intersect) on the CPU, through their
plain versions: the row boxes and the bilinear-form factor tables, the
row-gated body (``visit="rowgate"``), the bilinear-form Moller-Trumbore
(``mt="mxu"``), each with and without the exclude operand, the sort pipe
(``pipe``), the cluster size (``cluster_rows``) and the validation of every
new keyword and ``RenderConfig`` field; against the JAX package with Pallas
in interpret mode, on terrain_world(24, 24) (1,058 triangles, 3 clusters)
and 1,024 rays (one grid step of the JAX kernel), 60% alive, half of them
capped.

Tolerances. The tables are bitwise: row boxes are minima, maxima and one
add; the factors round as XLA:CPU rounds them (cross products contracted
into FMAs, v0 . n summed left to right). The row gate only skips rows that
no lane could win, the cluster size only regroups the same triangles and
both pipe names take the one sort step, so each is bitwise equal to the
default on live lanes. Against JAX, and between the two Moller-Trumbore engines, winner
ids agree on at least 99.9% of live lanes and t within rtol 1e-5 widened by
32 ulps times the condition number of t (tests/test_torch_mesh_kernel.py's
rule, with the bilinear form's terms where that form computes t): XLA:CPU
contracts multiply-adds and sums its small matrix products in its own
order, and the two engines round their candidates differently.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.kernels import mesh_intersect as jmi
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu_torch import RenderConfig
from qt_raytracer_tpu_torch.kernels import mesh_intersect as tmi
from qt_raytracer_tpu_torch.utils.convert import mesh_from_arrays
from torch_helpers import _one_thread  # noqa: F401

N = 1024
T_MIN = 1e-3
EPS32 = 2.0 ** -24
BIG = tmi.BIG
AGREE_MIN = 0.999


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's (test_torch_compact.py).
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def meshes():
    """name: (JAX mesh, the port's copy) for terrain_world(24, 24) and the
    true Cornell box (36 triangles, 1 cluster)."""
    out = {}
    for name, world in (("terrain24", jmeshes.terrain_world(24, 24,
                                                            builder="numpy")),
                        ("cornell", jmeshes.cornell_box_world(
                            builder="numpy"))):
        out[name] = (world.mesh, mesh_from_arrays(_arrays(world.mesh),
                                                  device="cpu"))
    return out


@pytest.fixture(scope="module")
def case(meshes):
    jm, tm = meshes["terrain24"]
    rng = np.random.default_rng(24)
    lo, hi = np.asarray(jm.bvh_min[0]), np.asarray(jm.bvh_max[0])
    o = rng.uniform(lo - 0.5, hi + 0.5, (N, 3)).astype(np.float32)
    o[:, 1] += 1.5                            # above the height field
    d = rng.normal(size=(N, 3)).astype(np.float32)
    alive = rng.random(N) < 0.6
    cap = np.where(rng.random(N) < 0.5, rng.uniform(0.3, 3.0, N),
                   BIG).astype(np.float32)
    comps = [np.ascontiguousarray(x[:, a]) for x in (o, d) for a in range(3)]
    mc = tmi.prep_mesh_clusters(tm, mt="mxu")
    t_rays = [torch.from_numpy(c) for c in comps]
    full = tmi.mesh_search(mc, *t_rays, T_MIN, alive=torch.from_numpy(alive),
                           t_cap=torch.from_numpy(cap))
    return dict(jm=jm, tm=tm, mc=mc, o=o, d=d, alive=alive, cap=cap,
                j_rays=(tuple(map(jnp.asarray, comps[:3])),
                        tuple(map(jnp.asarray, comps[3:]))),
                t_rays=t_rays, full=tuple(x.numpy() for x in full))


def _search(case, **kw):
    """The port's search on the case's rays (capped), as numpy."""
    t, idx = tmi.mesh_search(case["mc"], *case["t_rays"], T_MIN,
                             alive=torch.from_numpy(case["alive"]),
                             t_cap=torch.from_numpy(case["cap"]), **kw)
    return t.numpy(), idx.numpy()


def _jax_search(case, **kw):
    t, idx = jmi.mesh_search_pallas(
        case["jm"], *case["j_rays"], T_MIN, interpret=True,
        alive=jnp.asarray(case["alive"]), t_cap=jnp.asarray(case["cap"]),
        **kw)
    return np.asarray(t), np.asarray(idx)


def _own_winner(case):
    """Each live hitting lane's own winner as its exclude id, -1 elsewhere."""
    t, idx = case["full"]
    return np.where(case["alive"] & (t < BIG), idx, -1).astype(np.int32)


def _cond(case, lanes, tri, engine):
    """Condition number of t at (lane, triangle): the sum of the magnitudes
    of the terms of numerator and determinant over their values, in float64,
    for the elementwise form ("vpu") or the bilinear form ("mxu")."""
    tp = case["mc"].tri_planes.numpy().astype(np.float64)
    v0, e1, e2 = tp[0:3, tri].T, tp[3:6, tri].T, tp[6:9, tri].T
    o = case["o"][lanes].astype(np.float64)
    d = case["d"][lanes].astype(np.float64)
    if engine == "vpu":
        pv = np.cross(d, e2)
        det_terms, t_terms = pv * e1, np.cross(o - v0, e1) * e2
    else:
        n = np.cross(e1, e2)
        det_terms = -d * n
        t_terms = np.concatenate([o * n, -(v0 * n).sum(1, keepdims=True)],
                                 axis=1)
    return (np.abs(det_terms).sum(1) / np.abs(det_terms.sum(1))
            + np.abs(t_terms).sum(1) / np.abs(t_terms.sum(1)))


def _assert_agree(case, got, want, engines, min_hits=0.1):
    """Winner ids on >= 99.9% of live lanes; on a shared hit, t within
    1e-5 + 32 ulps x the condition numbers of the engines that computed
    the two sides; the same misses."""
    (tg, ig), (tw, iw) = got, want
    alive = case["alive"]
    agree = (ig == iw)[alive]
    assert agree.mean() >= AGREE_MIN, agree.mean()
    hit = alive & (tw < BIG)
    assert min_hits < hit[alive].mean() < 0.9   # hits and misses both occur
    same = hit & (ig == iw)
    lanes = np.nonzero(same)[0]
    rtol = 1e-5 + 32 * EPS32 * sum(_cond(case, lanes, iw[lanes], e)
                                   for e in engines)
    err = np.abs(tg[lanes].astype(np.float64) - tw[lanes])
    assert np.all(err <= rtol * np.abs(tw[lanes])), \
        np.max(err / (rtol * np.abs(tw[lanes])))
    missed = alive & (tw >= BIG) & (ig == iw)
    np.testing.assert_array_equal(tg[missed], tw[missed])


# ------------------------------------------------------------- tables
@pytest.mark.parametrize("name", ["terrain24", "cornell"])
def test_row_boxes_bitwise(meshes, name):
    jm, tm = meshes[name]
    mc = tmi.prep_mesh_clusters(tm)
    p_pad = mc.k * mc.tris_per_cluster
    want = jmi.prep_row_boxes(jm, p_pad)
    got = tmi.prep_row_boxes(tm, p_pad)
    assert got.shape == (6, p_pad // 128) and got.dtype == torch.float32
    assert torch.equal(mc.row_boxes, got)
    for a in range(6):
        np.testing.assert_array_equal(got[a].numpy(), np.asarray(want[a]))
    # Each row box holds its rows' triangles; padding rows sit at 1e9.
    real = -(-tm.num_triangles // 128)
    assert bool((got[:3, real:] > 1e8).all())
    assert bool((got[:3, :real] <= got[3:, :real]).all())


@pytest.mark.parametrize("name", ["terrain24", "cornell"])
def test_mt_features_bitwise(meshes, name):
    jm, tm = meshes[name]
    mc = tmi.prep_mesh_clusters(tm, mt="mxu")
    p_pad = mc.k * mc.tris_per_cluster
    got = tmi.build_mt_features(tm, p_pad)
    assert got.shape == (tmi.MT_FEATURES, p_pad) and torch.equal(got,
                                                                 mc.mt_planes)
    # The TPU's row-interleaved [PR * q, 128] tables, de-interleaved to
    # one [P_pad] row per factor, in the port's order.
    rows = []
    for table, q in zip(jmi.build_mt_features(jm, p_pad), (3, 6, 6, 4)):
        t = np.asarray(table).reshape(-1, q, 128).transpose(1, 0, 2)
        rows.extend(t.reshape(q, -1))
    want = np.stack(rows)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # Padding triangles carry no factor: det = 0 rejects them.
    assert not bool(got[:, tm.num_triangles:].any())


# ------------------------------------------------------------- bodies
def test_rowgate_equals_full_and_matches_jax(case):
    got = _search(case, visit="rowgate")
    for x, y in zip(got, case["full"]):
        np.testing.assert_array_equal(x[case["alive"]], y[case["alive"]])
    assert np.all(got[0][~case["alive"]] == np.float32(BIG))
    assert np.all(got[1][~case["alive"]] == 0)
    _assert_agree(case, got, _jax_search(case, visit="rowgate"), ["vpu"])


def test_rowgate_plain_counts_rows(case):
    # The row-gated plain sweep: the ungated sweep's bits, and fewer rows
    # swept than the clusters it visits hold.
    mc, rays = case["mc"], case["t_rays"]
    alive = torch.from_numpy(case["alive"])
    cap = torch.from_numpy(case["cap"])
    t, idx, visits, rows = tmi.mesh_search_gated_plain(
        mc, *rays, T_MIN, alive, cap, visit="rowgate")
    np.testing.assert_array_equal(t.numpy(), case["full"][0])
    np.testing.assert_array_equal(idx.numpy(), case["full"][1])
    t3 = tmi.mesh_search_gated_plain(mc, *rays, T_MIN, alive, cap)
    assert len(t3) == 3 and t3[2] == visits
    assert 0 < rows < visits * mc.tris_per_cluster // 128


def test_mxu_matches_jax_and_vpu(case):
    got = _search(case, mt="mxu")
    _assert_agree(case, got, _jax_search(case, mt="mxu"), ["mxu"])
    _assert_agree(case, got, case["full"], ["mxu", "vpu"])
    # The engine takes precedence over the visit mode, as in JAX.
    both = _search(case, mt="mxu", visit="rowgate")
    for x, y in zip(both, got):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [dict(visit="rowgate"), dict(mt="mxu")],
                         ids=["rowgate", "mxu"])
def test_exclude_under_each_body(case, kw):
    excl = _own_winner(case)
    got = _search(case, exclude=torch.from_numpy(excl), **kw)
    named = case["alive"] & (excl >= 0)
    assert named.sum() > 50
    assert not np.any(named & (got[0] < BIG) & (got[1] == excl))
    # A height field seldom shows a second hit behind the first.
    assert np.sum(named & (got[0] < BIG)) >= 3
    engines = ["mxu"] if kw.get("mt") == "mxu" else ["vpu"]
    _assert_agree(case, got, _jax_search(case, exclude=jnp.asarray(excl),
                                         **kw), engines, min_hits=0.0)
    if kw.get("visit") == "rowgate":
        plain = _search(case, exclude=torch.from_numpy(excl))
        for x, y in zip(got, plain):
            np.testing.assert_array_equal(x[case["alive"]], y[case["alive"]])


# ------------------------------------------------------------- options
@pytest.mark.parametrize("capped", [False, True])
def test_fused_pipe_equals_gather_on_every_lane(case, capped):
    mc, rays = case["mc"], case["t_rays"]
    big = [torch.cat([r] * 2) for r in rays]          # 2,048 rays: sorted
    alive = torch.from_numpy(np.tile(case["alive"], 2))
    cap = torch.from_numpy(np.tile(case["cap"], 2)) if capped else None
    excl = torch.from_numpy(np.tile(_own_winner(case), 2))
    for kw in (dict(exclude=excl), dict(mt="mxu", sort_mode="crossing2")):
        out = [tmi.mesh_search(mc, *big, T_MIN, alive=alive, t_cap=cap,
                               pipe=pipe, **kw) for pipe in tmi.SORT_PIPES]
        for x, y in zip(*out):
            assert torch.equal(x, y), kw


@pytest.mark.parametrize("visit", ["full", "rowgate"])
@pytest.mark.parametrize("name", ["terrain24", "cornell"])
def test_cluster_rows_keep_live_lanes(case, meshes, name, visit):
    tm = meshes[name][1]
    ref = tmi.prep_mesh_clusters(tm)
    # 2,048 terrain rays, so that the sort runs; the Cornell box is one
    # cluster and never sorts.
    reps, n = (2, 2 * N) if name == "terrain24" else (1, N // 2)
    rays = [torch.cat([r] * reps)[:n] for r in case["t_rays"]]
    alive = torch.from_numpy(np.tile(case["alive"], reps)[:n])
    cap = torch.from_numpy(np.tile(case["cap"], reps)[:n])
    want = tmi.mesh_search(ref, *rays, T_MIN, alive=alive, t_cap=cap)
    p = tm.num_triangles
    for rows in (1, 2, 4):
        mc = tmi.prep_mesh_clusters(tm, cluster_rows=rows)
        assert mc.tris_per_cluster == 128 * tmi.cluster_rows_for(p, rows)
        assert mc.k == tmi.num_clusters(p, rows)
        assert mc.k * mc.tris_per_cluster >= p
        got = tmi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap,
                              visit=visit)
        for x, y in zip(got, want):
            assert torch.equal(x[alive], y[alive]), (rows, visit)
    # The JAX package's own formula at its default size.
    assert (tmi.num_clusters(p), tmi.cluster_rows_for(p)) == \
        (jmi.num_clusters(p), jmi.cluster_rows_for(p))
    # The 99,458-triangle terrain in clusters of one row: 778 clusters,
    # beyond what the two-cluster sort key packs.
    assert tmi.num_clusters(99458, 1) == 778 > tmi.CROSSING2_MAX_K


def test_refusals(case):
    mc, rays = case["mc"], case["t_rays"]
    few = [r[:8] for r in rays]
    for kw, what in [(dict(mt="MXU"), "mt"), (dict(mt=None), "mt"),
                     (dict(visit="row"), "visit"), (dict(visit=""), "visit"),
                     (dict(pipe="sort"), "pipe"), (dict(pipe=None), "pipe")]:
        with pytest.raises(ValueError, match=what):
            tmi.mesh_search(mc, *few, T_MIN, **kw)
    for bad in (0, -1, 2.0, "4", True, None):
        with pytest.raises(ValueError, match="cluster_rows"):
            tmi.prep_mesh_clusters(case["tm"], cluster_rows=bad)
        with pytest.raises(ValueError, match="cluster_rows"):
            tmi.num_clusters(100, bad)
    for bad in ("MXU", None):
        with pytest.raises(ValueError, match="mt"):
            tmi.prep_mesh_clusters(case["tm"], mt=bad)
    # The row boxes are always built; the factors only with mt="mxu", and
    # the bilinear form refuses clusters built without them.
    bare = tmi.prep_mesh_clusters(case["tm"])
    assert bare.mt_planes is None
    assert torch.equal(bare.row_boxes, mc.row_boxes)
    with pytest.raises(ValueError, match="row_boxes"):
        tmi.mesh_search(mc._replace(row_boxes=mc.row_boxes[:5]), *few,
                        T_MIN, visit="rowgate")
    with pytest.raises(ValueError, match="mt_planes"):
        tmi.mesh_hits(bare, *few, T_MIN, mt="mxu")
    with pytest.raises(ValueError, match="mt_planes"):
        tmi.mesh_search(mc._replace(mt_planes=mc.mt_planes[:18]), *few,
                        T_MIN, mt="mxu")


NEW_FIELDS = dict(mesh_visit="full", mesh_mt="vpu", mesh_sort_pipe="gather",
                  mesh_cluster_rows=4)


@pytest.mark.parametrize("field,good,bad", [
    ("mesh_visit", ["full", "subtile", "sliced", "rowgate"],
     ["Full", "row", "", None, 1]),
    ("mesh_mt", ["vpu", "mxu"], ["tpu", "", None, 0]),
    ("mesh_sort_pipe", ["gather", "fused"], ["sort", "", None]),
    ("mesh_cluster_rows", [1, 2, 4, 8], [0, -1, 2.0, "4", True, None]),
])
def test_render_config_search_fields(field, good, bad):
    from qt_raytracer_tpu_torch.core.config import mesh_search_options
    cfg = RenderConfig()
    assert getattr(cfg, field) == NEW_FIELDS[field]
    # Both sort pipes name the one sort step of the port: no search reads
    # the field.
    passed = field != "mesh_sort_pipe"
    assert (field in mesh_search_options(cfg)) == passed
    for value in good:
        assert getattr(RenderConfig(**{field: value}), field) == value
        if passed:
            assert mesh_search_options(RenderConfig(**{field: value}))[
                field] == value
    for value in bad:
        with pytest.raises(ValueError, match=field):
            RenderConfig(**{field: value})
    hash(RenderConfig(**{field: good[-1]}))       # still hashable
