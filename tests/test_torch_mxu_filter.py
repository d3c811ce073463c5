"""The TF32 filter of the bilinear-form mesh search (``mt="mxu"``, kernel
A3m in ``csrc/mesh_intersect.cu``) on the CPU, in plain PyTorch, on seeded
numpy inputs; no JAX.

On the card a block of 64 rays takes det, u det and v det on the tensor
cores from operands rounded to TF32, with the magnitude of each product as
its error margin, and rejects a pair only where the exact scalar test
certainly rejects it; the exact test decides the rest. Held here:

- soundness: ``mxu_filter_plain`` never rejects a pair that the exact test
  (``_moller_trumbore_bilinear`` under the strict cap) accepts, with each
  product's accumulation error at either sign (the 8 sign patterns of
  det, u det and v det), operands and products below 2^-126 flushed to
  zero or kept; on seeded random triangles and rays at several scales, on
  a small terrain, and on
  ``torch_helpers.mxu_adversarial`` (vertices, edges, grazing rays, |det|
  within a few ulps of 1e-12, t at t_min, at 0 and at the cap,
  coordinates up to 1e4, padding triangles, a subnormal direction,
  and a u that underflows to -0.0, which the exact test accepts), there
  also at t_min 0 and -0.5;
- the kernel's algorithm (``mesh_search_gated_plain(mt="mxu")``: blocks
  of 64 rays as they lie, the rays that pass a cluster's gate packed into
  tiles of 16, the filter held sound on every pair it sweeps, the exact
  test deciding) equals ``mesh_search_plain(mt="mxu")`` bit for bit on the
  meshes of
  ``test_torch_mesh_bodies.py`` (terrain_world(24, 24), 3 clusters; the
  Cornell box, 1), with and without exclude, with the rays as given,
  shifted by 7 lanes and permuted, so that each lands in another tile and
  block;
- its counts of work against its ray visits, and its check of the
  filter, which raises on a filter that rejects an accepted pair;
- ``tf32_round`` on known roundings, and the filter's constants against the
  CUDA source.

Tolerances: none; the filter and the search are compared exactly.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from qt_raytracer_tpu_torch.accel.mesh import build_mesh
from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi
from qt_raytracer_tpu_torch.models import meshes
from torch_helpers import HUGE, _one_thread, mxu_adversarial  # noqa: F401

T_MIN = 1e-3
BIG = mi.BIG
N = 1024
SIGNS = [(a, b, c) for a in (-1.0, 1.0) for b in (-1.0, 1.0)
         for c in (-1.0, 1.0)]
SOURCE = pathlib.Path(mi.__file__).resolve().parents[1] / "csrc" / \
    "mesh_intersect.cu"


def _columns(x: np.ndarray):
    return [torch.from_numpy(np.ascontiguousarray(x[:, a].astype(np.float32)))
            for a in range(3)]


def _random_case(rng):
    """Triangles of three scales (1, 1e-3 and 50 about 1e3 from the
    origin) and rays from around them, as (factor planes, rays, cap)."""
    tris = []
    for scale, where in ((1.0, 1.0), (1e-3, 1.0), (50.0, 1e3)):
        v0 = rng.uniform(-where, where, (120, 3))
        tris.append(np.stack([v0, v0 + rng.normal(size=(120, 3)) * scale,
                              v0 + rng.normal(size=(120, 3)) * scale], 1))
    tris = np.concatenate(tris)
    verts = tris.reshape(-1, 3)
    mesh = build_mesh(verts, np.arange(verts.shape[0]).reshape(-1, 3),
                      builder="numpy", device="cpu")
    # Half the rays aimed at a triangle's centroid: hits occur.
    n = 512
    cen = tris.mean(1)
    tgt = cen[rng.integers(0, len(cen), n)]
    o = tgt + rng.normal(size=(n, 3)) * np.abs(tgt).max(1, keepdims=True) \
        * 0.01 + rng.normal(size=(n, 3))
    d = np.where(rng.random((n, 1)) < 0.5, tgt - o, rng.normal(size=(n, 3)))
    cap = np.where(rng.random(n) < 0.5, BIG, rng.uniform(0.5, 5.0, n))
    mc = mi.prep_mesh_clusters(mesh, mt="mxu")
    return mc.mt_planes, _columns(o) + _columns(d), \
        torch.from_numpy(cap.astype(np.float32))


def _terrain_case(rng, n=256):
    mesh = meshes.terrain_world(24, 24, builder="numpy", device="cpu").mesh
    mc = mi.prep_mesh_clusters(mesh, mt="mxu")
    lo, hi = mc.root_lo.numpy(), mc.root_hi.numpy()
    o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3))
    o[:, 1] += 1.5
    # Half aimed at the surface (vertices of random triangles): hits occur.
    tp = mc.tri_planes.numpy()
    tgt = tp[0:3, rng.integers(0, mesh.num_triangles, n)].T
    d = np.where(rng.random((n, 1)) < 0.5, tgt - o, rng.normal(size=(n, 3)))
    cap = np.where(rng.random(n) < 0.5, BIG, rng.uniform(0.3, 3.0, n))
    return mc.mt_planes, _columns(o) + _columns(d), \
        torch.from_numpy(cap.astype(np.float32))


def _adversarial_case(rng):
    mesh, rays, cap = mxu_adversarial(seed=int(rng.integers(0, 2 ** 16)))
    return mi.prep_mesh_clusters(mesh, mt="mxu").mt_planes, rays, cap


CASES = {"random": _random_case, "terrain": _terrain_case,
         "adversarial": _adversarial_case}


@pytest.fixture(scope="module")
def pair_cases():
    return {name: make(np.random.default_rng(i))
            for i, (name, make) in enumerate(CASES.items())}


def _exact(f, rays, cap):
    """(t, accept) of every ray against every triangle of f: the exact
    bilinear form and its accept test under the strict cap."""
    o = tuple(x[:, None] for x in rays[:3])
    d = tuple(x[:, None] for x in rays[3:])
    m = mi._ray_moment(o, d)
    t, ok = mi._moller_trumbore_bilinear(o, d, m, f, T_MIN)
    return (o, d, m), t, ok & (t < cap[:, None])


@pytest.mark.parametrize("ftz", [True, False], ids=["ftz", "no_ftz"])
@pytest.mark.parametrize("name", list(CASES))
def test_filter_never_rejects_an_accepted_pair(pair_cases, name, ftz):
    f, rays, cap = pair_cases[name]
    (o, d, m), t, accept = _exact(f, rays, cap)
    assert int(accept.sum()) >= 100          # hits occur
    for acc in SIGNS:
        maybe = mi.mxu_filter_plain(d, m, f, acc=acc, ftz=ftz)
        bad = accept & ~maybe
        assert not bool(bad.any()), (acc, torch.nonzero(bad)[:5].tolist())
    # Not vacuous: the kernel's filter rejects most pairs that miss.
    rejected = ~mi.mxu_filter_plain(d, m, f, ftz=ftz)
    missed = ~accept & (f[0:3].abs().sum(0) > 0)[None, :]
    share = float((rejected & missed).sum()) / float(missed.sum())
    assert share > 0.8, share
    if name == "adversarial":
        # The last ray's u underflows to -0.0 on the HUGE triangle: the
        # exact test accepts it, and the filter, by its floor, passes it.
        huge = int(torch.nonzero(f[15:18].abs().amax(0) > HUGE).squeeze())
        assert bool(accept[-1, huge])
        maybe = mi.mxu_filter_plain(d, m, f, acc=SIGNS[0], ftz=ftz)
        assert bool(maybe[-1, huge])


@pytest.mark.parametrize("t_min", [0.0, -0.5])
def test_filter_sound_at_other_t_min(pair_cases, t_min):
    # At t_min 0 and below, t = +-0 (origins on a triangle) and hits behind
    # the origin are accepted: the filter, which never looks at t, must
    # pass them too.
    f, rays, cap = pair_cases["adversarial"]
    o = tuple(x[:, None] for x in rays[:3])
    d = tuple(x[:, None] for x in rays[3:])
    m = mi._ray_moment(o, d)
    t, ok = mi._moller_trumbore_bilinear(o, d, m, f, t_min)
    accept = ok & (t < cap[:, None])
    assert bool((accept & (t <= 0)).any())
    for acc in SIGNS:
        maybe = mi.mxu_filter_plain(d, m, f, acc=acc)
        assert not bool((accept & ~maybe).any()), acc


def test_filter_rejects_padding_triangles(pair_cases):
    # A padding triangle's factors are 0: det is 0, and the det test alone
    # rejects it.
    f, rays, cap = pair_cases["terrain"]
    pad = f[:, -1:].clone()
    assert not bool(pad.any())
    o = tuple(x[:, None] for x in rays[:3])
    d = tuple(x[:, None] for x in rays[3:])
    for acc in SIGNS:
        assert not bool(mi.mxu_filter_plain(d, mi._ray_moment(o, d), pad,
                                            acc=acc).any())


def test_tf32_round():
    big = torch.finfo(torch.float32).max
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -11, big, float("inf"), 1e-40, 0.0],
                     dtype=torch.float32)
    want = [1.0, 1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10), 1.0 + 2 ** -9,
            float("inf"), float("inf")]
    got = mi.tf32_round(x)
    assert got[:7].tolist() == want
    # A subnormal keeps its top 10 bits below the implicit one, rounded.
    sub = x[7:8].view(torch.int32)
    assert int(got[7:8].view(torch.int32)) == (int(sub) + 0x1000) & -0x2000
    assert float(got[8]) == 0.0
    assert bool(torch.isnan(mi.tf32_round(torch.tensor([float("nan")])))[0])


def _const(text: str, name: str) -> float:
    expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", text).group(1)
    expr = re.sub(r"(0x1p-?\d+)f", lambda mt: repr(float.fromhex(mt.group(1))),
                  expr)
    return eval(expr.replace("f", ""), {})


def test_constants_match_the_source():
    text = SOURCE.read_text()
    assert _const(text, "MXU_RAYS") == mi.MXU_RAYS
    assert _const(text, "MXU_WARPS") * mi.MXU_RAYS == mi.MXU_BLOCK_RAYS
    for name in ("MXU_C", "MXU_FLOOR", "MXU_ABS", "MXU_TAU", "K_UV"):
        assert _const(text, name) == getattr(mi, name), name
    assert re.search(r"DET_LO = 1e-12f \* \(1\.0f - 0x1p-20f\)", text)
    assert mi.DET_LO == float(np.float32(1e-12) * np.float32(1 - 2 ** -20))
    assert mi.DET_LO < float(np.float32(1e-12))


# ------------------------------------------- the kernel's algorithm, bitwise
@pytest.fixture(scope="module")
def search_cases():
    """The two meshes of test_torch_mesh_bodies.py with the factor planes,
    and 1,024 rays each, 60% alive, half of them capped (that module's
    case)."""
    out = {}
    rng = np.random.default_rng(24)
    for name, world in (("terrain24", meshes.terrain_world(
            24, 24, builder="numpy", device="cpu")),
            ("cornell", meshes.cornell_box_world(builder="numpy",
                                                 device="cpu"))):
        mc = mi.prep_mesh_clusters(world.mesh, mt="mxu")
        lo, hi = mc.root_lo.numpy(), mc.root_hi.numpy()
        o = rng.uniform(lo - 0.5, hi + 0.5, (N, 3))
        o[:, 1] += 1.5 if name == "terrain24" else 0.0
        d = rng.normal(size=(N, 3))
        alive = torch.from_numpy(rng.random(N) < 0.6)
        cap = torch.from_numpy(np.where(rng.random(N) < 0.5,
                                        rng.uniform(0.3, 3.0, N),
                                        BIG).astype(np.float32))
        out[name] = (mc, _columns(o) + _columns(d), alive, cap)
    return out


def _placed(rays, alive, cap, excl, placement, rng):
    """The inputs in another order: as given, behind 7 dead lanes, or
    permuted; and the index of each original lane there."""
    n = rays[0].shape[0]
    if placement == "as_is":
        where = torch.arange(n)
    elif placement == "shifted":
        where = torch.arange(n) + 7
    else:
        where = torch.from_numpy(rng.permutation(n))
    m = int(where.max()) + 1

    def put(x, fill):
        out = torch.full((m,), fill, dtype=x.dtype)
        out[where] = x
        return out

    return ([put(x, 0.0) for x in rays], put(alive, False), put(cap, BIG),
            None if excl is None else put(excl, -1), where)


@pytest.mark.parametrize("placement", ["as_is", "shifted", "permuted"])
@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("name", ["terrain24", "cornell"])
def test_filter_then_exact_equals_plain(search_cases, name, exclude,
                                        placement):
    mc, rays, alive, cap = search_cases[name]
    excl = None
    if exclude:
        t0, i0 = mi.mesh_search_plain(mc, *rays, T_MIN, alive, cap, mt="mxu")
        excl = torch.where(alive & (t0 < BIG), i0, -1).to(torch.int32)
    want = mi.mesh_search_plain(mc, *rays, T_MIN, alive, cap, exclude=excl,
                                mt="mxu")
    rng = np.random.default_rng(5)
    r2, a2, c2, e2, where = _placed(rays, alive, cap, excl, placement, rng)
    got = mi.mesh_search_gated_plain(mc, *r2, T_MIN, a2, c2, mt="mxu",
                                     exclude=e2)
    assert torch.equal(got[0][where], want[0])
    assert torch.equal(got[1][where], want[1])
    hits = want[0][alive] < BIG
    if exclude:
        # A height field seldom shows a second hit behind the first.
        assert int(hits.sum()) >= 3
        named = alive & (excl >= 0) & (want[0] < BIG)
        assert not bool((named & (want[1] == excl)).any())
    else:
        assert 0.05 < float(hits.float().mean()) < 0.95


@pytest.mark.parametrize("name", ["terrain24", "cornell"])
def test_work_counts_are_consistent(search_cases, name):
    mc, rays, alive, cap = search_cases[name]
    t, idx, visits, work = mi.mesh_search_gated_plain(mc, *rays, T_MIN,
                                                      alive, cap, mt="mxu")
    _, _, visits_vpu = mi.mesh_search_gated_plain(mc, *rays, T_MIN, alive,
                                                  cap)
    assert visits == visits_vpu > 0       # the same gate, the same visits
    tiles, blocks = work["tile_visits"], work["block_visits"]
    # The packed tiles hold the visits, at most one tile a block short.
    assert visits <= mi.MXU_RAYS * tiles < visits + mi.MXU_RAYS * blocks
    per = mi.MXU_BLOCK_RAYS // mi.MXU_RAYS
    assert blocks <= tiles <= per * blocks
    # Each hit's winning pair passed the filter; the filter keeps few.
    g = mc.tris_per_cluster
    assert int((t[alive] < BIG).sum()) <= work["filter_passes"] \
        < 0.05 * visits * g
    # The exact sweep decides: its bits are the ungated sweep's.
    want = mi.mesh_search_plain(mc, *rays, T_MIN, alive, cap, mt="mxu")
    assert torch.equal(t, want[0]) and torch.equal(idx, want[1])


@pytest.mark.parametrize("reject", ["all", "a_winner"])
def test_gated_sweep_catches_an_unsound_filter(search_cases, monkeypatch,
                                               reject):
    # A filter that drops every pair, or only the pairs of one triangle
    # that some ray hits first, must stop the gated sweep, not quietly
    # change its result.
    mc, rays, alive, cap = search_cases["terrain24"]
    t0, i0 = mi.mesh_search_plain(mc, *rays, T_MIN, alive, cap, mt="mxu")
    winner = mc.mt_planes[:, int(i0[alive & (t0 < BIG)][0])]
    sound = mi.mxu_filter_plain

    def unsound(d, m, f, **kw):
        keep = sound(d, m, f, **kw)
        if reject == "all":
            return torch.zeros_like(keep)
        return keep & ~(f == winner[:, None]).all(0)[None, :]

    monkeypatch.setattr(mi, "mxu_filter_plain", unsound)
    with pytest.raises(AssertionError, match="filter rejects"):
        mi.mesh_search_gated_plain(mc, *rays, T_MIN, alive, cap, mt="mxu")
