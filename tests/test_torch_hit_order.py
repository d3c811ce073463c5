"""The invariants the hand-written sweeps of the sphere hit kernels (A1,
A2, A5: ``csrc/fused_hit.cu``) and of the clustered mesh search (A3:
``csrc/mesh_intersect.cu``) rest on, held bit for bit on the CPU in plain
PyTorch, on seeded numpy inputs.

Both kernels update a running minimum with a strict '<' in ascending id
order, against a cap that only shrinks, and a candidate's t does not depend
on the cap. So a run of ids may be split over 32 lanes (lane l takes ids l,
l + 32, ...), each lane scanning its share serially from the run's starting
cap, and the lanes' (t, id) reduced lexicographically by a butterfly of xor
offsets 16, 8, 4, 2, 1 (as ``__shfl_xor_sync`` does): the result is the
serial scan's. And a gate that skips a group of ids only when none of them
can beat the cap leaves every result as it was. Held here:

- the lane-split sphere sweep against ``fused_hit._sweep`` /
  ``min_then_match``, with and without the exclude operand, and against the
  JAX package's ``fused_hit_pallas`` in interpret mode (winner ids on at
  least 99.9% of live lanes and t within rtol 1e-5 + 32 ulps x the root's
  condition number on the rest, the rule of ``test_torch_fused_hit.py``:
  XLA:CPU contracts multiply-adds that PyTorch rounds one by one);
- the same with ties made on purpose: copies of a sphere whose ids fall in
  other lanes and other 32- and 64-slot groups;
- the kernel's group gate over 32- and 64-slot boxes
  (``fused_hit.sweep_gated_plain``) against the ungated sweep, also with a
  sphere of negative radius isolated in its group;
- A3 as the warp-per-ray kernel runs it, emulated here: the cluster gate at
  each cluster's turn, the row gate (visit "rowgate") at each row's turn, a
  lane split of each visited cluster or row and the lexicographic reduce,
  against ``mesh_search_plain`` and ``mesh_search_gated_plain``, on a 48x48
  terrain (4,418 triangles) at clusters of 1 and 4 rows and on the
  36-triangle Cornell mesh, with and without exclude, and with copies of
  triangles in other lanes and other clusters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.kernels.fused_hit import fused_hit_pallas
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch import SceneBuilder, scenes
from qt_raytracer_tpu_torch.kernels import fused_hit as fh
from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi
from qt_raytracer_tpu_torch.models import meshes
from qt_raytracer_tpu_torch.utils.convert import scene_from_arrays
from torch_helpers import _one_thread, with_copies  # noqa: F401

LANES = 32
NO_ID = 2 ** 31 - 1
T_MIN = 1e-3
BIG = fh.BIG
EPS32 = 2.0 ** -24


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py, and PyTorch's
    # thread pool started before XLA's.
    torch.sqrt(torch.ones(8))
    jax.clear_caches()
    yield


def lex_reduce(t, ids):
    """[m, 32] lanes' (t, id) -> [m]: the butterfly of warp_sweep, each step
    taking the partner's pair when it is lexicographically smaller. Every
    lane ends on the same pair."""
    lane = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        t2, i2 = t[:, lane ^ off], ids[:, lane ^ off]
        take = (t2 < t) | ((t2 == t) & (i2 < ids))
        t, ids = torch.where(take, t2, t), torch.where(take, i2, ids)
    assert torch.equal(t, t[:, :1].expand_as(t))
    assert torch.equal(ids, ids[:, :1].expand_as(ids))
    return t[:, 0], ids[:, 0]


def lane_scan(accept, t, ids, t_start):
    """Each lane's serial strict-'<' scan of its share: accept, t and ids
    are [m, steps, 32] (step s, lane l: id base + 32 s + l); the lane starts
    at (t_start, NO_ID). Returns its (t, id) [m, 32]."""
    lt = t_start[:, None].expand(-1, LANES).clone()
    li = torch.full_like(lt, NO_ID, dtype=torch.int32)
    for s in range(t.shape[1]):
        better = accept[:, s] & (t[:, s] < lt)
        lt = torch.where(better, t[:, s], lt)
        li = torch.where(better, ids[:, s], li)
    return lt, li


def split_by_lane(x, fill):
    """[m, n] -> [m, ceil(n / 32), 32], padded with fill."""
    m, n = x.shape
    steps = -(-n // LANES)
    pad = torch.full((m, steps * LANES - n), fill, dtype=x.dtype)
    return torch.cat([x, pad], dim=1).view(m, steps, LANES)


# ------------------------------------------------------------ spheres
def lane_split_sweep(spheres, rays, exclude=None):
    """The sphere sweep split over 32 lanes from (BIG, NO_ID), reduced; a
    ray with no candidate below BIG reads (BIG, 0), as the kernel."""
    tcand, _ = fh.sweep_candidates(spheres, *rays, T_MIN)
    s = tcand.shape[1]
    ids = torch.arange(s, dtype=torch.int32).expand_as(tcand)
    accept = torch.ones_like(tcand, dtype=torch.bool)
    if exclude is not None:
        accept = ids != exclude[:, None]
    lt, li = lane_scan(split_by_lane(accept, False),
                       split_by_lane(tcand, BIG),
                       split_by_lane(ids, NO_ID),
                       torch.full((tcand.shape[0],), BIG))
    t, i = lex_reduce(lt, li)
    return t, torch.where(t < BIG, i, 0)


def _tie_scene():
    """A ground sphere and 40 random spheres, then copies of spheres 3, 7
    and 20 at ids that fall in another lane (+1), another 32-slot group
    (+33) and another 64-slot group (+70); 128 slots."""
    rng = np.random.default_rng(11)
    rows = [((0.0, -1000.0, 0.0), 1000.0)]
    for _ in range(40):
        rows.append(((rng.uniform(-5, 5), rng.uniform(0.3, 1.5),
                      rng.uniform(-5, 5)), rng.uniform(0.2, 0.6)))
    slots = [None] * 128
    for k, row in enumerate(rows):
        slots[k] = row
    for src in (3, 7, 20):
        for off in (1, 33, 70):
            dst = src + off
            while slots[dst] is not None:
                dst += LANES + 1
            slots[dst] = rows[src]
    b = SceneBuilder()
    filler = ((0.0, 500.0, 0.0), 0.1)     # far above everything
    for row in slots:
        c, r = row if row is not None else filler
        b.lambertian(c, r, (0.5, 0.5, 0.5))
    scene = b.build(pad_to=None, spatial_sort=False, device="cpu")
    copies = [k for k in range(128) if slots[k] is not None and k > 40]
    return scene, rng, copies


def _hollow_scene():
    """A ground sphere, 62 small spheres near the origin and, in slot 40
    (the second 32-slot group), an isolated sphere of radius -0.5 (a
    hollow sphere's inner surface) well outside the others: a box built
    from the signed radius would leave out part of it."""
    rng = np.random.default_rng(17)
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for k in range(1, 64):
        if k == 40:
            b.lambertian((5.0, 2.8, 5.0), -0.5, (0.5, 0.5, 0.5))
        else:
            b.lambertian((rng.uniform(-2, 2), rng.uniform(0.3, 1.0),
                          rng.uniform(-2, 2)), rng.uniform(0.1, 0.3),
                         (0.5, 0.5, 0.5))
    return b.build(pad_to=None, spatial_sort=False, device="cpu"), rng


def _sphere_rays(scene, rng, n, aim=None):
    """n rays from above the spheres: random directions, or aimed at the
    centres of the spheres in aim (which then tie with their copies)."""
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(2.0, 4.0, n)
    if aim is None:
        d = rng.normal(size=(n, 3)).astype(np.float32)
    else:
        c = scene.center.numpy()[rng.choice(aim, n)]
        d = (c + rng.normal(scale=0.05, size=(n, 3)) - o).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x[:, k]))
            for x in (o, d) for k in range(3)]


@pytest.fixture(scope="module")
def sphere_cases():
    book = scenes.get_scene("random", 16 / 9, device="cpu")[0]
    rng = np.random.default_rng(5)
    tie, trng, copies = _tie_scene()
    src = [3, 7, 20]
    hollow, hrng = _hollow_scene()
    return {"book_cover": (book, _sphere_rays(book, rng, 2048)),
            "ties": (tie, _sphere_rays(tie, trng, 2048, aim=src + copies)),
            "hollow": (hollow, _sphere_rays(hollow, hrng, 2048, aim=[40]))}


def _own_winner(t, idx):
    return torch.where(t < BIG, idx, -1).to(torch.int32)


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("name", ["book_cover", "ties"])
def test_lane_split_sphere_sweep_equals_sweep(sphere_cases, name, exclude):
    scene, rays = sphere_cases[name]
    spheres = fh.prep_fused_spheres(scene).spheres
    t_ref, i_ref, _ = fh._sweep(spheres, *rays, T_MIN)
    ex = _own_winner(t_ref, i_ref) if exclude else None
    if ex is not None:
        t_ref, i_ref, _ = fh._sweep(spheres, *rays, T_MIN, ex)
    t, i = lane_split_sweep(spheres, rays, ex)
    assert torch.equal(t, t_ref) and torch.equal(i, i_ref)
    if name == "book_cover":
        # Hits and misses both; with exclude, second hits behind the first.
        assert 0.1 < float((t < BIG).float().mean()) < 0.99
    else:
        # Copies tie with their source: the lowest id wins, in any lane.
        tcand, _ = fh.sweep_candidates(spheres, *rays, T_MIN)
        if ex is not None:
            rows = torch.arange(tcand.shape[1], dtype=torch.int32)
            tcand = torch.where(rows[None, :] != ex[:, None], tcand, BIG)
        ties = ((tcand == t[:, None]).sum(1) > 1) & (t < BIG)
        assert int(ties.sum()) > 100


def test_lane_split_sphere_sweep_matches_jax(sphere_cases):
    js, _ = jscenes.get_scene("random", 16 / 9)
    arrays = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js)}
    scene = scene_from_arrays(arrays, device="cpu")
    rays = sphere_cases["book_cover"][1]
    rays = [x[:1024].contiguous() for x in rays]
    want = fused_hit_pallas(js, *(jnp.asarray(x.numpy()) for x in rays),
                            jnp.ones(1024, dtype=bool), T_MIN,
                            shadow_only=True, interpret=True)
    tw, iw = np.asarray(want["t"]), np.asarray(want["idx"])
    t, i = lane_split_sweep(fh.prep_fused_spheres(scene).spheres, rays)
    t, i = t.numpy(), i.numpy()
    agree = i == iw
    assert agree.mean() >= 0.999, agree.mean()
    hit = agree & (tw < BIG)
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(t[agree & ~hit], tw[agree & ~hit])
    # The unrefined root (-b/2 -+ sqrt(disc)) / a of the expanded form: its
    # terms carry rounding of the size of their magnitudes, so t within
    # 1e-5 |t| + 32 ulps x (|b/2| + (|b/2|^2 + a M) / sqrt(disc)) / a, M the
    # magnitude of the constant term (|o|^2 + 2 |o.c| + |c|^2 + r^2).
    o = np.stack([x.numpy() for x in rays[:3]], 1)[hit].astype(np.float64)
    d = np.stack([x.numpy() for x in rays[3:]], 1)[hit].astype(np.float64)
    c = arrays["center"][iw[hit]].astype(np.float64)
    r2 = arrays["radius"][iw[hit]].astype(np.float64) ** 2
    a = np.sum(d * d, 1)
    half_b = np.abs(np.sum((o - c) * d, 1))
    mag = np.sum(o * o, 1) + 2 * np.abs(np.sum(o * c, 1)) \
        + np.sum(c * c, 1) + r2
    disc = half_b ** 2 - a * (np.sum((o - c) ** 2, 1) - r2)
    spread = half_b + (half_b ** 2 + a * mag) \
        / np.sqrt(np.maximum(disc, 1e-300))
    tol = 1e-5 * np.abs(tw[hit]) + 32 * EPS32 * spread / a
    assert np.all(np.abs(t[hit] - tw[hit]) <= tol), \
        np.max(np.abs(t[hit] - tw[hit]) / tol)


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("name", ["book_cover", "ties", "hollow"])
def test_group_gate_keeps_every_hit(sphere_cases, name, group, exclude):
    scene, rays = sphere_cases[name]
    tables = fh.prep_fused_spheres(scene)
    boxes = fh.sweep_boxes(scene.center, scene.radius, scene.active,
                           tables.spheres.shape[0], group)
    t_ref, i_ref, _ = fh._sweep(tables.spheres, *rays, T_MIN)
    ex = _own_winner(t_ref, i_ref) if exclude else None
    if ex is not None:
        t_ref, i_ref, _ = fh._sweep(tables.spheres, *rays, T_MIN, ex)
    t, i, visits = fh.sweep_gated_plain(tables.spheres, boxes, group, *rays,
                                        T_MIN, ex)
    assert torch.equal(t, t_ref) and torch.equal(i, i_ref)
    if name == "book_cover":
        # The gate does skip groups there: fewer than all on average (the
        # tie scene's groups each span the whole scene).
        assert float(visits.float().mean()) < 0.8 * boxes.shape[0]
    if name == "hollow" and not exclude:
        # Rays do reach the hollow sphere, first.
        assert int((i_ref == 40).sum()) > 100


@pytest.mark.parametrize("name", ["ties", "hollow"])
def test_group_boxes_hold_their_spheres(sphere_cases, name):
    scene, _ = sphere_cases[name]
    s = scene.center.shape[0]
    boxes = fh.sweep_boxes(scene.center, scene.radius, scene.active, s, 32)
    assert boxes.shape == (s // 32, 8)
    for k in range(s):
        if not bool(scene.active[k]):
            continue
        b = boxes[k // 32]
        c, r = scene.center[k], scene.radius[k].abs()
        assert torch.all(b[0:3] <= c - r) and torch.all(c + r <= b[4:7])
        assert float(b[3]) >= float(c.abs().sum() + r)
    # The sphere search's padding slots (past the scene) belong to no box.
    pad = fh.sweep_boxes(scene.center[:10], scene.radius[:10],
                         scene.active[:10], 64, 32)
    assert float(pad[1, 3]) == -1.0 and float(pad[0, 3]) > 0


# ------------------------------------------------------------ meshes
def warp_search(mc, rays, cap, alive, exclude=None, rowgate=False):
    """A3 as the warp-per-ray kernel runs it, in plain PyTorch: clusters in
    ascending order, each gated under the ray's cap at its turn (and under
    rowgate each of its 128-triangle rows at its turn); each visited range
    split over 32 lanes from the ray's cap, reduced, and taken when it
    beats the cap. (BIG, 0) where nothing beats t_cap and on dead lanes."""
    live = torch.nonzero(alive).squeeze(1)
    o = tuple(x[live] for x in rays[:3])
    d = tuple(x[live] for x in rays[3:])
    inv = tuple(mi.slab_inv(x) for x in d)
    ex = None if exclude is None else exclude[live]
    t_best = cap[live].clone()
    best = torch.zeros(live.shape[0], dtype=torch.int32)

    def gate(planes, j, ids):
        enter, exit_ = mi._slab(planes, j, j + 1, tuple(x[ids] for x in o),
                                tuple(x[ids] for x in inv), T_MIN)
        slack = torch.clamp_max(t_best[ids] * 1.0001 + 1e-4, 1e37)
        return ids[(exit_[:, 0] > enter[:, 0]) & (enter[:, 0] <= slack)]

    def visit(ids, p0, p1):
        t, ok = mi._sweep(mc, "vpu", tuple(x[ids][:, None] for x in o),
                          tuple(x[ids][:, None] for x in d), None, p0, p1,
                          T_MIN)
        gid = torch.arange(p0, p1, dtype=torch.int32).expand_as(t)
        if ex is not None:
            ok = ok & (gid != ex[ids][:, None])
        lt, li = lane_scan(split_by_lane(ok, False), split_by_lane(t, BIG),
                           split_by_lane(gid, NO_ID), t_best[ids])
        tr, ir = lex_reduce(lt, li)
        better = tr < t_best[ids]
        t_best[ids] = torch.where(better, tr, t_best[ids])
        best[ids] = torch.where(better, ir, best[ids])

    everyone = torch.arange(live.shape[0])
    g = mc.tris_per_cluster
    for j in range(mc.k):
        ids = gate(mc.box_planes, j, everyone)
        if not ids.shape[0]:
            continue
        if not rowgate:
            visit(ids, j * g, (j + 1) * g)
            continue
        for row in range(j * g // mi.LANE, (j + 1) * g // mi.LANE):
            ids_r = gate(mc.row_boxes, row, ids)
            if ids_r.shape[0]:
                visit(ids_r, row * mi.LANE, (row + 1) * mi.LANE)
    won = t_best < cap[live]
    t_out = torch.full(alive.shape, BIG)
    i_out = torch.zeros(alive.shape, dtype=torch.int32)
    t_out[live] = torch.where(won, t_best, BIG)
    i_out[live] = torch.where(won, best, 0)
    return t_out, i_out


@pytest.fixture(scope="module")
def mesh_cases():
    rng = np.random.default_rng(17)
    out = {}
    terrain = meshes.terrain_world(48, 48, builder="numpy", device="cpu").mesh
    cornell = meshes.cornell_box_world(builder="numpy", device="cpu").mesh
    for name, mesh, rows in (("terrain48_rows4", terrain, 4),
                             ("terrain48_rows1", terrain, 1),
                             ("cornell", cornell, 4)):
        mc = mi.prep_mesh_clusters(mesh, cluster_rows=rows)
        g, p = mc.tris_per_cluster, mesh.num_triangles
        # Copies in another lane (+1), the same lane of the next step
        # (+32), another lane further on (+45), and in another cluster (a
        # padding slot of the last one; the Cornell mesh has one cluster).
        srcs = [0, 5, 17] if name == "cornell" else [3, g + 40, 2 * g + 7]
        dsts = [p + 1, p + 32 + 5, p + 45] if name == "cornell" else \
            [srcs[0] + 1, srcs[1] + 32, mc.k * g - 3]
        mc = with_copies(mc, mesh, list(zip(srcs, dsts)))
        n = 2048
        lo, hi = mc.root_lo.numpy(), mc.root_hi.numpy()
        if name == "cornell":
            o = np.stack([rng.uniform(-0.95, 0.95, n),
                          rng.uniform(0.05, 1.95, n),
                          rng.uniform(0.8, 3.0, n)], 1).astype(np.float32)
        else:
            o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
            o[:, 1] += 1.5
        # Half the rays aimed at the copied triangles' centroids (ties).
        tp = mc.tri_planes.numpy()
        cen = (3 * tp[0:3] + tp[3:6] + tp[6:9]).T[srcs] / 3.0
        d = rng.normal(size=(n, 3)).astype(np.float32)
        aim = rng.random(n) < 0.5
        d[aim] = (cen[rng.integers(0, 3, int(aim.sum()))]
                  + rng.normal(scale=0.01, size=(int(aim.sum()), 3))
                  - o[aim])
        if name == "cornell":
            d[~aim, 2] = -np.abs(d[~aim, 2])
        rays = [torch.from_numpy(np.ascontiguousarray(x[:, a].astype(
            np.float32))) for x in (o, d) for a in range(3)]
        alive = torch.from_numpy(rng.random(n) < 0.8)
        cap = torch.from_numpy(np.where(rng.random(n) < 0.5,
                                        rng.uniform(0.3, 3.0, n),
                                        BIG).astype(np.float32))
        out[name] = (mc, rays, alive, cap, srcs)
    return out


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("visit", ["full", "rowgate"])
@pytest.mark.parametrize("name", ["terrain48_rows4", "terrain48_rows1",
                                  "cornell"])
def test_warp_split_mesh_search_equals_plain(mesh_cases, name, visit,
                                             exclude):
    mc, rays, alive, cap, srcs = mesh_cases[name]
    ex = None
    if exclude:
        t0, i0 = mi.mesh_search_plain(mc, *rays, T_MIN, alive, cap)
        ex = _own_winner(t0, i0)
    want = mi.mesh_search_plain(mc, *rays, T_MIN, alive, cap, exclude=ex)
    if visit == "rowgate":
        gated = mi.mesh_search_gated_plain(mc, *rays, T_MIN, alive, cap,
                                           visit="rowgate", exclude=ex)
        assert all(torch.equal(a, b) for a, b in zip(gated[:2], want))
    got = warp_search(mc, rays, cap, alive, ex, rowgate=visit == "rowgate")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    hits = want[0] < BIG
    assert 0.1 < float(hits[alive].float().mean()) < 0.99
    if not exclude:
        # The copies' sources win their ties.
        assert int(torch.isin(want[1][hits], torch.tensor(srcs)).sum()) > 50
