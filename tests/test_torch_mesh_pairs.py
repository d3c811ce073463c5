"""The pair-wavefront mesh search of the port
(qt_raytracer_tpu_torch.kernels.mesh_pairs: A7 crossing_lists, A8 pair_hits,
the slot maps and mesh_search_pairs) on the CPU, through the plain versions,
against the port's own clustered search and against the JAX package with its
Pallas kernels in interpret mode, on 4,096 rays with 60% alive on
terrain_world(48, 48) (9 clusters) and the true Cornell box (1 cluster).

Tolerances. A7's lists and counts and the slot maps are integers: bitwise.
The pair search equals the port's clustered search bit for bit on live lanes
for any budget (both take one slab test and one Moller-Trumbore), and gives
(BIG, 0) on dead lanes. Against the JAX pair search the winner ids are equal
on every live lane and t lies within the rule of
tests/test_torch_mesh_kernel.py (rtol 1e-5 widened by 32 ulps times the
condition number of t): XLA:CPU contracts some multiply-adds that the port
rounds one by one. The slot maps are held against the ray_buf and gmap that
the JAX package's own mesh_search_pairs hands its pair kernel, read off at
its pallas_call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.kernels import mesh_pairs as jmp
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu_torch.core.world import search_mesh
from qt_raytracer_tpu_torch.kernels import mesh_intersect as tmi
from qt_raytracer_tpu_torch.kernels import mesh_pairs as tmp
from qt_raytracer_tpu_torch.runtime import spans
from qt_raytracer_tpu_torch.utils.convert import mesh_from_arrays
from test_torch_mesh_kernel import _arrays, _mt_rtol, _rays
from torch_helpers import _one_thread  # noqa: F401

N = 4096
T_MIN = 1e-3
BIG = tmi.BIG
LANE = 128


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's: a pool first started
    # after XLA has run was seen to take its first vectorised sqrt a few
    # 1e-5 off in one thread.
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


@pytest.fixture(scope="module", params=["terrain48", "cornell"])
def case(request):
    name = request.param
    jw = (jmeshes.terrain_world(48, 48, builder="numpy") if name == "terrain48"
          else jmeshes.cornell_box_world(builder="numpy"))
    jm = jw.mesh
    rng = np.random.default_rng(11)
    o, d = _rays(name, np.asarray(jm.bvh_min[0]), np.asarray(jm.bvh_max[0]),
                 rng)
    alive = rng.random(N) < 0.6
    cap = np.where(rng.random(N) < 0.5, rng.uniform(0.3, 3.0, N),
                   BIG).astype(np.float32)
    mc = tmi.prep_mesh_clusters(mesh_from_arrays(_arrays(jm), device="cpu"))
    comps = [np.ascontiguousarray(x[:, a]) for x in (o, d) for a in range(3)]
    return dict(name=name, jm=jm, mc=mc, o=o, d=d, alive=alive, cap=cap,
                j_rays=(tuple(map(jnp.asarray, comps[:3])),
                        tuple(map(jnp.asarray, comps[3:]))),
                t_rays=[torch.from_numpy(c) for c in comps])


def _masks(case, masked):
    """(jax alive, jax cap, torch alive, torch cap, numpy alive)."""
    if not masked:
        return None, None, None, None, np.ones(N, bool)
    return (jnp.asarray(case["alive"]), jnp.asarray(case["cap"]),
            torch.from_numpy(case["alive"]), torch.from_numpy(case["cap"]),
            case["alive"])


def _widths(k):
    return sorted({1, min(4, k), k})


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [0, 1, 2])
def test_crossing_lists_bitwise(case, width, masked):
    widths = _widths(case["mc"].k)        # one cluster has one list width
    c_max = widths[min(width, len(widths) - 1)]
    ja, jc, ta, tc, live = _masks(case, masked)
    want_l, want_n = jmp.crossing_lists(case["jm"], *case["j_rays"], T_MIN,
                                        alive=ja, t_cap=jc, c_max=c_max,
                                        interpret=True)
    got_l, got_n = tmp.crossing_lists(case["mc"], *case["t_rays"], T_MIN, ta,
                                      tc, c_max)
    assert got_l.dtype == got_n.dtype == torch.int32
    assert got_l.shape == (N, c_max)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    k = case["mc"].k
    assert np.all(got_l.numpy()[~live] == k) and np.all(got_n.numpy()[~live] == 0)
    assert (got_n.numpy()[live] > 0).mean() > 0.3       # the gate does pass
    # Ascending, each id once, k after the last.
    l = got_l.numpy().astype(np.int64)
    assert np.all((np.diff(l, axis=1) > 0) | (l[:, 1:] == k))
    np.testing.assert_array_equal((l < k).sum(1),
                                  np.minimum(got_n.numpy(), c_max))


def test_crossing_lists_plain_blocks_and_refusals(case):
    mc, rays = case["mc"], case["t_rays"]
    alive, cap = torch.from_numpy(case["alive"]), torch.from_numpy(case["cap"])
    c_max = min(4, mc.k)
    ref = tmp.crossing_lists_plain(mc, *rays, T_MIN, alive, cap, c_max)
    small = tmp.crossing_lists_plain(mc, *rays, T_MIN, alive, cap, c_max,
                                     slice_rays=77)
    assert torch.equal(ref[0], small[0]) and torch.equal(ref[1], small[1])
    # The first two list entries are A4's pair.
    c1, c2 = tmi.first_crossed_cluster(mc, *rays, T_MIN, alive, cap, pair=True)
    assert torch.equal(ref[0][:, 0], c1)
    if c_max > 1:
        assert torch.equal(ref[0][:, 1], c2)
    lo, hi, k = tmp.cluster_bounds(mc)
    assert lo.shape == hi.shape == (k, 3) and bool((hi > lo).all())
    for bad in (0, mc.k + 1):
        with pytest.raises(ValueError, match="c_max"):
            tmp.crossing_lists(mc, *rays, T_MIN, c_max=bad)
    with pytest.raises(ValueError, match="pair_c"):
        tmp.mesh_search_pairs(mc, *rays, T_MIN, pair_c=0)
    with pytest.raises(ValueError, match="mesh_kernel"):
        search_mesh(mc, *rays, T_MIN, alive, cap, mesh_kernel="bvh")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tmp.crossing_lists(mc._replace(tri_planes=mc.tri_planes.to("meta"),
                                       box_planes=mc.box_planes.to("meta"),
                                       group_boxes=mc.group_boxes.to("meta")),
                           *(r.to("meta") for r in rays), T_MIN, c_max=1)


PAIR_CASES = {
    "default": (False, {}),
    "budget1024": (False, dict(pair_budget=1024)),   # C = 1: most overflow
    "alive_caps": (True, {}),
    "alive_caps_c2": (True, dict(pair_c=2)),
}


@pytest.mark.parametrize("which", sorted(PAIR_CASES))
def test_pair_search_equals_clustered_search_bitwise(case, which):
    masked, kw = PAIR_CASES[which]
    _, _, ta, tc, live = _masks(case, masked)
    mc, rays = case["mc"], case["t_rays"]
    ref = tmi.mesh_search(mc, *rays, T_MIN, alive=ta, t_cap=tc)
    spans.counts.clear()
    got = tmp.mesh_search_pairs(mc, *rays, T_MIN, ta, tc, **kw)
    # On the CPU the wrappers take the plain versions and count nothing.
    assert (spans.counts["mesh_search"], spans.counts["mesh_crossing_lists"],
            spans.counts["mesh_pairs"]) == (0, 0, 0)
    live_t = torch.from_numpy(live)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert torch.equal(got[0][live_t], ref[0][live_t])
    assert torch.equal(got[1][live_t], ref[1][live_t])
    assert torch.all(got[0][~live_t] == BIG) and torch.all(got[1][~live_t] == 0)
    hit = got[0] < BIG
    assert 0.1 < float(hit[live_t].float().mean()) < 0.9
    if masked:          # every reported hit strictly beats its cap
        assert bool((got[0][hit] < tc[hit]).all())
    if which == "budget1024" and mc.k > 1:
        _, ncross = tmp.crossing_lists(mc, *rays, T_MIN, ta, tc, 1)
        assert float((ncross > 1).float().mean()) > 0.2   # the fallback runs


def test_pair_search_all_dead(case):
    dead = torch.zeros(N, dtype=torch.bool)
    t, i = tmp.mesh_search_pairs(case["mc"], *case["t_rays"], T_MIN, dead)
    assert torch.all(t == BIG) and torch.all(i == 0)
    lists, ncross = tmp.crossing_lists(case["mc"], *case["t_rays"], T_MIN,
                                       dead, c_max=1)
    ray_buf, gmap = tmp.pair_slots(lists, case["mc"].k)
    assert torch.all(ray_buf == -1) and torch.all(ncross == 0)
    assert torch.all(gmap == case["mc"].k - 1)


@pytest.mark.parametrize("masked", [False, True])
def test_pair_search_matches_jax(case, masked, monkeypatch):
    ja, jc, ta, tc, live = _masks(case, masked)
    tj, ij = jmp.mesh_search_pairs(case["jm"], *case["j_rays"], T_MIN,
                                   interpret=True, alive=ja, t_cap=jc)
    tj, ij = np.asarray(tj), np.asarray(ij)
    tt, it = tmp.mesh_search_pairs(case["mc"], *case["t_rays"], T_MIN, ta, tc)
    # With the kernel's per-pair row gate, run in plain PyTorch, in place of
    # the pair sweep: the same bits on every lane.
    monkeypatch.setattr(tmp, "pair_hits", lambda mc, *a, interpret=False:
                        tmp.pair_hits_gated_plain(mc, *a)[:2])
    tg, ig = tmp.mesh_search_pairs(case["mc"], *case["t_rays"], T_MIN, ta, tc)
    assert torch.equal(tg, tt) and torch.equal(ig, it)
    tt, it = tt.numpy(), it.numpy()
    np.testing.assert_array_equal(it[live], ij[live])
    hit = live & (tj < BIG)
    np.testing.assert_array_equal(tt[live & (tj >= BIG)],
                                  tj[live & (tj >= BIG)])
    lanes = np.nonzero(hit)[0]
    assert lanes.size > 0.1 * live.sum()
    rtol = _mt_rtol(case, lanes, ij[lanes])
    err = np.abs(tt[lanes].astype(np.float64) - tj[lanes])
    assert np.all(err <= rtol * np.abs(tj[lanes])), \
        np.max(err / (rtol * np.abs(tj[lanes])))
    if masked:
        cap = case["cap"]
        assert np.all(tt[tt < BIG] < cap[tt < BIG])


class _PallasTap:
    """Stands in for the `pl` of the JAX module: pallas_call records the
    slot tables its kernel is handed and answers misses; the rest is pl."""

    def __init__(self, real, seen):
        self._real, self._seen = real, seen

    def __getattr__(self, name):
        return getattr(self._real, name)

    def pallas_call(self, kernel, *, out_shape, **_):
        def run(gmap, ox, *rest):
            # Operands: gmap, the 7 gathered ray planes, the valid plane.
            self._seen.update(gmap=np.asarray(gmap), ox=np.asarray(ox),
                              valid=np.asarray(rest[6]))
            return (jnp.full(out_shape[0].shape, BIG, out_shape[0].dtype),
                    jnp.zeros(out_shape[1].shape, out_shape[1].dtype))
        return run


def _jax_slots(monkeypatch, jm, lists, k):
    """ray_buf and gmap as the JAX package's mesh_search_pairs builds them
    from the given crossing lists: its own glue runs, untraced, with the
    lists put in place of its A7 and the operands of its pair kernel read
    at the pallas_call. Each ray's origin x is its own id, so the gathered
    x plane spells the ray ids of the valid slots."""
    n = lists.shape[0]
    seen = {}
    clus = jnp.asarray(lists.numpy())
    ncross = jnp.asarray((lists < k).sum(dim=1).to(torch.int32).numpy())
    miss = (jnp.full((n,), BIG, jnp.float32), jnp.zeros((n,), jnp.int32))
    monkeypatch.setattr(jmp, "crossing_lists", lambda *a, **kw: (clus, ncross))
    monkeypatch.setattr(jmp, "mesh_search_pallas", lambda *a, **kw: miss)
    monkeypatch.setattr(jmp, "pl", _PallasTap(jmp.pl, seen))
    ids = jnp.arange(n, dtype=jnp.float32)
    zero, one = jnp.zeros((n,), jnp.float32), jnp.ones((n,), jnp.float32)
    with jax.disable_jit():
        jmp.mesh_search_pairs(jm, (ids, zero, zero), (one, zero, zero), T_MIN,
                              interpret=True, pair_budget=lists.shape[1] * n)
    valid = seen["valid"].reshape(-1) != 0
    ray_buf = np.where(valid, seen["ox"].reshape(-1).astype(np.int64), -1)
    return ray_buf, seen["gmap"]


@pytest.mark.parametrize("c_max", [1, 4])
def test_slot_maps_match_jax(case, c_max, monkeypatch):
    # The cluster-major padded slots: ray_buf and gmap, integers, bitwise;
    # with empty clusters (their start coincides with the next one's) and
    # the k-keyed records of short lists.
    mc = case["mc"]
    c_max = min(c_max, mc.k)
    lists, _ = tmp.crossing_lists(mc, *case["t_rays"], T_MIN,
                                  torch.from_numpy(case["alive"]),
                                  torch.from_numpy(case["cap"]), c_max)
    if mc.k > 1:
        # Empty two clusters, the first and one in the middle.
        lists = torch.where((lists == 0) | (lists == 4), mc.k, lists)
        lists = torch.sort(lists, dim=1).values
    want_buf, want_gmap = _jax_slots(monkeypatch, case["jm"], lists, mc.k)
    ray_buf, gmap = tmp.pair_slots(lists.contiguous(), mc.k)
    np.testing.assert_array_equal(ray_buf.numpy(), want_buf)
    np.testing.assert_array_equal(gmap.numpy(), want_gmap)
    assert gmap.dtype == torch.int32 and ray_buf.shape[0] % 1024 == 0
    # Within a cluster's run the pairs stay ray-ascending.
    valid = ray_buf >= 0
    assert int(valid.sum()) == int((lists < mc.k).sum()) > 0
    tiles = ray_buf.view(-1, LANE)
    same = gmap[1:] == gmap[:-1]
    first, last = tiles[1:, 0], tiles[:-1, -1]
    both = same & (first >= 0) & (last >= 0)
    assert bool((first[both] > last[both]).all())


def test_pair_kernel_plain_blocks_and_invalid_slots(case):
    mc, rays = case["mc"], case["t_rays"]
    alive, cap = torch.from_numpy(case["alive"]), torch.from_numpy(case["cap"])
    lists, _ = tmp.crossing_lists(mc, *rays, T_MIN, alive, cap, min(4, mc.k))
    ray_buf, gmap = tmp.pair_slots(lists, mc.k)
    valid = ray_buf >= 0
    ref = tmp.pair_hits(mc, *rays, cap, ray_buf, gmap, T_MIN)
    small = tmp.pair_hits_plain(mc, *rays, cap, ray_buf, gmap, T_MIN,
                                slice_tiles=3)
    assert torch.equal(ref[0], small[0]) and torch.equal(ref[1], small[1])
    assert torch.all(ref[0][~valid] == BIG) and torch.all(ref[1][~valid] == 0)
    won = ref[0] < BIG
    assert bool(won.any()) and bool((ref[0][won] < cap[ray_buf[won]]).all())
    # Each winner lies in its tile's cluster.
    g = mc.tris_per_cluster
    tile_of = torch.arange(ray_buf.shape[0]) // LANE
    assert torch.equal(ref[1][won] // g, gmap[tile_of[won]])
    with pytest.raises(ValueError, match="multiple of"):
        tmp.pair_hits(mc, *rays, cap, ray_buf[:100], gmap[:1], T_MIN)
    with pytest.raises(ValueError, match="gmap"):
        tmp.pair_hits(mc, *rays, cap, ray_buf, gmap.long(), T_MIN)
    with pytest.raises(ValueError, match="ray_buf"):
        tmp.pair_hits(mc, *rays, cap, ray_buf.to(torch.int32), gmap, T_MIN)
