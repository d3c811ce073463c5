"""Plain version of the cluster-culled sphere search (kernel A6,
qt_raytracer_tpu_torch.kernels.sphere_intersect) on the CPU: against the JAX
package's Pallas kernel in interpret mode at 1,024 slots (16 chunks) and at
1,061 random spheres padded to 1,152 slots (18 chunks), against the port's
own monolithic sweep (A5) on the same table, and against the JAX package's
portable [N,S] search.

The port keeps the TPU kernel's gate and its granularity: a 128-ray row
sweeps a 64-sphere Morton chunk when some live lane's slab test crosses the
chunk's AABB. So the winners agree with the Pallas kernel lane for lane:
hit flags on every live lane, ids on at least 99.9% (a tie or an ulp at a
box face can move one), t within rtol 1e-5 plus 32 ulps of the error bound
of the expanded-form roots where the ids agree (XLA:CPU contracts
multiply-adds that PyTorch rounds one by one). Against the monolithic sweep
the clustered one is bitwise: a sphere that a ray hits lies inside its
chunk's box, so the gate never drops a winner. Against the [N,S] search the
standard is the JAX package's own (tests/test_kernels.py): hit flags equal,
ids agree on more than 99.9% of hits. Dead lanes read (BIG, 0) in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import SceneBuilder as JSceneBuilder
from qt_raytracer_tpu.core.intersect import intersect_spheres as j_isect
from qt_raytracer_tpu.kernels import sphere_intersect as jsi
from qt_raytracer_tpu_torch.core.intersect import intersect_spheres
from qt_raytracer_tpu_torch.kernels import sphere_intersect as tsi
from qt_raytracer_tpu_torch.runtime import spans
from qt_raytracer_tpu_torch.utils.convert import scene_from_arrays
from test_torch_sphere_search import _t_tol
from torch_helpers import _one_thread  # noqa: F401

N = 640                 # 5 rows of 128 rays
DEAD_ROW = 2            # lanes 256..383
T_MIN = 1e-3
BIG = tsi.BIG


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


def _scene(num_spheres, pad_to, seed=9):
    """Random Lambertian spheres in a 20-unit cube, Morton-ordered at
    build (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    b = JSceneBuilder()
    for _ in range(num_spheres):
        b.lambertian(rng.uniform(-10, 10, 3), rng.uniform(0.05, 0.4),
                     (0.5, 0.5, 0.5))
    return b.build(pad_to=pad_to)


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    alive = rng.random(N) >= 0.15
    alive[DEAD_ROW * 128:(DEAD_ROW + 1) * 128] = False
    return o, d, alive


@pytest.fixture(scope="module", params=[(1024, None), (1061, 128)],
                ids=["1024_slots", "1061_pad_1152"])
def case(request):
    num, pad_to = request.param
    js = _scene(num, pad_to)
    ts = scene_from_arrays(_arrays(js), device="cpu")
    o, d, alive = _rays(seed=num)
    return dict(js=js, ts=ts, o=o, d=d, alive=alive,
                to=torch.from_numpy(o), td=torch.from_numpy(d),
                talive=torch.from_numpy(alive))


def test_clustered_search_matches_pallas_interpret(case):
    c = case
    tables = tsi.prep_sphere_search(c["ts"])
    assert tables.boxes is not None
    assert tables.num_chunks == c["ts"].num_spheres // 64 >= 16
    jt, ji = jsi.sphere_search_pallas(
        c["js"], jnp.asarray(c["o"]), jnp.asarray(c["d"]), T_MIN,
        interpret=True, alive=jnp.asarray(c["alive"]))
    jt, ji = np.asarray(jt), np.asarray(ji)
    a5_a6 = ("sphere_search", "sphere_search_clustered")
    before = tuple(spans.counts[k] for k in a5_a6)
    tt, ti = tsi.sphere_search(c["ts"], c["to"], c["td"], T_MIN,
                               alive=c["talive"])
    assert tuple(spans.counts[k] for k in a5_a6) == before   # CPU: plain
    assert tt.dtype == torch.float32 and ti.dtype == torch.int32
    # The kernel's gates (the row's chunk mask, then the group gate), run in
    # plain PyTorch, give the same bits on every lane.
    rays = [x[:, k].contiguous() for x in (c["to"], c["td"]) for k in range(3)]
    gated = tsi.sphere_search_clustered_gated_plain(tables, *rays,
                                                    c["talive"], T_MIN)
    assert torch.equal(gated[0], tt) and torch.equal(gated[1], ti)
    tt, ti = tt.numpy(), ti.numpy()
    live = c["alive"]
    np.testing.assert_array_equal((tt < BIG)[live], (jt < BIG)[live])
    assert 0.05 < (jt < BIG)[live].mean() < 0.95     # hits and misses
    assert ((ti == ji)[live]).mean() >= 0.999
    hit = live & (ti == ji) & (jt < BIG)
    arr = _arrays(c["js"])
    tol = _t_tol(c["o"][hit], c["d"][hit], arr["center"][ji[hit]],
                 arr["radius"][ji[hit]], jt[hit])
    err = np.abs(tt[hit].astype(np.float64) - jt[hit])
    assert (err <= tol).all(), (err / tol).max()
    # Dead lanes: (BIG, 0) in the port; the TPU kernel agrees on dead rows.
    assert (tt[~live] == BIG).all() and (ti[~live] == 0).all()
    row = slice(DEAD_ROW * 128, (DEAD_ROW + 1) * 128)
    assert (jt[row] == BIG).all() and (ji[row] == 0).all()
    assert (ti < c["ts"].num_spheres).all()


def test_box_table_is_the_tpu_kernels(case):
    (_, _, _, _), boxes, k = jsi.prep_spheres(case["js"])
    tables = tsi.prep_sphere_search(case["ts"])
    assert tables.num_chunks == k
    want = np.concatenate([np.asarray(b).T for b in boxes])      # [6, K_pad]
    np.testing.assert_array_equal(tables.chunk_boxes.numpy(), want)
    # A chunk without an active sphere has the empty box (BIG, -BIG).
    active = _arrays(case["js"])["active"].reshape(-1, 64).any(axis=1)
    assert (tables.chunk_boxes[0, :k].numpy()[~active] == BIG).all()
    assert (tables.chunk_boxes[3, :k].numpy()[~active] == -BIG).all()
    assert (tables.chunk_boxes[0, k:].numpy() == BIG).all()


def test_clustered_equals_monolithic_sweep(case):
    # The gate never drops a winner: bit for bit the monolithic sweep of
    # the same table (the clustered threshold raised past this scene).
    c = case
    clustered = tsi.sphere_search(c["ts"], c["to"], c["td"], T_MIN,
                                  alive=c["talive"])
    mono = tsi.sphere_search(c["ts"], c["to"], c["td"], T_MIN,
                             alive=c["talive"], min_chunks=10 ** 6)
    for a, b in zip(clustered, mono):
        assert torch.equal(a, b)


def test_gate_closes_chunks_for_a_coherent_row(case):
    # A row of rays through one pinhole into a narrow cone crosses few of
    # the Morton chunks' boxes; a row of random rays crosses them all. The
    # count is what the card's bound of A6 is computed from.
    c = case
    tables = tsi.prep_sphere_search(c["ts"])
    rng = np.random.default_rng(2)
    o = np.tile(np.float32([[5.0, 5.0, 14.0]]), (128, 1))
    d = np.float32([[0.0, 0.0, -1.0]]) \
        + rng.uniform(-0.05, 0.05, (128, 3)).astype(np.float32)
    rays = [torch.from_numpy(np.ascontiguousarray(x[:, k]))
            for x in (o, d) for k in range(3)]
    live = torch.ones(128, dtype=torch.bool)
    gate = tsi.chunk_gate(tables, *rays, live, T_MIN)
    assert gate.shape == (1, tables.num_chunks)
    assert 0 < int(gate.sum()) <= 0.6 * tables.num_chunks
    t, idx = tsi.sphere_search_clustered_plain(tables, *rays, live, T_MIN)
    mono = tsi.sphere_search_plain(tables, *rays, live, T_MIN)
    assert torch.equal(t, mono[0]) and torch.equal(idx, mono[1])
    assert bool((t < BIG).any())


def test_lowered_threshold_reaches_the_clustered_sweep_on_a_small_scene():
    # min_chunks is the test's way to the clustered sweep without 1,024
    # spheres: 150 spheres in 3 chunks, one of them half empty.
    js = _scene(150, 64, seed=3)
    ts = scene_from_arrays(_arrays(js), device="cpu")
    o, d, alive = _rays(seed=5)
    to, td, ta = (torch.from_numpy(x) for x in (o, d, alive))
    assert tsi.prep_sphere_search(ts).num_chunks == 0
    tables = tsi.prep_sphere_search(ts, min_chunks=1)
    assert tables.num_chunks == 3 and tables.chunk_boxes.shape == (6, 8)
    assert tables.boxes.shape == (192 // tsi.GROUP_S, 8)
    a = tsi.sphere_search(ts, to, td, T_MIN, alive=ta, min_chunks=1)
    b = tsi.sphere_search(ts, to, td, T_MIN, alive=ta)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # Slices of whole rows do not change the result.
    rays = [x[:, k].contiguous() for x in (to, td) for k in range(3)]
    small = tsi.sphere_search_clustered_plain(tables, *rays, ta, T_MIN,
                                              slice_rays=256)
    for x, y in zip(a, small):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="multiple of 128"):
        tsi.sphere_search_clustered_plain(tables, *rays, ta, T_MIN,
                                          slice_rays=100)


def test_ragged_wavefront_and_all_dead(case):
    # N = 333 is not a multiple of the 128-ray row; every lane dead gives
    # (BIG, 0) without a search.
    c = case
    n = 333
    a = tsi.sphere_search(c["ts"], c["to"][:n], c["td"][:n], T_MIN,
                          alive=c["talive"][:n])
    b = tsi.sphere_search(c["ts"], c["to"][:n], c["td"][:n], T_MIN,
                          alive=c["talive"][:n], min_chunks=10 ** 6)
    for x, y in zip(a, b):
        assert x.shape == (n,) and torch.equal(x, y)
    dead = torch.zeros(N, dtype=torch.bool)
    t, idx = tsi.sphere_search(c["ts"], c["to"], c["td"], T_MIN, alive=dead)
    assert bool((t == BIG).all()) and bool((idx == 0).all())


def test_intersect_spheres_matches_the_xla_search(case):
    # Through core.intersect: the refined hit of the clustered search
    # against the JAX package's portable [N,S] search, at its own standard.
    c = case
    hx = j_isect(c["js"], jnp.asarray(c["o"]), jnp.asarray(c["d"]), T_MIN,
                 backend="xla")
    got = intersect_spheres(c["ts"], c["to"], c["td"], T_MIN,
                            backend="pallas")
    hit_x = np.asarray(hx.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit_x)
    np.testing.assert_allclose(got.t.numpy()[hit_x], np.asarray(hx.t)[hit_x],
                               rtol=2e-3, atol=1e-4)
    same = got.prim_idx.numpy() == np.asarray(hx.prim_idx)
    assert same[hit_x].mean() > 0.999


def test_exclude_raises_on_the_clustered_sweep(case):
    none = torch.full((N,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="clustered"):
        tsi.sphere_search(case["ts"], case["to"], case["td"], T_MIN,
                          exclude=none)
    with pytest.raises(ValueError, match="clustered"):
        intersect_spheres(case["ts"], case["to"], case["td"], T_MIN,
                          exclude=none)
