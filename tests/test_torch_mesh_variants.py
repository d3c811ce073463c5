"""The variants of the port's clustered mesh search
(qt_raytracer_tpu_torch.kernels.mesh_intersect) on the CPU: A4's second
output (``first_crossed_cluster(pair=True)``), the "crossing2" and "morton"
wavefront sort keys, the unsorted search, and the five mesh-search options of
``RenderConfig``, against the JAX package with Pallas in interpret mode, on
4,096 rays with 60% alive on terrain_world(48, 48) (9 clusters) and the true
Cornell box (1 cluster).

Tolerances: A4's outputs and the sort keys are integers built from slab
entries and exits, cell indices and sign bits, so they are bitwise. Every
sort mode, and no sort, gives a live lane the result of the default search
bit for bit: the sort only changes which rays share a block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.kernels import mesh_intersect as jmi
from qt_raytracer_tpu_torch import RenderConfig
from qt_raytracer_tpu_torch.kernels import mesh_intersect as tmi
from qt_raytracer_tpu_torch.runtime import spans
from test_torch_mesh_kernel import N, T_MIN, _cap, case  # noqa: F401
from torch_helpers import _one_thread  # noqa: F401

BIG = tmi.BIG


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's: a pool first started
    # after XLA has run was seen to take its first vectorised sqrt a few
    # 1e-5 off in one thread.
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


def _jax_pair(case, capped):
    j_cap, _ = _cap(case, capped)
    return jmi.first_crossed_cluster(
        case["jm"], *case["j_rays"], T_MIN, alive=jnp.asarray(case["alive"]),
        t_cap=j_cap, interpret=True, pair=True)


@pytest.mark.parametrize("capped", [False, True])
def test_first_crossed_cluster_pair_bitwise(case, capped):
    _, t_cap = _cap(case, capped)
    want1, want2 = map(np.asarray, _jax_pair(case, capped))
    alive = torch.from_numpy(case["alive"])
    spans.counts.clear()
    got1, got2 = tmi.first_crossed_cluster(case["mc"], *case["t_rays"], T_MIN,
                                           alive, t_cap, pair=True)
    # On the CPU the wrapper takes the plain version and counts nothing.
    assert (spans.counts["mesh_first_cluster"],
            spans.counts["mesh_first_cluster[pair]"]) == (0, 0)
    assert got1.dtype == got2.dtype == torch.int32
    np.testing.assert_array_equal(got1.numpy(), want1)
    np.testing.assert_array_equal(got2.numpy(), want2)
    k = case["mc"].k
    live = case["alive"]
    assert np.all(got2.numpy()[~live] == k)
    assert np.all((want2 > want1) | (want2 == k))
    if k > 1:
        assert (want2[live] < k).mean() > 0.2     # second crossings do occur
    else:
        assert np.all(want2 == k)
    # The first output is the plain A4; blocks do not change either.
    assert torch.equal(got1, tmi.first_crossed_cluster(
        case["mc"], *case["t_rays"], T_MIN, alive, t_cap))
    small = tmi.first_crossed_cluster_plain(
        case["mc"], *case["t_rays"], T_MIN, alive,
        torch.full((N,), BIG) if t_cap is None else t_cap, slice_rays=77,
        pair=True)
    assert torch.equal(small[0], got1) and torch.equal(small[1], got2)


def _jax_crossing2_key(case, c1, c2, alive):
    """The two-level key of mesh_search_pallas(sort_mode="crossing2"), in
    jnp, from the JAX package's (c1, c2)."""
    jm = case["jm"]
    oc, dc = case["j_rays"]
    k = jmi.num_clusters(jm.v0.shape[0])
    lo = jm.bvh_min[0]
    ext = jnp.maximum(jm.bvh_max[0] - lo, 1e-6)
    cell = [jnp.clip(((oc[a] - lo[a]) / ext[a] * 16.0).astype(jnp.int32),
                     0, 15) for a in range(3)]
    m12 = ((jmi._part1by2(cell[0]) << 2) | (jmi._part1by2(cell[1]) << 1)
           | jmi._part1by2(cell[2])) & 0xFFF
    octant = ((dc[0] < 0).astype(jnp.int32) * 4
              + (dc[1] < 0).astype(jnp.int32) * 2
              + (dc[2] < 0).astype(jnp.int32))
    key = (c1 * jnp.int32(k + 1) + c2) * jnp.int32(1 << 15) \
        + (octant << 12) + m12
    return np.asarray(jnp.where(alive, key, jnp.int32(2 ** 31 - 1)))


def test_sort_keys_bitwise(case):
    mc, rays = case["mc"], case["t_rays"]
    alive = torch.from_numpy(case["alive"])
    j_alive = jnp.asarray(case["alive"])
    # "morton": octant and Morton cell, dead rays 1 << 30.
    want = np.asarray(jmi.sort_keys(*case["j_rays"], j_alive,
                                    case["jm"].bvh_min[0],
                                    case["jm"].bvh_max[0]))
    got = tmi.sort_keys(*rays, alive, mc.root_lo, mc.root_hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # "crossing2": the first two crossed clusters above a 15-bit tiebreak.
    c1, c2 = _jax_pair(case, True)
    want2 = _jax_crossing2_key(case, c1, c2, j_alive)
    got2 = tmi.crossing2_keys(mc, *rays, alive,
                              torch.from_numpy(np.array(c1)),
                              torch.from_numpy(np.array(c2)))
    assert got2.dtype == torch.int32
    np.testing.assert_array_equal(got2.numpy(), want2)
    assert np.all(want2[~case["alive"]] == 2 ** 31 - 1)
    assert np.all(want2[case["alive"]] >= 0)
    # The permutations are the stable sorts of these keys.
    cap = torch.from_numpy(case["cap"])
    for mode, key in (("morton", got), ("crossing2", got2)):
        perm = tmi.crossing_order(mc, *rays, T_MIN, alive, cap,
                                  sort_mode=mode)
        np.testing.assert_array_equal(
            perm.numpy(), np.argsort(key.numpy(), kind="stable"))


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("mode", ["crossing2", "morton", "unsorted"])
def test_sort_modes_bitwise_on_live_lanes(case, mode, capped):
    _, t_cap = _cap(case, capped)
    alive = torch.from_numpy(case["alive"])
    kw = dict(sort=False) if mode == "unsorted" else dict(sort_mode=mode)
    ref = tmi.mesh_search(case["mc"], *case["t_rays"], T_MIN, alive=alive,
                          t_cap=t_cap)
    got = tmi.mesh_search(case["mc"], *case["t_rays"], T_MIN, alive=alive,
                          t_cap=t_cap, **kw)
    for x, y in zip(got, ref):
        assert torch.equal(x[alive], y[alive])
    assert torch.all(got[0][~alive] == BIG) and torch.all(got[1][~alive] == 0)
    assert bool((got[0][alive] < BIG).any())


def test_crossing2_against_jax_search(case):
    # The JAX package's search under its two-level key: the same winners.
    alive = case["alive"]
    tj, ij = jmi.mesh_search_pallas(
        case["jm"], *case["j_rays"], T_MIN, interpret=True,
        alive=jnp.asarray(alive), t_cap=jnp.asarray(case["cap"]),
        sort_mode="crossing2")
    tt, it = tmi.mesh_search(case["mc"], *case["t_rays"], T_MIN,
                             alive=torch.from_numpy(alive),
                             t_cap=torch.from_numpy(case["cap"]),
                             sort_mode="crossing2")
    tj, ij, tt, it = np.asarray(tj), np.asarray(ij), tt.numpy(), it.numpy()
    agree = alive & (it == ij)
    assert agree[alive].mean() >= 0.999, agree[alive].mean()
    np.testing.assert_array_equal((tt < BIG)[agree], (tj < BIG)[agree])
    hit = agree & (tj < BIG)
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=1e-3)


def test_sort_mode_refusals(case):
    mc, rays = case["mc"], case["t_rays"]
    with pytest.raises(ValueError, match="sort_mode"):
        tmi.mesh_search(mc, *rays, T_MIN, sort_mode="hilbert")
    with pytest.raises(ValueError, match="sort_mode"):
        tmi.crossing_order(mc, *rays, T_MIN, torch.ones(N, dtype=torch.bool),
                           torch.full((N,), BIG), sort_mode="hilbert")
    # The two-level key packs (c1 * (k + 1) + c2) << 15 | 15 bits into an
    # int32 below the dead rays' 2^31 - 1: up to k = 254.
    top = lambda k: (k * (k + 1) + k) << 15 | 0x7FFF
    assert top(254) < 2 ** 31 - 1 <= top(255)
    big = mc._replace(k=255, box_planes=torch.zeros((6, 256)),
                      tri_planes=torch.zeros((9, 255 * mc.tris_per_cluster)),
                      group_boxes=torch.zeros((6, tmi.num_groups(255))))
    with pytest.raises(ValueError, match="254"):
        tmi.mesh_search(big, *rays, T_MIN, sort_mode="crossing2")
    # The limit is checked where the key is built: 254 clusters take it
    # (the permutation alone, not a sweep of 254 clusters of padding).
    ok = big._replace(k=254,
                      group_boxes=torch.zeros((6, tmi.num_groups(254))))
    perm = tmi.crossing_order(ok, *rays, T_MIN,
                              torch.ones(N, dtype=torch.bool),
                              torch.full((N,), BIG), sort_mode="crossing2")
    assert perm.shape == (N,)


OPTION_DEFAULTS = dict(mesh_kernel="clustered", mesh_pair_c=6,
                       mesh_compact=False, mesh_sort0=True,
                       mesh_sort_mode="crossing")


@pytest.mark.parametrize("field,good,bad", [
    ("mesh_kernel", ["clustered", "pairs", "hybrid"], ["pair", "", None, 1]),
    ("mesh_pair_c", [1, 6, 64], [0, -1, 2.5, "6", True]),
    ("mesh_compact", [True, False], [1, "1", None]),
    ("mesh_sort0", [True, False], [0, "0", None]),
    ("mesh_sort_mode", ["crossing", "crossing2", "morton"],
     ["fused", "", None]),
])
def test_render_config_mesh_options(field, good, bad):
    cfg = RenderConfig()
    assert getattr(cfg, field) == OPTION_DEFAULTS[field]
    for value in good:
        assert getattr(RenderConfig(**{field: value}), field) == value
        assert getattr(dataclasses.replace(cfg, **{field: value}),
                       field) == value
    for value in bad:
        with pytest.raises(ValueError, match=field):
            RenderConfig(**{field: value})
    hash(RenderConfig(**{field: good[-1]}))       # still hashable
