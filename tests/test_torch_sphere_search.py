"""Plain version of the sphere search (kernel A5,
qt_raytracer_tpu_torch.kernels.sphere_intersect) against the JAX package's
Pallas kernel in interpret mode, on 333 rays (not a multiple of the TPU's
128-ray rows): camera rays and random origin/direction pairs, with a fully
dead 128-ray row and scattered dead lanes in live rows.

Tolerances. Hit flags agree on every live lane and winner ids on at least
99.9%. On live lanes with the same winner the unrefined sweep t agrees
within rtol 1e-5 plus 32 ulps of its error bound: the expanded form
|o|^2 - 2 o.c + |c|^2 - r^2 and o.d - c.d round differently under XLA:CPU's
contracted multiply-adds, and the discriminant amplifies that where it is
small (grazing hits, the r = 1000 ground and wall spheres). Dead lanes read
(BIG, 0) in the port, which gates each lane; the TPU kernel gates rows and
gives (BIG, 0) on fully dead rows only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.core import camera as jcam
from qt_raytracer_tpu.kernels.sphere_intersect import sphere_search_pallas
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch.core.intersect import sphere_hit_ts
from qt_raytracer_tpu_torch.core.scene import SceneBuilder
from qt_raytracer_tpu_torch.kernels import sphere_intersect as tsi
from qt_raytracer_tpu_torch.runtime import spans
from qt_raytracer_tpu_torch.utils.convert import scene_from_arrays

N = 333
DEAD_ROW = 1            # lanes 128..255
T_MIN = 1e-3
EPS32 = 2.0 ** -24
BIG = tsi.BIG


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _rays(jc, seed):
    rng = np.random.default_rng(seed)
    half = N // 2
    s, t, u1, u2 = rng.random((4, half), dtype=np.float32)
    co, cd = jcam.get_rays(jc, *map(jnp.asarray, (s, t, u1, u2)))
    ro = rng.uniform(-3.0, 3.0, (N - half, 3)).astype(np.float32)
    ro[:, 1] = rng.uniform(0.01, 1.9, N - half)
    rd = rng.normal(size=(N - half, 3)).astype(np.float32)
    o = np.concatenate([np.asarray(co), ro])
    d = np.concatenate([np.asarray(cd), rd])
    alive = rng.random(N) >= 0.15
    alive[DEAD_ROW * 128:(DEAD_ROW + 1) * 128] = False
    return o, d, alive


def _t_tol(o, d, c, r, t):
    """Per-lane tolerance of the unrefined t: 1e-5 |t| + 32 ulps of the
    rounding error bound of the expanded-form roots."""
    o, d, c, r, t = (np.asarray(x, np.float64) for x in (o, d, c, r, t))
    a = np.sum(d * d, axis=1)
    od, cd, oc = (np.sum(x * y, axis=1) for x, y in ((o, d), (c, d), (o, c)))
    half_b = od - cd
    cterm = np.sum(o * o, axis=1) - 2 * oc + np.sum(c * c, axis=1) - r * r
    sq = np.sqrt(np.maximum(half_b * half_b - a * cterm, 1e-300))
    err_hb = np.abs(od) + np.abs(cd)
    err_ct = np.sum(o * o, axis=1) + 2 * np.abs(oc) + np.sum(c * c, axis=1) \
        + r * r
    err_t = (err_hb * (1 + np.abs(half_b) / sq)
             + (a * err_ct + half_b * half_b) / (2 * sq)) / a
    return 1e-5 * np.abs(t) + 32 * EPS32 * err_t


@pytest.mark.parametrize("name", ["random", "cornell", "three_sphere"])
def test_plain_search_matches_pallas_interpret(name):
    js, jc = jscenes.get_scene(name, 16 / 9)
    o, d, alive = _rays(jc, seed=len(name))
    jt, ji = sphere_search_pallas(js, jnp.asarray(o), jnp.asarray(d), T_MIN,
                                  interpret=True, alive=jnp.asarray(alive))
    jt, ji = np.asarray(jt), np.asarray(ji)
    before = spans.counts["sphere_search"]
    tt, ti = tsi.sphere_search(scene_from_arrays(_arrays(js), device="cpu"),
                               torch.from_numpy(o), torch.from_numpy(d),
                               T_MIN, alive=torch.from_numpy(alive))
    assert spans.counts["sphere_search"] == before   # CPU tensors: plain
    assert tt.dtype == torch.float32 and ti.dtype == torch.int32
    tt, ti = tt.numpy(), ti.numpy()

    live = alive
    np.testing.assert_array_equal((tt < BIG)[live], (jt < BIG)[live])
    assert 0.3 < (jt < BIG)[live].mean()
    agree = (ti == ji)[live]
    assert agree.mean() >= 0.999, agree.mean()
    hit = live & (ti == ji) & (jt < BIG)
    k = ji[hit]
    tol = _t_tol(o[hit], d[hit], _arrays(js)["center"][k],
                 _arrays(js)["radius"][k], jt[hit])
    err = np.abs(tt[hit].astype(np.float64) - jt[hit])
    assert (err <= tol).all(), (err / tol).max()
    # Dead lanes: (BIG, 0) in the port; the TPU kernel agrees on dead rows.
    assert (tt[~alive] == BIG).all() and (ti[~alive] == 0).all()
    row = slice(DEAD_ROW * 128, (DEAD_ROW + 1) * 128)
    assert (jt[row] == BIG).all() and (ji[row] == 0).all()


def test_plain_search_is_the_argmin_of_the_ns_form():
    # The [N,S] search of intersect.sphere_hit_ts is an independent
    # implementation of the same sweep: same winners, same hit flags.
    scene = SceneBuilder() \
        .lambertian((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5)) \
        .lambertian((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3)) \
        .metal((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2)) \
        .dielectric((-1.0, 0.0, -1.0), 0.5) \
        .emissive((0.0, 2.0, -1.0), 0.3, (4.0, 4.0, 4.0)) \
        .build(pad_to=8, device="cpu")
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.uniform(-2, 2, (N, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    t, idx = tsi.sphere_search(scene, o, d, T_MIN)
    ts = sphere_hit_ts(scene, o, d, T_MIN)
    want_t, want_idx = ts.min(dim=1)
    hit = want_t < BIG
    assert torch.equal(t < BIG, hit) and 0.2 < float(hit.float().mean())
    assert float((idx == want_idx.to(torch.int32))[hit].float().mean()) \
        >= 0.999
    assert bool((idx[~hit] == 0).all())


def test_table_is_the_tpu_kernels_padded_table():
    scene = scene_from_arrays(_arrays(jscenes.get_scene("three_sphere",
                                                         1.0)[0]),
                                                                 device="cpu")
    small = dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name)[:5] for f in dataclasses.fields(scene)
        if f.name != "light_idx"})
    rows = tsi.prep_sphere_search(small)
    assert rows.spheres.shape == (64, 4) and rows.num_spheres == 5
    assert bool((rows.spheres[5:, :3] == 1e9).all())
    assert bool((rows.spheres[5:, 3] == BIG).all())
    assert bool((rows.spheres[:5][~small.active, 3] >= BIG / 2).all())
    # A padding slot never wins, and an id past the scene reads back as 0.
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    t, idx = tsi.sphere_search(small, o, d, T_MIN, interpret=True)
    assert bool((idx < 5).all())


def test_unported_options_raise():
    # What the sphere search refuses: a malformed exclude operand, and any
    # exclude operand on the clustered sweep (ValueError, as the JAX wrapper
    # raises). The exclude on the monolithic sweep and a 1,024-slot table,
    # which raised before they were ported, run.
    scene, _ = jscenes.get_scene("three_sphere", 1.0)
    ts = scene_from_arrays(_arrays(scene), device="cpu")
    o, d = torch.zeros((4, 3)), torch.ones((4, 3))
    none = torch.full((4,), -1, dtype=torch.int32)
    for a, b in zip(tsi.sphere_search(ts, o, d, T_MIN, exclude=none),
                    tsi.sphere_search(ts, o, d, T_MIN)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="integer"):
        tsi.sphere_search(ts, o, d, T_MIN, exclude=torch.zeros(4))
    with pytest.raises(ValueError, match="integer"):
        tsi.sphere_search(ts, o, d, T_MIN, exclude=none[:3])
    big = SceneBuilder()
    for i in range(1024):
        big.lambertian((float(i), 0.0, 0.0), 0.1, (0.5, 0.5, 0.5))
    big = big.build(pad_to=None, device="cpu")
    t, idx = tsi.sphere_search(big, o, d, T_MIN)
    assert t.shape == (4,) and idx.dtype == torch.int32
    with pytest.raises(ValueError, match="clustered"):
        tsi.sphere_search(big, o, d, T_MIN, exclude=none)
