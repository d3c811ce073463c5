"""Plain version of the fused hit kernel (qt_raytracer_tpu_torch.kernels.
fused_hit) against the JAX package's Pallas kernel in interpret mode, on
4,096 book-cover rays: 1080p camera rays and random origin/direction pairs,
with two fully dead 128-lane rows and scattered dead lanes in live rows.

Tolerances. Winner ids agree on at least 99.9% of live lanes (ties aside,
all). On lanes with the same winner the refined t agrees within rtol 1e-5,
widened by 32 ulps times the root's condition number: XLA:CPU contracts
some multiply-adds that PyTorch rounds one by one, and near-grazing hits
(disc << (b/2)^2) or a cancelling |oc|^2 - r^2 amplify that ulp. The other
float outputs agree within atol 1e-5 + rtol 1e-5 plus the t tolerance
carried through p = o + t d and n = (p - c) / r. Fully dead rows hold the
TPU kernel's defaults exactly (the port writes them on every dead lane; the
TPU kernel only on dead rows, and every consumer masks dead lanes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.core import camera as jcam
from qt_raytracer_tpu.kernels.fused_hit import fused_hit_pallas
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch.kernels import fused_hit as tfh
from qt_raytracer_tpu_torch.utils.convert import scene_from_arrays

N = 4096
DEAD_ROWS = (4, 5)          # lanes 512..767
T_MIN = 1e-3
EPS32 = 2.0 ** -24


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (CLAUDE.md).
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def case():
    js, jc = jscenes.get_scene("random", 1920 / 1080)
    rng = np.random.default_rng(2024)
    # Camera rays of the 1080p frame at random pixels and lens samples.
    half = N // 2
    s = ((rng.integers(0, 1920, half) + rng.random(half)) / 1919).astype(np.float32)
    t = ((rng.integers(0, 1080, half) + rng.random(half)) / 1079).astype(np.float32)
    u1, u2 = rng.random((2, half), dtype=np.float32)
    co, cd = jcam.get_rays(jc, *map(jnp.asarray, (s, t, u1, u2)))
    # Random pairs above the ground, among the small spheres.
    ro = rng.uniform(-8.0, 8.0, (half, 3)).astype(np.float32)
    ro[:, 1] = rng.uniform(0.01, 3.0, half)
    rd = rng.normal(size=(half, 3)).astype(np.float32)
    o = np.concatenate([np.asarray(co), ro])
    d = np.concatenate([np.asarray(cd), rd])
    perm = rng.permutation(N)
    o, d = o[perm], d[perm]
    alive = rng.random(N) >= 0.1
    for r in DEAD_ROWS:
        alive[r * 128:(r + 1) * 128] = False

    want = fused_hit_pallas(
        js, *(jnp.asarray(o[:, k]) for k in range(3)),
        *(jnp.asarray(d[:, k]) for k in range(3)), jnp.asarray(alive),
        T_MIN, interpret=True)
    want = {k: np.asarray(v) for k, v in want.items()}

    scene = scene_from_arrays(_arrays(js), device="cpu")
    tables = tfh.prep_fused_spheres(scene)
    comps = [torch.from_numpy(np.ascontiguousarray(x[:, k]))
             for x in (o, d) for k in range(3)]
    got = tfh.fused_hit(tables, *comps, torch.from_numpy(alive), T_MIN)
    got = {k: v.numpy() for k, v in got.items()}
    return dict(o=o, d=d, alive=alive, want=want, got=got,
                center=_arrays(js)["center"], radius=_arrays(js)["radius"])


def _t_rtol(c, lanes):
    """Per-lane rtol of the refined t: 1e-5 + 32 ulps x condition number."""
    k = c["want"]["idx"][lanes]
    o = c["o"][lanes].astype(np.float64)
    d = c["d"][lanes].astype(np.float64)
    oc = o - c["center"][k].astype(np.float64)
    r2 = c["radius"][k].astype(np.float64) ** 2
    half_b = np.sum(oc * d, axis=1)
    oc2 = np.sum(oc * oc, axis=1)
    c1 = oc2 - r2
    disc = half_b * half_b - np.sum(d * d, axis=1) * c1
    cond = (np.abs(half_b) / np.sqrt(np.maximum(disc, 1e-300))
            + (oc2 + r2) / np.maximum(np.abs(c1), 1e-300))
    return 1e-5 + 32 * EPS32 * cond


def test_winner_ids_agree(case):
    live = case["alive"]
    agree = (case["got"]["idx"] == case["want"]["idx"])[live]
    assert agree.mean() >= 0.999, agree.mean()
    hit = (case["want"]["t"] < tfh.BIG)[live]
    assert 0.2 < hit.mean() < 0.95        # the case holds hits and misses


def test_int_outputs_equal_on_agreeing_lanes(case):
    m = case["alive"] & (case["got"]["idx"] == case["want"]["idx"])
    for k in ("mat", "ff"):
        np.testing.assert_array_equal(case["got"][k][m], case["want"][k][m],
                                      err_msg=k)


def test_float_outputs_on_agreeing_lanes(case):
    got, want = case["got"], case["want"]
    m = case["alive"] & (got["idx"] == want["idx"])
    hit = m & (want["t"] < tfh.BIG)
    miss = m & ~(want["t"] < tfh.BIG)
    np.testing.assert_array_equal(got["t"][miss], want["t"][miss])

    lanes = np.nonzero(hit)[0]
    t_ref = want["t"][lanes].astype(np.float64)
    t_tol = _t_rtol(case, lanes) * np.abs(t_ref)
    t_err = np.abs(got["t"][lanes] - t_ref)
    assert np.all(t_err <= t_tol), np.max(t_err / t_tol)

    # Everything else: atol + rtol 1e-5, plus the t tolerance carried
    # through p = o + t d (and through n = (p - c) / r for the normal).
    d_abs = np.abs(case["d"][lanes]).astype(np.float64)
    r = want["rw"][lanes].astype(np.float64)
    carried = {"px": d_abs[:, 0] * t_tol, "py": d_abs[:, 1] * t_tol,
               "pz": d_abs[:, 2] * t_tol}
    carried.update(nx=carried["px"] / r, ny=carried["py"] / r,
                   nz=carried["pz"] / r)
    for k in ("px", "py", "pz", "nx", "ny", "nz", "ax", "ay", "az", "fuzz",
              "ior", "ex", "ey", "ez", "rw"):
        ref = want[k].astype(np.float64)
        tol = 1e-5 + 1e-5 * np.abs(ref)
        err = np.abs(got[k] - ref)
        assert np.all(err[miss] <= tol[miss]), k
        bound = tol[lanes] + carried.get(k, 0.0)
        assert np.all(err[lanes] <= bound), (k, np.max(err[lanes] / bound))


def test_fully_dead_rows_hold_defaults(case):
    for name in tfh.NAMES:
        for r in DEAD_ROWS:
            row = slice(r * 128, (r + 1) * 128)
            np.testing.assert_array_equal(case["got"][name][row],
                                          case["want"][name][row],
                                          err_msg=name)
    # The port writes the same defaults on every dead lane.
    dead = ~case["alive"]
    defaults = dict(zip(tfh.FLOAT_NAMES, tfh.FLOAT_DEFAULTS))
    defaults.update(zip(tfh.INT_NAMES, tfh.INT_DEFAULTS))
    for name, v in defaults.items():
        assert np.all(case["got"][name][dead] == np.float32(v)), name


def test_plain_slices_do_not_change_results(case):
    js, _ = jscenes.get_scene("random", 1920 / 1080)
    tables = tfh.prep_fused_spheres(scene_from_arrays(_arrays(js),
                                                      device="cpu"))
    comps = [torch.from_numpy(np.ascontiguousarray(x[:, k]))
             for x in (case["o"], case["d"]) for k in range(3)]
    small = tfh.fused_hit_plain(tables, *comps,
                                torch.from_numpy(case["alive"]), T_MIN,
                                slice_rays=1000)
    for k, v in small.items():
        np.testing.assert_array_equal(v.numpy(), case["got"][k], err_msg=k)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tables = tfh.prep_fused_spheres(scene_from_arrays(
        _arrays(jscenes.three_sphere_scene()), device="cpu"))
    f = lambda n=8, dt=torch.float32: torch.zeros(n, dtype=dt)
    alive = torch.ones(8, dtype=torch.bool)
    rays = [f() for _ in range(5)] + [torch.ones(8)]
    shadow = tfh.fused_hit(tables, *rays, alive, T_MIN, shadow_only=True)
    assert sorted(shadow) == ["idx", "t"]
    assert shadow["t"].dtype == torch.float32 and shadow["idx"].dtype == torch.int32
    # The exclude operand is an [N] integer tensor on the rays' device.
    none = torch.full((8,), -1, dtype=torch.int32)
    same = tfh.fused_hit(tables, *rays, alive, T_MIN, shadow_only=True,
                         exclude=none)
    assert torch.equal(same["t"], shadow["t"])
    for bad in (none[:7], none.float(), none.bool()):
        with pytest.raises(ValueError, match="exclude"):
            tfh.fused_hit(tables, *rays, alive, T_MIN, exclude=bad)
    with pytest.raises(ValueError):
        tfh.fused_hit(tables, *rays[:5], f(dt=torch.float64), alive, T_MIN)
    with pytest.raises(ValueError):
        tfh.fused_hit(tables, *rays[:5], f(n=9), alive, T_MIN)
    with pytest.raises(ValueError):
        tfh.fused_hit(tables, *rays, alive.int(), T_MIN)
    with pytest.raises(ValueError):
        tfh.fused_hit(tables, *rays[:5], torch.ones(16)[::2], alive, T_MIN)
