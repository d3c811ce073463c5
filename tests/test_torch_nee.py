"""Next-event estimation in the port: the shadow-mode fused hit (kernel A2's
plain version), the sphere-light NEE and emitter MIS weight of the flat
integrator, and a Cornell render with NEE and Russian roulette, against the
JAX package with its Pallas kernel in interpret mode.

Tolerances. A2's winner ids are equal on every live lane. Its t is the
unrefined root of the expanded quadratic, whose |c|^2 - r^2 term cancels
badly (r = 1000 walls and ground), so it agrees within rtol 1e-5 widened by
32 ulps times that root's error bound: the summed magnitudes of the terms
of half_b and of the discriminant, carried through the root formula. The
NEE contribution and the MIS weight agree within 1e-5 + 1e-4 |ref| (the two
packages' sin, cos and FMA contraction differ in the last ulps) on all but
0.5% of lanes, where an ulp can flip a shadow or cone test. Renders use the
flip budget of tests/test_torch_render.py: at most 1% of channels beyond
2e-3 + 2e-3 |ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu import render_linear as j_render_linear
from qt_raytracer_tpu.core import integrator_flat as jif
from qt_raytracer_tpu.kernels.fused_hit import fused_hit_pallas
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch import RenderConfig as TConfig
from qt_raytracer_tpu_torch import render_linear as t_render_linear
from qt_raytracer_tpu_torch.core import integrator_flat as tif
from qt_raytracer_tpu_torch.kernels import fused_hit as tfh
from qt_raytracer_tpu_torch.utils.convert import camera_from_arrays, scene_from_arrays
from torch_helpers import _one_thread  # noqa: F401

N = 2048
DEAD_ROWS = (4, 5)          # lanes 512..767
T_MIN = 1e-3
EPS32 = 2.0 ** -24
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py: one process
    # that holds too many XLA:CPU executables aborts.
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _rays(name, rng):
    if name == "random":
        o = rng.uniform(-8.0, 8.0, (N, 3)).astype(np.float32)
        o[:, 1] = rng.uniform(0.01, 3.0, N)
    else:                                   # inside and in front of the box
        o = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(0.05, 1.95, N),
                      rng.uniform(-1.5, 3.5, N)], 1).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    alive = rng.random(N) >= 0.1
    for r in DEAD_ROWS:
        alive[r * 128:(r + 1) * 128] = False
    return o, d, alive


@pytest.fixture(scope="module", params=["random", "cornell"])
def shadow_case(request):
    js, _ = jscenes.get_scene(request.param, 1.0)
    o, d, alive = _rays(request.param, np.random.default_rng(1))
    comps = [np.ascontiguousarray(x[:, a]) for x in (o, d) for a in range(3)]
    want = fused_hit_pallas(js, *map(jnp.asarray, comps), jnp.asarray(alive),
                            T_MIN, shadow_only=True, interpret=True)
    tables = tfh.prep_fused_spheres(scene_from_arrays(_arrays(js),
                                                      device="cpu"))
    got = tfh.fused_hit(tables, *map(torch.from_numpy, comps),
                        torch.from_numpy(alive), T_MIN, shadow_only=True)
    return dict(js=js, o=o, d=d, alive=alive,
                want={k: np.asarray(v) for k, v in want.items()},
                got={k: v.numpy() for k, v in got.items()})


def _expanded_root_tol(c, lanes):
    """1e-5 |t| + 32 ulps x the error bound of the expanded-form root."""
    k = c["want"]["idx"][lanes]
    ctr = np.asarray(c["js"].center)[k].astype(np.float64)
    r = np.asarray(c["js"].radius)[k].astype(np.float64)
    o = c["o"][lanes].astype(np.float64)
    d = c["d"][lanes].astype(np.float64)
    a = np.sum(d * d, axis=1)
    half_b = np.sum(o * d, axis=1) - np.sum(ctr * d, axis=1)
    e_b = np.sum(np.abs(o * d), axis=1) + np.sum(np.abs(ctr * d), axis=1)
    cterm = (np.sum(o * o, axis=1) - 2 * np.sum(o * ctr, axis=1)
             + np.sum(ctr * ctr, axis=1) - r * r)
    e_c = (np.sum(o * o, axis=1) + 2 * np.sum(np.abs(o * ctr), axis=1)
           + np.sum(ctr * ctr, axis=1) + r * r)
    disc = half_b * half_b - a * cterm
    e_disc = half_b * half_b + a * e_c + 2 * np.abs(half_b) * e_b
    e_root = (e_b + e_disc / (2 * np.sqrt(np.maximum(disc, 1e-300)))) / a
    t = np.abs(c["want"]["t"][lanes].astype(np.float64))
    return 1e-5 * t + 32 * EPS32 * e_root


def test_shadow_mode_ids_and_unrefined_t(shadow_case):
    c = shadow_case
    got, want, alive = c["got"], c["want"], c["alive"]
    assert sorted(got) == ["idx", "t"]
    assert got["t"].dtype == np.float32 and got["idx"].dtype == np.int32
    np.testing.assert_array_equal(got["idx"][alive], want["idx"][alive])
    hit = alive & (want["t"] < tfh.BIG)
    assert hit[alive].mean() > 0.2
    np.testing.assert_array_equal(got["t"][alive & ~hit],
                                  want["t"][alive & ~hit])
    lanes = np.nonzero(hit)[0]
    err = np.abs(got["t"][lanes] - want["t"][lanes].astype(np.float64))
    tol = _expanded_root_tol(c, lanes)
    assert np.all(err <= tol), np.max(err / tol)


def test_shadow_mode_dead_lanes(shadow_case):
    c = shadow_case
    for r in DEAD_ROWS:              # the TPU kernel's dead-row values
        row = slice(r * 128, (r + 1) * 128)
        for k in ("t", "idx"):
            np.testing.assert_array_equal(c["got"][k][row], c["want"][k][row])
    dead = ~c["alive"]
    assert np.all(c["got"]["t"][dead] == np.float32(tfh.BIG))
    assert np.all(c["got"]["idx"][dead] == 0)


def test_shadow_mode_is_the_full_sweep(shadow_case):
    # Same sweep as full mode: the ids agree, and the refinement only moves t.
    c = shadow_case
    tables = tfh.prep_fused_spheres(scene_from_arrays(_arrays(c["js"]),
                                                      device="cpu"))
    comps = [torch.from_numpy(np.ascontiguousarray(x[:, a]))
             for x in (c["o"], c["d"]) for a in range(3)]
    alive = torch.from_numpy(c["alive"])
    full = tfh.fused_hit(tables, *comps, alive, T_MIN)
    shadow = tfh.fused_hit_plain(tables, *comps, alive, T_MIN,
                                 slice_rays=300, shadow_only=True)
    np.testing.assert_array_equal(shadow["idx"].numpy(), c["got"]["idx"])
    np.testing.assert_array_equal(shadow["t"].numpy(), c["got"]["t"])
    live = c["alive"]
    np.testing.assert_array_equal(full["idx"].numpy()[live],
                                  c["got"]["idx"][live])
    np.testing.assert_array_equal(full["t"].numpy()[live] < tfh.BIG,
                                  c["got"]["t"][live] < tfh.BIG)


@pytest.fixture(scope="module")
def nee_case():
    """Cornell sphere scene: first hits of random rays from the camera side,
    with random uniforms, throughputs and previous-bounce pdfs."""
    js, _ = jscenes.get_scene("cornell", 1.0)
    rng = np.random.default_rng(5)
    o = np.stack([rng.uniform(-0.9, 0.9, N), rng.uniform(0.1, 1.9, N),
                  rng.uniform(1.0, 4.0, N)], 1).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2])
    alive = rng.random(N) >= 0.1
    comps = [jnp.asarray(np.ascontiguousarray(x[:, a]))
             for x in (o, d) for a in range(3)]
    h = fused_hit_pallas(js, *comps, jnp.asarray(alive), T_MIN,
                         interpret=True)
    h = {k: np.asarray(v) for k, v in h.items()}
    uni = rng.random((N, 8), dtype=np.float32)
    thr = rng.uniform(0.1, 1.0, (3, N)).astype(np.float32)
    prev_pdf = np.where(rng.random(N) < 0.3, -1.0,
                        rng.uniform(0.0, 0.4, N)).astype(np.float32)
    diffuse = alive & (h["t"] < tfh.BIG) & (h["mat"] == 0)
    return dict(js=js, o=o, h=h, uni=uni, thr=thr, prev_pdf=prev_pdf,
                diffuse=diffuse)


def _within(got, want, atol=1e-5, rtol=1e-4):
    return np.abs(got - want) <= atol + rtol * np.abs(want)


def test_nee_flat_matches_jax(nee_case):
    c = nee_case
    h = c["h"]
    keys = ("px", "py", "pz", "nx", "ny", "nz", "ax", "ay", "az")
    want = jif._nee_flat(c["js"], *(jnp.asarray(h[k]) for k in keys),
                         *map(jnp.asarray, c["thr"]),
                         jnp.asarray(c["diffuse"]), jnp.asarray(c["uni"]),
                         T_MIN, True)
    ts = scene_from_arrays(_arrays(c["js"]), device="cpu")
    got = tif._nee_flat(tfh.prep_fused_spheres(ts), ts.light_idx,
                        *(torch.tensor(h[k]) for k in keys),
                        *map(torch.from_numpy, c["thr"]),
                        torch.from_numpy(c["diffuse"]),
                        torch.from_numpy(c["uni"]), T_MIN, False)
    lit = np.asarray(want[0]) > 0
    assert 0.1 < lit[c["diffuse"]].mean() < 0.9   # lit and shadowed lanes
    for g, w in zip(got, want):
        ok = _within(g.numpy(), np.asarray(w))
        assert ok.mean() >= 0.995, ok.mean()


def test_emit_weight_flat_matches_jax(nee_case):
    c = nee_case
    h = c["h"]
    o = [np.ascontiguousarray(c["o"][:, a]) for a in range(3)]
    want = np.asarray(jif._emit_weight_flat(
        {k: jnp.asarray(v) for k, v in h.items()}, *map(jnp.asarray, o),
        jnp.asarray(c["prev_pdf"]), 1))
    got = tif._emit_weight_flat({k: torch.tensor(v) for k, v in h.items()},
                                *map(torch.from_numpy, o),
                                torch.from_numpy(c["prev_pdf"]), 1).numpy()
    assert np.any(want < 1.0) and np.any(want == 1.0)
    ok = _within(got, want)
    assert ok.mean() >= 0.995, ok.mean()


def test_cornell_nee_rr_render_matches_jax():
    kw = dict(width=16, height=12, spp=2, max_depth=6, nee=True, rr_start=2,
              rng="hash", intersector="fused_interpret")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    js, jc = jscenes.get_scene("cornell", jcfg.aspect_ratio)
    want = np.asarray(j_render_linear(js, jc, jcfg,
                                      jax.random.PRNGKey(SEED))) / jcfg.spp
    got = t_render_linear(scene_from_arrays(_arrays(js), device="cpu"),
                          camera_from_arrays(_arrays(jc),
                                             device="cpu"), tcfg, SEED)
    assert got.shape == (12, 16, 3) and bool(torch.isfinite(got).all())
    got = got.numpy() / tcfg.spp
    bad = np.abs(got - want) > 2e-3 + 2e-3 * np.abs(want)
    assert bad.mean() <= 0.01, bad.mean()
    # NEE changes the estimate (same expectation, other samples).
    no_nee = t_render_linear(scene_from_arrays(_arrays(js), device="cpu"),
                             camera_from_arrays(_arrays(jc), device="cpu"),
                             dataclasses.replace(tcfg, nee=False), SEED)
    assert not np.array_equal(got, no_nee.numpy() / tcfg.spp)
