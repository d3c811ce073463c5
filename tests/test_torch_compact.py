"""The port's alive-compaction mode and its mesh-search options end to end,
on the CPU through the plain versions: ``trace_flat(compact=True)`` (forward
and ``diff=True`` with gradients) and ``trace_flat_world(compact=True)``
against ``compact=False``; a small terrain render under ``mesh_kernel``
"pairs" and "hybrid", ``mesh_sort0=False``, ``mesh_compact=True`` and the
other sort keys against the default render; a pathwise train step on the
true Cornell box under ``mesh_kernel="pairs"`` against "clustered".

Tolerances. Every option only changes which rays share a block or which
kernel finds the same winner, and every per-ray quantity rides the
permutation, so images, losses and gradients are equal bit for bit. The
default terrain render is held against the JAX package (Pallas in interpret
mode) within the flip budget of tests/test_torch_world_render.py: at most 1%
of channels beyond 2e-3 + 2e-3 |ref|.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu import render_linear as j_render_linear
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu_torch import RenderConfig, render, render_linear, scenes
from qt_raytracer_tpu_torch.core import render as render_mod
from qt_raytracer_tpu_torch.core import sampling
from qt_raytracer_tpu_torch.core.integrator_flat import (
    compact_state, initial_state, trace_flat, trace_flat_world)
from qt_raytracer_tpu_torch.diff import inverse as inv
from qt_raytracer_tpu_torch.models import meshes
from qt_raytracer_tpu_torch.utils.convert import (camera_from_arrays,
                                                  world_from_arrays)
from test_torch_world_render import ATOL, MAX_MISMATCH, RTOL, SEED, _arrays
from torch_helpers import _one_thread  # noqa: F401

TERRAIN = dict(width=48, height=48, spp=1, max_depth=3, rng="hash",
               pixel_chunk=-1)       # one chunk of 2,304 rays: the sort runs


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's: a pool first started
    # after XLA has run was seen to take its first vectorised sqrt a few
    # 1e-5 off in one thread.
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


def _rays(camera, cfg, rng):
    """cfg's camera rays of sample 0 with their RNG states ([N] hash or
    [N,2] threefry), as render_linear makes them."""
    i, j, pix = render_mod.pixel_grid(cfg, "cpu")
    keys = sampling.sample_keys(sampling.pixel_states(SEED, pix, rng), 0)
    o, d = render_mod._camera_rays(camera, cfg, keys, i, j)
    return o, d, keys


@pytest.mark.parametrize("rng", ["hash", "threefry"])
@pytest.mark.parametrize("nee", [False, True])
def test_trace_flat_compact_is_bitwise(rng, nee):
    cfg = RenderConfig(width=40, height=30, spp=1, max_depth=5, rng=rng)
    scene, cam = scenes.get_scene("cornell" if nee else "random",
                                  cfg.aspect_ratio, device="cpu")
    o, d, keys = _rays(cam, cfg, rng)            # 1,200 rays: padded to 2,048
    a = trace_flat(scene, o, d, keys, 5, nee=nee, rr_start=2)
    b = trace_flat(scene, o, d, keys, 5, nee=nee, rr_start=2, compact=True)
    assert a.shape == (1200, 3) and bool((a > 0).any())
    assert torch.equal(a, b)


@pytest.mark.parametrize("rng", ["hash", "threefry"])
def test_trace_flat_compact_gradients_are_bitwise(rng):
    cfg = RenderConfig(width=32, height=24, spp=1, max_depth=3, rng=rng)
    scene, cam = scenes.get_scene("cornell", cfg.aspect_ratio, device="cpu")
    o, d, keys = _rays(cam, cfg, rng)

    def loss_and_grads(compact):
        albedo = scene.albedo.clone().requires_grad_(True)
        center = scene.center.clone().requires_grad_(True)
        sc = dataclasses.replace(scene, albedo=albedo, center=center)
        out = trace_flat(sc, o, d, keys, 3, nee=True, diff=True,
                         compact=compact)
        loss = out.sum()
        return (out.detach(), *torch.autograd.grad(loss, [albedo, center]))

    plain, packed = loss_and_grads(False), loss_and_grads(True)
    for a, b in zip(plain, packed):
        assert torch.equal(a, b)
    assert float(plain[1].abs().max()) > 0 and float(plain[2].abs().max()) > 0


def test_compact_state_packs_live_rays_first():
    n = 1500
    g = torch.Generator().manual_seed(4)
    o = torch.rand((n, 3), generator=g)
    s = initial_state(o, o + 1.0, torch.arange(n))
    alive = s.alive & (torch.rand(s.alive.shape[0], generator=g) < 0.4)
    c = compact_state(s._replace(alive=alive))
    live = int(alive.sum())
    assert bool(c.alive[:live].all()) and not bool(c.alive[live:].any())
    # Stable: live rays keep their order; every field rode along.
    assert torch.equal(c.pid[:live], torch.nonzero(alive).squeeze(1))
    assert torch.equal(c.ox, s.ox[c.pid]) and torch.equal(c.keys,
                                                          s.keys[c.pid])
    assert torch.equal(torch.sort(c.pid).values, s.pid)


@pytest.fixture(scope="module")
def terrain():
    jw = jmeshes.terrain_world(48, 48, builder="numpy")
    jc = jmeshes.terrain_camera(1.0)
    tw = world_from_arrays(_arrays(jw.spheres), _arrays(jw.mesh), device="cpu")
    return (jw, jc), (tw, camera_from_arrays(_arrays(jc), device="cpu"))


@pytest.mark.parametrize("rng", ["hash", "threefry"])
def test_trace_flat_world_compact_is_bitwise(terrain, rng):
    _, (tw, tc) = terrain
    cfg = RenderConfig(**{**TERRAIN, "rng": rng})
    o, d, keys = _rays(tc, cfg, rng)
    a = trace_flat_world(tw, o, d, keys, 3)
    b = trace_flat_world(tw, o, d, keys, 3, compact=True)
    assert torch.equal(a, b)
    c = trace_flat_world(tw, o, d, keys, 3, compact=True,
                         mesh_kernel="hybrid", mesh_sort0=False)
    assert torch.equal(a, c)
    with pytest.raises(ValueError, match="mesh_kernel"):
        trace_flat_world(tw, o, d, keys, 1, mesh_kernel="bvh")


def test_cornell_world_compact_with_nee_is_bitwise():
    world = meshes.cornell_box_world(builder="numpy", device="cpu")
    cam = meshes.cornell_box_mesh_camera(1.0, device="cpu")
    cfg = RenderConfig(width=24, height=24, spp=1, max_depth=4, rng="hash")
    o, d, keys = _rays(cam, cfg, "hash")
    kw = dict(nee=True, rr_start=2)
    a = trace_flat_world(world, o, d, keys, 4, **kw)
    for option in (dict(compact=True), dict(mesh_kernel="pairs"),
                   dict(compact=True, mesh_kernel="pairs", mesh_pair_c=1)):
        assert torch.equal(a, trace_flat_world(world, o, d, keys, 4, **kw,
                                               **option)), option


@pytest.fixture(scope="module")
def terrain_default(terrain):
    _, (tw, tc) = terrain
    return render_linear(tw, tc, RenderConfig(**TERRAIN), SEED)


def test_default_terrain_render_matches_jax(terrain, terrain_default):
    (jw, jc), _ = terrain
    jcfg = JConfig(**TERRAIN, intersector="fused_interpret")
    want = np.asarray(j_render_linear(jw, jc, jcfg, jax.random.PRNGKey(SEED)))
    got = terrain_default.numpy()
    assert got.shape == (48, 48, 3) and np.isfinite(got).all()
    mismatch = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert mismatch.mean() <= MAX_MISMATCH, mismatch.mean()


@pytest.mark.parametrize("option", [
    dict(mesh_kernel="pairs"), dict(mesh_kernel="hybrid"),
    dict(mesh_sort0=False), dict(mesh_compact=True),
    dict(mesh_kernel="pairs", mesh_pair_c=1),
    dict(mesh_kernel="hybrid", mesh_compact=True, mesh_sort0=False),
    dict(mesh_sort_mode="crossing2"), dict(mesh_sort_mode="morton"),
], ids=lambda o: "-".join(f"{k[5:]}={v}" for k, v in o.items()))
def test_terrain_render_options_are_bit_identical(terrain, terrain_default,
                                                  option):
    _, (tw, tc) = terrain
    cfg = RenderConfig(**TERRAIN, **option)
    assert torch.equal(render_linear(tw, tc, cfg, SEED), terrain_default)


def test_render_and_pallas_route_take_the_options(terrain):
    # The uint8 entry point, and the [N,3] integrator under "pallas": its
    # intersect_world takes the pair search under "pairs" (every bounce and
    # shadow ray) and the clustered search under "hybrid".
    _, (tw, tc) = terrain
    small = dict(width=16, height=16, spp=1, max_depth=2, rng="hash")
    base = RenderConfig(**small)
    img = render(tw, tc, base, SEED)
    assert img.dtype == torch.uint8
    assert torch.equal(render(tw, tc, dataclasses.replace(
        base, mesh_kernel="pairs", mesh_compact=True), SEED), img)
    world = meshes.cornell_box_world(builder="numpy", device="cpu")
    cam = meshes.cornell_box_mesh_camera(1.0, device="cpu")
    nee = RenderConfig(**small, nee=True, intersector="pallas")
    want = render_linear(world, cam, nee, SEED)
    for kernel in ("pairs", "hybrid"):
        got = render_linear(world, cam, dataclasses.replace(
            nee, mesh_kernel=kernel, mesh_pair_c=2), SEED)
        assert torch.equal(got, want), kernel


def test_pathwise_train_step_under_pair_search_is_identical():
    world = meshes.cornell_box_world(builder="numpy", device="cpu")
    cam = meshes.cornell_box_mesh_camera(1.0, device="cpu")
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=3, rng="hash",
                       nee=True)
    key = sampling.prng_key(5, "cpu")
    target = inv.mean_image(world, cam, cfg, key) * 0.8
    out = {}
    for kernel in ("clustered", "pairs"):
        init, step, _, _ = inv.make_train_step(
            world, cam, dataclasses.replace(cfg, mesh_kernel=kernel),
            inv.adam(1e-2), trainable=(), train_camera="pose")
        state, loss = step(init(), target, key)
        grad = dict(inv.leaves(state.params))["camera/translate"].grad
        out[kernel] = (loss.detach(), grad.clone(),
                       state.params["camera"]["translate"].detach().clone())
    for a, b in zip(out["clustered"], out["pairs"]):
        assert torch.equal(a, b)
    assert float(out["pairs"][1].abs().max()) > 0
