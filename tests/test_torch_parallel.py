"""The port's sharded render (qt_raytracer_tpu_torch.parallel.sharding) on
the CPU, over gloo ranks spawned by tests/torch_dist_worker.py: the cases of
tests/test_parallel.py at every (sp, px) of worlds of 1, 2 and 4 ranks,
against the port's render_linear, and the (2, 2) image against the JAX
package's render_linear_sharded on four of conftest.py's eight virtual CPU
devices.

Tolerances, as in tests/test_parallel.py: "px" is bit for bit
(``torch.equal``), since every RNG key is a function of the global pixel
and sample index; "sp" reassociates the per-pixel spp sum, within rtol =
atol = 3e-7. Against JAX, the flip budget of tests/test_torch_render.py: at
most 1% of channels differ by more than 2e-3 + 2e-3 |ref| (f32 paths that
graze a sphere flip on an ulp, and the packages round some multiply-adds
differently).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu.parallel.sharding import make_mesh as j_make_mesh
from qt_raytracer_tpu.parallel.sharding import \
    render_linear_sharded as j_render_linear_sharded
from qt_raytracer_tpu_torch import RenderConfig, render_linear
from qt_raytracer_tpu_torch.core.render import accumulate_pixels
from qt_raytracer_tpu_torch.parallel import sharding
from torch_helpers import _one_thread  # noqa: F401

SHARD_RTOL = SHARD_ATOL = 3e-7
JAX_ATOL = JAX_RTOL = 2e-3
JAX_MAX_MISMATCH = 0.01


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop (ROADMAP.md); then PyTorch's thread pool
    # starts before XLA's.
    jax.clear_caches()
    torch.sqrt(torch.ones(4))
    yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world size -> each rank's results of job_render."""
    return {n: w.run_world(n, "render", tmp_path_factory.mktemp(f"world{n}"))
            for n in (2, 4)}


@pytest.fixture(scope="module")
def spheres():
    cfg = RenderConfig(**w.SPHERES)
    scene, cam = w.three_sphere(cfg)
    return scene, cam, cfg, render_linear(scene, cam, cfg, 0)


def _same_on_every_rank(results, key):
    for r in results[1:]:
        assert torch.equal(r[key], results[0][key]), key
    return results[0][key]


def test_world_of_one_without_process_group(spheres):
    scene, cam, cfg, ref = spheres
    mesh = sharding.make_mesh()
    assert (mesh.shape, mesh.rank) == ({"sp": 1, "px": 1}, 0)
    assert torch.equal(
        sharding.render_linear_sharded(scene, cam, cfg, 0, mesh), ref)


@pytest.mark.parametrize("sp,px", [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1)])
def test_sharded_render_matches_render_linear(ranks, spheres, sp, px):
    _, _, _, ref = spheres
    img = _same_on_every_rank(ranks[sp * px], f"spheres_{sp}x{px}")
    assert img.shape == ref.shape
    if sp == 1:
        assert torch.equal(img, ref)
    else:
        torch.testing.assert_close(img, ref, rtol=SHARD_RTOL,
                                   atol=SHARD_ATOL)


def test_sharded_render_matches_jax_2x2(ranks):
    # JAX's default route on the CPU ("auto" is "xla" there) against the
    # port's default; both sharded over (2, 2).
    img = _same_on_every_rank(ranks[4], "spheres_2x2").numpy()
    jcfg = JConfig(**w.SPHERES)
    js, jc = jscenes.get_scene("three_sphere", jcfg.aspect_ratio)
    mesh = j_make_mesh(sp=2, px=2, devices=jax.devices()[:4])
    want = np.asarray(j_render_linear_sharded(
        js, jc, jcfg, jax.random.PRNGKey(0), mesh))
    assert img.shape == want.shape and np.isfinite(img).all()
    got, want = img / jcfg.spp, want / jcfg.spp
    mismatch = np.abs(got - want) > JAX_ATOL + JAX_RTOL * np.abs(want)
    assert mismatch.mean() <= JAX_MAX_MISMATCH, mismatch.mean()


def test_nondivisible_pixels_padded(ranks, spheres):
    # 15 x 11 = 165 pixels over px = 2: one padding pixel, sliced off. JAX
    # holds its padded case within 3e-7 (ragged shard widths change XLA's
    # vectorisation there); the port's per-ray arithmetic does not depend
    # on the shard's width, and the image is in fact bit for bit.
    scene, cam, _, _ = spheres
    rcfg = RenderConfig(**w.RAGGED)
    assert sharding._padded_pixels(rcfg, 2) == 166
    ref = render_linear(scene, cam, rcfg, 0)
    img = _same_on_every_rank(ranks[2], "ragged_1x2")
    torch.testing.assert_close(img, ref, rtol=SHARD_RTOL, atol=SHARD_ATOL)
    assert torch.equal(img, ref)


def test_sharded_chunks_pad_to_one_shape(ranks, spheres):
    # Each rank's pixel range in render_linear's chunks, the last one
    # padded to the chunk's shape by replaying the range's first pixels
    # (core.render.accumulate_pixels): bit for bit the unchunked image.
    scene, cam, _, _ = spheres
    ref = render_linear(scene, cam, RenderConfig(**w.RAGGED), 0)
    img = _same_on_every_rank(ranks[2], "chunked_1x2")
    assert torch.equal(img, ref)


def test_accumulate_pixels_range_is_a_slice_of_render_linear(spheres):
    # A pixel range that starts off a chunk boundary, in chunks of 32 (the
    # last padded), is the same range of the unchunked render bit for bit.
    scene, cam, cfg, ref = spheres
    pixels = torch.arange(50, 150)
    got = accumulate_pixels(scene, cam,
                            dataclasses.replace(cfg, pixel_chunk=32), 0,
                            pixels, 0, cfg.spp, 1)
    assert torch.equal(got, ref.reshape(-1, 3)[50:150])


def test_refusals_raise_before_any_collective(ranks, spheres):
    scene, cam, cfg, _ = spheres
    for r in ranks[2]:
        assert "not divisible" in r["raised_spp"]
        assert r["raised_mesh"] == "sp*px = 3*0 != 2 devices"
        assert float(r["after_refusals"]) == 2.0
    # The same refusals in a world of one.
    with pytest.raises(ValueError, match="not divisible"):
        sharding.render_linear_sharded(
            scene, cam, dataclasses.replace(cfg, spp=3), 0,
            sharding.Mesh(sp=2, px=1, rank=0))
    with pytest.raises(ValueError, match=r"sp\*px = 1\*2 != 1 devices"):
        sharding.make_mesh(sp=1, px=2)
    with pytest.raises(TypeError, match="Mesh"):
        sharding.render_linear_sharded(scene, cam, cfg, 0, mesh="sp,px")


def test_replicate_broadcasts_rank_zero(ranks, spheres):
    scene, _, _, _ = spheres
    for r in ranks[2]:
        assert torch.equal(r["replicated_albedo"], scene.albedo)
        assert torch.equal(r["replicated_active"], scene.active)
        assert r["replicated_active"].dtype == torch.bool


def test_sharded_mesh_world_matches_render_linear(ranks):
    cfg = RenderConfig(**w.ICOSPHERE)
    world, cam = w.icosphere(cfg)
    ref = render_linear(world, cam, cfg, 0)
    img = _same_on_every_rank(ranks[4], "icosphere_2x2")
    torch.testing.assert_close(img, ref, atol=1e-5, rtol=1e-5)


def test_sharded_terrain_world_px_bitwise(ranks):
    cfg = RenderConfig(**w.TERRAIN)
    world, cam = w.terrain(cfg)
    assert world.mesh.num_triangles == 1922
    ref = render_linear(world, cam, cfg, 0)
    img = _same_on_every_rank(ranks[4], "terrain_1x4")
    assert torch.equal(img, ref)
