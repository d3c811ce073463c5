"""Sharded gradients and training of the port on the CPU, over two gloo
ranks spawned by tests/torch_dist_worker.py: the two-process render and
gradient of tests/test_distributed.py, the sharded gradient of
tests/test_gradients.py (against the port's single process and against the
JAX package's sharded gradient), the train steps with mesh=, and the
helpers of parallel.distributed.

Tolerances. The sharded image is bit for bit at sp = 1 and within 3e-7 at
sp = 2 (tests/test_torch_parallel.py). A sharded gradient sums the ranks'
parts in another order than one process sums the pixels: within rtol 1e-4,
atol 1e-7 (tests/test_distributed.py). Train steps: losses within rtol
1e-5 (equal at the first step where the image is bit for bit), parameters
within 1e-5 + 1e-5 |ref| (Adam moves an entry by about lr * sign(g), so a
reassociated gradient moves it by far less), and equal across ranks.
Against JAX's sharded gradient (the "xla" route on both sides, 8x6,
depth 2), the tolerance of JAX's own sharded-against-single test
(tests/test_gradients.py): atol 1e-6, rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu.diff.inverse import mean_image as j_mean_image
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu.parallel.sharding import make_mesh as j_make_mesh
from qt_raytracer_tpu_torch import RenderConfig
from torch_helpers import _one_thread  # noqa: F401

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
STEP_RTOL = STEP_ATOL = 1e-5
JAX_GRAD_RTOL, JAX_GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop (ROADMAP.md); then PyTorch's thread pool
    # starts before XLA's.
    jax.clear_caches()
    torch.sqrt(torch.ones(4))
    yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.run_world(2, "train", tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def single_steps():
    """Each train-step case on one process."""
    return {name: w.run_steps(make, target, steps)
            for name, (make, target, steps) in w.step_cases().items()}


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert torch.equal(r[key], ranks[0][key]), key
    return ranks[0][key]


@pytest.mark.parametrize("sp", [2, 1])
def test_two_process_render_and_grad(ranks, sp):
    cfg = RenderConfig(**w.GRAD)
    scene, cam = w.three_sphere(cfg)
    ref_img, ref_g = w.grad_albedo(scene, cam, cfg)
    img = _same_on_every_rank(ranks, f"grad_image_sp{sp}")
    g = _same_on_every_rank(ranks, f"grad_albedo_sp{sp}")
    if sp == 1:
        assert torch.equal(img, ref_img)
    else:
        torch.testing.assert_close(img, ref_img, rtol=3e-7, atol=3e-7)
    assert float(ref_g.abs().max()) > 0
    torch.testing.assert_close(g, ref_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_sharded_grad_matches_jax_sharded_grad(ranks):
    jcfg = JConfig(**w.TINY_GRAD)
    js, jc = jscenes.get_scene("three_sphere", jcfg.aspect_ratio)
    mesh = j_make_mesh(sp=2, px=1, devices=jax.devices()[:2])

    def loss(albedo):
        sc = dataclasses.replace(js, albedo=albedo)
        img = j_mean_image(sc, jc, jcfg, jax.random.PRNGKey(0), mesh=mesh)
        return jnp.mean((img * jcfg.spp) ** 2)

    want = np.asarray(jax.grad(loss)(js.albedo))
    got = _same_on_every_rank(ranks, "tiny_grad_albedo").numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=JAX_GRAD_RTOL,
                               atol=JAX_GRAD_ATOL)


@pytest.mark.parametrize("case", ["l2_sp2", "l2_sp1", "dual", "edge_aware",
                                  "multiview", "multiview_perview"])
def test_train_step_with_mesh(ranks, single_steps, case):
    mine = ranks[0][case]
    for r in ranks[1:]:
        for p, t in mine["params"].items():
            assert torch.equal(r[case]["params"][p], t), p
        assert torch.equal(r[case]["losses"], mine["losses"])
    ref = single_steps[case.split("_sp")[0]]
    if case != "l2_sp2":
        # Bit-for-bit image at sp = 1: the first loss is the same number.
        assert torch.equal(mine["losses"][0], ref["losses"][0])
    torch.testing.assert_close(mine["losses"], ref["losses"], rtol=STEP_RTOL,
                               atol=0.0)
    assert mine["params"].keys() == ref["params"].keys()
    for p, t in ref["params"].items():
        torch.testing.assert_close(mine["params"][p], t, rtol=STEP_RTOL,
                                   atol=STEP_ATOL, msg=p)


def test_distributed_helpers(ranks):
    for rank, r in enumerate(ranks):
        assert r["global_mesh"] == [{"sp": 1, "px": 2}, {"sp": 2, "px": 1}]
        assert r["is_coordinator"] == (rank == 0)
        assert torch.equal(r["gathered"], r["grad_image_sp1"])
