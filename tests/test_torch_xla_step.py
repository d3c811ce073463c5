"""A config-5 view-step of the port under ``intersector="xla"`` on the CPU
against the JAX package's: one view's L2 loss with NEE and the hash RNG,
and its gradients in the camera pose and the mesh vertices, on the true
Cornell box (a mesh world: the [N, S] sphere search and the BVH walk).
This module holds the pathwise step; tests/test_torch_xla_edge_step.py
takes ``view_step_case`` for the edge-aware one (the walk's exclude operand
in the background re-trace, and the shadow block), each module within its
time budget: JAX's compile of the edge-aware gradient takes some 30 s
alone. JAX's xla route runs no Pallas kernel.

Tolerances: the loss within rtol 2e-3, the gradients within 2e-3 |ref| +
2e-3 max|ref| (tests/test_torch_gradients.py, tests/test_torch_edge.py:
XLA:CPU contracts multiply-adds that PyTorch rounds one by one, and the sum
over pixels runs in another order). The edge-aware image equals the
pathwise one bit for bit (the boundary term is primal zero).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu.diff.inverse import image_loss as j_image_loss
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu_torch import RenderConfig as TConfig
from qt_raytracer_tpu_torch.diff.inverse import image_loss, mean_image
from qt_raytracer_tpu_torch.utils.convert import (camera_from_arrays,
                                                  world_from_arrays)
from torch_helpers import _one_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's (ROADMAP.md).
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(aspect):
    """(JAX world, JAX camera), (port world, port camera): the true Cornell
    box."""
    js = jmeshes.cornell_box_world(builder="numpy")
    jc = jmeshes.cornell_box_mesh_camera(aspect)
    ts = world_from_arrays(_arrays(js.spheres), _arrays(js.mesh),
                           device="cpu")
    return (js, jc), (ts, camera_from_arrays(_arrays(jc), device="cpu"))


def _rebuild(scene, cam, p):
    """The world and camera with the parameters put in: "v0" of the mesh,
    "translate" of the camera (the pose of config 5's view-step)."""
    if "v0" in p:
        scene = dataclasses.replace(scene, mesh=dataclasses.replace(
            scene.mesh, v0=p["v0"]))
    if "translate" in p:
        cam = dataclasses.replace(
            cam, origin=cam.origin + p["translate"],
            lower_left_corner=cam.lower_left_corner + p["translate"])
    return scene, cam


def view_step_case(edge_aware: bool) -> None:
    """One config-5 view's L2 loss (NEE, hash RNG) and its gradients in the
    camera pose and the mesh vertices, at 24x16, spp 2, depth 2, in both
    packages; asserts they match."""
    kw = dict(width=24, height=16, spp=2, max_depth=2, rng="hash", nee=True,
              intersector="xla", edge_aware=edge_aware)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    (js, jc), (ts, tc) = _both(jcfg.aspect_ratio)
    target = np.full((jcfg.height, jcfg.width, 3), 0.3, np.float32)
    init = {"translate": np.zeros(3, np.float32),
            "v0": np.asarray(js.mesh.v0)}
    jp = {f: jnp.asarray(v) for f, v in init.items()}
    jl, jg = jax.value_and_grad(lambda p: j_image_loss(
        *_rebuild(js, jc, p), jcfg, jax.random.PRNGKey(0),
        jnp.asarray(target)))(jp)
    tp = {f: torch.tensor(v, requires_grad=True) for f, v in init.items()}
    tl = image_loss(*_rebuild(ts, tc, tp), tcfg, 0, torch.from_numpy(target))
    tg = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    for f in init:
        want, got = np.asarray(jg[f]), tg[f].numpy()
        assert np.isfinite(got).all() and np.abs(want).max() > 0, f
        np.testing.assert_allclose(got, want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max(), err_msg=f)
    if edge_aware:
        with torch.no_grad():
            plain = mean_image(ts, tc, dataclasses.replace(
                tcfg, edge_aware=False), 0)
            assert torch.equal(plain, mean_image(ts, tc, tcfg, 0))


def test_view_step_matches_jax():
    view_step_case(edge_aware=False)
