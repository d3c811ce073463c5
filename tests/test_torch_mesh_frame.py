"""The slice as a whole on the CPU: a small terrain frame through the
port's ``render_linear`` under the mesh-search options ``mesh_visit``,
``mesh_cluster_rows`` and ``mesh_mt``, against the
default frame and the JAX package's frame (Pallas in interpret mode); and the
fused hit's ``mxu_extract`` keyword against the JAX kernel run with each
value.

Tolerances. The row gate and the cluster size change no bit of the
frame. The bilinear-form Moller-Trumbore (``mesh_mt="mxu"``) rounds
its candidates otherwise, so its frame is held to the flip budget of
tests/test_torch_world_render.py: at most 1% of channels beyond
2e-3 + 2e-3 |ref|, against the port's default frame and against the JAX
package's. The fused hit gives the same bits under either ``mxu_extract``;
against JAX the winners agree on 99.9% of live lanes, the winner's
parameters bit for bit where they agree (both read the f32 table exactly),
and t within the rtol of tests/test_torch_fused_hit.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu import render_linear as j_render_linear
from qt_raytracer_tpu.kernels.fused_hit import fused_hit_pallas
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch import RenderConfig, render_linear
from qt_raytracer_tpu_torch.kernels import fused_hit as tfh
from qt_raytracer_tpu_torch.utils.convert import (camera_from_arrays,
                                                  scene_from_arrays,
                                                  world_from_arrays)
from test_torch_fused_hit import _t_rtol
from test_torch_world_render import ATOL, MAX_MISMATCH, RTOL, SEED, _arrays
from torch_helpers import _one_thread  # noqa: F401

FRAME = dict(width=48, height=27, spp=1, max_depth=3, rng="hash")
T_MIN = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's (test_torch_compact.py).
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


@pytest.fixture(scope="module")
def terrain():
    jw = jmeshes.terrain_world(24, 24, builder="numpy")
    jc = jmeshes.terrain_camera(FRAME["width"] / FRAME["height"])
    tw = world_from_arrays(_arrays(jw.spheres), _arrays(jw.mesh), device="cpu")
    tc = camera_from_arrays(_arrays(jc), device="cpu")
    default = render_linear(tw, tc, RenderConfig(**FRAME), SEED)
    return jw, jc, tw, tc, default


def _mismatch(got, want):
    return float((np.abs(got - want) > ATOL + RTOL * np.abs(want)).mean())


def test_terrain_frame_under_search_options(terrain):
    jw, jc, tw, tc, default = terrain
    assert default.shape == (27, 48, 3) and bool(torch.isfinite(default).all())
    for option in (dict(mesh_visit="rowgate"), dict(mesh_cluster_rows=1)):
        got = render_linear(tw, tc, RenderConfig(**FRAME, **option), SEED)
        assert torch.equal(got, default), option
    mxu = render_linear(tw, tc, RenderConfig(**FRAME, mesh_mt="mxu"),
                        SEED).numpy()
    want = np.asarray(j_render_linear(
        jw, jc, JConfig(**FRAME, intersector="fused_interpret"),
        jax.random.PRNGKey(SEED)))
    assert bool(np.isfinite(mxu).all()) and float((want > 0).mean()) > 0.3
    for ref in (default.numpy(), want):
        assert _mismatch(mxu, ref) <= MAX_MISMATCH
    assert _mismatch(default.numpy(), want) <= MAX_MISMATCH


def test_fused_hit_mxu_extract(terrain):
    js = jscenes.get_scene("glossy_dof", 1.0)[0]
    rng = np.random.default_rng(6)
    n = 1024                                  # one grid step of JAX's
    o = np.stack([rng.uniform(-4, 4, n), rng.uniform(0.05, 2.0, n),
                  rng.uniform(-4, 4, n)], 1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) >= 0.1
    tables = tfh.prep_fused_spheres(scene_from_arrays(_arrays(js),
                                                      device="cpu"))
    assert tables.spheres.shape[0] == 128
    comps = [np.ascontiguousarray(x[:, k]) for x in (o, d) for k in range(3)]
    args = (tables, *map(torch.from_numpy, comps), torch.from_numpy(alive),
            T_MIN)
    got = {flag: tfh.fused_hit(*args, mxu_extract=flag)
           for flag in (True, False)}
    for k in tfh.NAMES:
        assert torch.equal(got[True][k], got[False][k]), k
    for bad in (1, "yes", None):
        with pytest.raises(ValueError, match="mxu_extract"):
            tfh.fused_hit(*args, mxu_extract=bad)
    params = ("mat", "ax", "ay", "az", "fuzz", "ior", "ex", "ey", "ez")
    for flag in (True, False):
        want = fused_hit_pallas(js, *map(jnp.asarray, comps),
                                jnp.asarray(alive), T_MIN, interpret=True,
                                mxu_extract=flag)
        want = {k: np.asarray(v) for k, v in want.items()}
        mine = {k: v.numpy() for k, v in got[flag].items()}
        agree = alive & (mine["idx"] == want["idx"])
        assert agree[alive].mean() >= 0.999
        hit = agree & (want["t"] < tfh.BIG)
        assert hit[alive].mean() > 0.2
        for k in params:
            np.testing.assert_array_equal(mine[k][hit], want[k][hit])
        lanes = np.nonzero(hit)[0]
        rtol = _t_rtol(dict(want=want, o=o, d=d,
                            center=_arrays(js)["center"],
                            radius=_arrays(js)["radius"]), lanes)
        err = np.abs(mine["t"][lanes].astype(np.float64) - want["t"][lanes])
        assert np.all(err <= rtol * np.abs(want["t"][lanes]))
