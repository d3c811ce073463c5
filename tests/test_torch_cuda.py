"""The CUDA fused-hit kernel on the card against its plain PyTorch version,
at shapes the 1080p main path does not reach: ray counts that are not a
multiple of the 256-thread block, sphere counts below, between and above the
256-sphere shared-memory tile, blocks with no live ray; and a small render on
the card against the same render on the CPU.

Needs a CUDA card (marker ``cuda``) and skips without one. This module
imports no JAX, so it runs on a machine without it; ``tests/conftest.py``
does import JAX, so run it there with
``python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py``.

Tolerances: the kernel rounds op by op as the plain version does, so winner
ids agree on every live lane and the refined t within rtol 1e-5, the other
float outputs within atol 1e-5 + rtol 1e-5 (the limits of ``chip_smoke.py``);
dead lanes hold the defaults exactly. Renders: at most 1% of channels beyond
2e-3 + 2e-3 |ref|, as in ``tests/test_torch_render.py``.
"""

import numpy as np
import pytest
import torch

from qt_raytracer_tpu_torch import RenderConfig, SceneBuilder, render_linear, scenes
from qt_raytracer_tpu_torch.kernels import fused_hit as fh

pytestmark = pytest.mark.cuda

T_MIN = 1e-3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scene(num_spheres: int, seed: int):
    """Ground plus num_spheres - 1 random spheres of every material, unpadded
    (S = num_spheres) so the kernel sees S as given."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for _ in range(num_spheres - 1):
        c = (rng.uniform(-6, 6), rng.uniform(0.1, 2.0), rng.uniform(-6, 6))
        r = rng.uniform(0.05, 0.6)
        m = rng.integers(0, 3)
        if m == 0:
            b.lambertian(c, r, rng.random(3))
        elif m == 1:
            b.metal(c, r, rng.random(3), rng.random())
        else:
            b.dielectric(c, r, 1.5)
    return b.build(pad_to=None)


def _rays(n: int, seed: int, device):
    """n random rays above the ground; a fully dead 256-ray block where n
    allows, and about 10% scattered dead lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.01, 3.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) >= 0.1
    if n >= 512:
        alive[256:512] = False
    comps = [torch.from_numpy(np.ascontiguousarray(x[:, k])).to(device)
             for x in (o, d) for k in range(3)]
    return comps, torch.from_numpy(alive).to(device)


def _assert_hits_agree(kern: dict, plain: dict, alive: torch.Tensor):
    kern = {k: v.cpu() for k, v in kern.items()}
    plain = {k: v.cpu() for k, v in plain.items()}
    alive = alive.cpu()
    assert torch.equal(kern["idx"][alive], plain["idx"][alive])
    for k in ("mat", "ff"):
        assert torch.equal(kern[k][alive], plain[k][alive]), k
    hit = alive & (plain["t"] < fh.BIG)
    for k in fh.FLOAT_NAMES:
        lanes = hit if k == "t" else alive
        a, b = kern[k][lanes].double(), plain[k][lanes].double()
        atol = 0.0 if k == "t" else 1e-5
        assert torch.all((a - b).abs() <= atol + 1e-5 * b.abs()), k
    dead = ~alive
    for k in fh.NAMES:
        assert torch.equal(kern[k][dead], plain[k][dead]), k


@pytest.mark.parametrize("num_spheres", [4, 128, 300, 640])
@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
def test_kernel_matches_plain_version(card, n, num_spheres):
    tables = fh.prep_fused_spheres(_scene(num_spheres, seed=num_spheres).to(card))
    rays, alive = _rays(n, seed=n, device=card)
    before = fh.launches
    kern = fh.fused_hit(tables, *rays, alive, T_MIN)
    assert fh.launches == before + 1
    plain = fh.fused_hit(tables, *rays, alive, T_MIN, interpret=True)
    assert fh.launches == before + 1        # the plain version counts nothing
    torch.cuda.synchronize()
    assert all(v.device == card for v in kern.values())
    _assert_hits_agree(kern, plain, alive)


def test_all_dead_rays_get_defaults(card):
    tables = fh.prep_fused_spheres(_scene(300, seed=1).to(card))
    rays, alive = _rays(777, seed=2, device=card)
    dead = torch.zeros_like(alive)
    out = fh.fused_hit(tables, *rays, dead, T_MIN)
    defaults = dict(zip(fh.FLOAT_NAMES, fh.FLOAT_DEFAULTS))
    defaults.update(zip(fh.INT_NAMES, fh.INT_DEFAULTS))
    for k, v in defaults.items():
        assert torch.all(out[k].cpu() == v), k


def test_wrapper_refuses_mixed_devices(card):
    tables = fh.prep_fused_spheres(_scene(4, seed=0))        # on the CPU
    rays, alive = _rays(64, seed=0, device=card)
    with pytest.raises(ValueError, match="tables"):
        fh.fused_hit(tables, *rays, alive, T_MIN)


@pytest.mark.parametrize("name", ["three_sphere", "glossy_dof", "cornell"])
def test_render_on_card_matches_cpu(card, name):
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=5, rng="hash",
                       pixel_chunk=512)
    scene, cam = scenes.get_scene(name, cfg.aspect_ratio)
    fh.launches = 0
    got = render_linear(scene.to(card), cam.to(card), cfg, 5)
    assert fh.launches == 3 * cfg.spp * cfg.max_depth    # 3 chunks of 512
    assert got.device == card and bool(torch.isfinite(got).all())
    want = render_linear(scene, cam, cfg, 5)
    bad = (got.cpu() - want).abs() > 2e-3 + 2e-3 * want.abs()
    assert float(bad.float().mean()) <= 0.01
