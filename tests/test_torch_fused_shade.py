"""The shading kernel's route rule and its uniforms, on the CPU.

``kernels/fused_shade.py`` runs a bounce's shading (``integrator_flat._shade``
without NEE) in one CUDA kernel. What the CPU can hold of it: the route
rule (the kernel only for CUDA tensors, outside interpret, with hash states,
without NEE and without autograd recording), that the CPU takes the PyTorch
route and counts no launch, that the wrapper refuses CPU tensors instead of
falling back, and the kernel's in-register uniform formula, restated in
numpy uint32 arithmetic, against ``sampling.stream_uniforms`` slot by slot,
and that the crafted lanes of ``torch_helpers.shade_inputs`` reach every
branch. The kernel against its plain version is in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from qt_raytracer_tpu_torch import RenderConfig, render_linear, scenes
from qt_raytracer_tpu_torch.core import integrator_flat as itf
from qt_raytracer_tpu_torch.core import sampling
from qt_raytracer_tpu_torch.kernels import fused_shade as fs
from qt_raytracer_tpu_torch.kernels.fused_hit import BIG
from qt_raytracer_tpu_torch.runtime import spans
from torch_helpers import _one_thread, shade_inputs  # noqa: F401

CUDA = torch.device("cuda")
CPU = torch.device("cpu")


def _tensors(requires_grad: bool):
    s, h = shade_inputs(8, seed=0)
    if requires_grad:
        h["ax"] = h["ax"].clone().requires_grad_(True)
    return s, (*s, *h.values())


# (device, interpret, threefry keys, nee, a tensor requires grad, autograd
# records, expected route)
ROUTES = {
    "all_five_hold": (CUDA, False, False, False, False, True, True),
    "grad_off_with_leaf": (CUDA, False, False, False, True, False, True),
    "cpu_tensors": (CPU, False, False, False, False, True, False),
    "interpret": (CUDA, True, False, False, False, True, False),
    "threefry_keys": (CUDA, False, True, False, False, True, False),
    "nee": (CUDA, False, False, True, False, True, False),
    "autograd_records": (CUDA, False, False, False, True, True, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_rule(case):
    # The kernel only when every condition holds; the device is the value
    # _shade reads off the state, so a CUDA device is named here without a
    # card.
    dev, interpret, threefry, nee, leaf, records, want = ROUTES[case]
    s, tensors = _tensors(leaf)
    keys = torch.stack([s.keys, s.keys], 1) if threefry else s.keys
    with torch.set_grad_enabled(records):
        assert fs.use_kernel(dev, interpret, keys, nee, tensors) is want


@pytest.mark.parametrize("rr_start,depth_idx", [(0, 0), (2, 1), (2, 3)])
def test_cpu_takes_the_pytorch_route(rr_start, depth_idx):
    # On CPU tensors _shade is _shade_plain, bit for bit, and launches
    # nothing.
    s, h = shade_inputs(4099, seed=depth_idx, depth_idx=depth_idx)
    before = spans.counts["fused_shade"]
    got = itf._shade(s, h, depth_idx, rr_start, 1.0, None)
    want = itf._shade_plain(s, h, depth_idx, rr_start, 1.0, None)
    assert spans.counts["fused_shade"] == before
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)


def test_wrapper_refuses_cpu_tensors():
    # A CPU tensor never reaches the kernel, and the wrapper does not fall
    # back to the PyTorch route either.
    s, h = shade_inputs(16, seed=1)
    before = spans.counts["fused_shade"]
    with pytest.raises(ValueError, match="cuda"):
        fs.fused_shade(s, h, 0, 0)
    assert spans.counts["fused_shade"] == before


def test_cpu_render_launches_nothing():
    cfg = RenderConfig(width=16, height=8, spp=1, max_depth=3, rng="hash")
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                  device="cpu")
    spans.counts.clear()
    img = render_linear(scene, cam, cfg, 2)
    assert spans.counts["fused_shade"] == 0
    assert bool(torch.isfinite(img).all())


GOLDEN = np.uint32(0x9E3779B9)
WEYL2 = np.uint32(0x85EBCA77)


def _lowbias32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _kernel_uniform(keys: np.ndarray, stream_id: int, slot: int) -> np.ndarray:
    """csrc/fused_shade.cu's uniform(): uint32 arithmetic that wraps."""
    with np.errstate(over="ignore"):
        word = np.uint32(stream_id) * GOLDEN
        bits = _lowbias32(_lowbias32(keys + (word + np.uint32(slot) * WEYL2))
                          + GOLDEN)
    return (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


@pytest.mark.parametrize("stream_id", [sampling.STREAM_BOUNCE0,
                                       sampling.STREAM_BOUNCE0 + 9,
                                       2 ** 20 + 3])
def test_kernel_uniforms_equal_stream_uniforms(stream_id):
    rng = np.random.default_rng(stream_id)
    keys = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    keys[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    want = sampling.stream_uniforms(torch.from_numpy(keys.astype(np.int64)),
                                    stream_id, sampling.UNIFORMS_PER_BOUNCE)
    for slot in range(sampling.UNIFORMS_PER_BOUNCE):
        got = _kernel_uniform(keys, stream_id, slot)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want[:, slot].numpy().view(np.int32))


def test_shade_inputs_reach_every_branch():
    # The crafted lanes of the card tests reach each branch of the scatter
    # and of roulette on hit lanes: the degenerate Lambertian guard, metal
    # absorbed below the horizon and kept, total internal reflection,
    # Schlick's reflection and refraction, emission, and roulette's
    # survivors and victims.
    s, h = shade_inputs(4099, seed=3, depth_idx=3)
    uni = sampling.stream_uniforms(s.keys, sampling.STREAM_BOUNCE0 + 3,
                                   sampling.UNIFORMS_PER_BOUNCE)
    live_hit = s.alive & (h["t"] < BIG)
    (sdx, sdy, sdz, _, _, _, ok, _, _, _, _) = itf._scatter_flat(
        h["mat"], h["ax"], h["ay"], h["az"], h["fuzz"], h["ior"], h["ex"],
        h["ey"], h["ez"], s.dx, s.dy, s.dz, h["nx"], h["ny"], h["nz"],
        h["ff"] > 0, uni)
    mat = h["mat"]
    lam = live_hit & (mat == 0)
    degen = lam & (sdx == h["nx"]) & (sdy == h["ny"]) & (sdz == h["nz"])
    assert int(degen.sum()) > 10 and int((lam & ~degen).sum()) > 100
    met = live_hit & (mat == 1)
    assert int((met & ok).sum()) > 10 and int((met & ~ok).sum()) > 10
    die = live_hit & (mat == 2) & torch.isfinite(sdx)
    ratio = torch.where(h["ff"] > 0, 1.0 / h["ior"], h["ior"])
    u = torch.stack([s.dx, s.dy, s.dz], 1)
    u = u / u.norm(dim=1, keepdim=True)
    n = torch.stack([h["nx"], h["ny"], h["nz"]], 1)
    cos_t = (-(u * n).sum(1)).clamp(max=1.0)
    tir = ratio * (1 - cos_t * cos_t).clamp(min=0).sqrt() > 1
    assert int((die & tir).sum()) > 10 and int((die & ~tir).sum()) > 10
    assert int((live_hit & (mat == 3)).sum()) > 10
    got = itf._shade_plain(s, h, 3, 2, 1.0, None)
    cont = live_hit & ok
    assert int((cont & got.alive).sum()) > 100
    assert int((cont & ~got.alive).sum()) > 100
