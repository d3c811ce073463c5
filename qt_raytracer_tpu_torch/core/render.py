"""Top-level render API (counterpart of ``qt_raytracer_tpu.core.render``):
``render(scene, camera, config, seed) -> image``.

The render runs on the device of the scene's tensors; the camera must live
there too. Pixel conventions match the reference (RayTracerFboItem.cpp:
102-127): row 0 is the top of the image, v uses j = height-1-row,
u = (i + jitter)/(width-1), v = (j + jitter)/(height-1). The JAX package's
``lax.map`` over pixel chunks and ``lax.scan`` over sample batches are Python
loops here, with the same padding rule and summation order.
"""

from __future__ import annotations

import torch

from . import camera as cam_mod
from . import sampling, tonemap
from .config import RenderConfig, require_ported
from .integrator_flat import trace_flat

# Auto-chunk constants, as in the JAX package: chunks are multiples of the
# 1024-ray kernel tile, ~414,720 rays (5 chunks at 1080p), and images under
# 256Ki rays are not split.
_CHUNK_TILE = 1024
_CHUNK_TARGET = 414720
_CHUNK_MIN_RAYS = 262144


def resolve_pixel_chunk(cfg: RenderConfig) -> int:
    """Effective pixel chunk size: cfg.pixel_chunk, or the auto heuristic
    when it is 0 (-1 disables chunking). Returns 0 for "no chunking"."""
    if cfg.pixel_chunk > 0:
        return cfg.pixel_chunk
    if cfg.pixel_chunk < 0:
        return 0
    n = cfg.num_pixels
    if n < _CHUNK_MIN_RAYS:
        return 0
    n_chunks = max(2, round(n / _CHUNK_TARGET))
    per_chunk = -(-n // n_chunks)
    return -(-per_chunk // _CHUNK_TILE) * _CHUNK_TILE


def _trace_dispatch(scene, origins, directions, samp_keys, cfg: RenderConfig):
    # "auto" and "fused" launch the kernel on CUDA tensors and take its plain
    # version on CPU tensors; "fused_interpret" takes the plain version.
    return trace_flat(scene, origins, directions, samp_keys, cfg.max_depth,
                      cfg.t_min, nee=cfg.nee, rr_start=cfg.rr_start,
                      interpret=cfg.intersector == "fused_interpret")


def pixel_grid(cfg: RenderConfig, device=None):
    """Flat per-pixel (i, j, pixel_index) in image order: i, j are f32
    viewport coordinates with j = height-1-row; pixel_index = row*W + col."""
    h, w = cfg.height, cfg.width
    py, px = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    i = px.reshape(-1).to(torch.float32)
    j = (h - 1 - py).reshape(-1).to(torch.float32)
    pixel_index = (py * w + px).reshape(-1)
    return i, j, pixel_index


def _camera_rays(camera, cfg: RenderConfig, samp_keys, i, j):
    gen = sampling.stream_uniforms(samp_keys, sampling.STREAM_GEN,
                                   sampling.UNIFORMS_GEN)
    inv_w = 1.0 / max(cfg.width - 1, 1)
    inv_h = 1.0 / max(cfg.height - 1, 1)
    s = (i + gen[:, 0]) * inv_w
    t = (j + gen[:, 1]) * inv_h
    return cam_mod.get_rays(camera, s, t, gen[:, 2], gen[:, 3])


def _sample_radiance(scene, camera, cfg: RenderConfig, pix_keys, i, j,
                     sample_idx: int):
    """Trace one sample for every pixel; returns [N,3] linear radiance."""
    samp_keys = sampling.sample_keys(pix_keys, sample_idx)
    origins, directions = _camera_rays(camera, cfg, samp_keys, i, j)
    return _trace_dispatch(scene, origins, directions, samp_keys, cfg)


def _merged_batch_radiance(scene, camera, cfg: RenderConfig, pix_keys, i, j,
                           batch_idx: int, spb: int):
    """Trace spb samples of every pixel as one merged wavefront; the
    per-pixel sum runs in ascending sample order."""
    n = i.shape[0]
    rep = lambda x: torch.cat([x] * spb)
    sample_ids = batch_idx * spb + torch.arange(
        spb, dtype=torch.int64, device=i.device).repeat_interleave(n)
    samp_keys = sampling.sample_keys(rep(pix_keys), sample_ids)
    origins, directions = _camera_rays(camera, cfg, samp_keys, rep(i), rep(j))
    rad = _trace_dispatch(scene, origins, directions, samp_keys,
                          cfg).reshape(spb, n, 3)
    acc = rad[0]
    for k in range(1, spb):
        acc = acc + rad[k]
    return acc


@torch.no_grad()
def render_linear(scene, camera, cfg: RenderConfig, seed: int) -> torch.Tensor:
    """Sum of spp linear radiance samples, [H, W, 3] f32 (row 0 = top), on
    the scene's device. Divide by cfg.spp (or use tonemap.resolve) for the
    mean image."""
    require_ported(cfg)
    dev = scene.device
    if camera.device != dev:
        raise ValueError(f"scene is on {dev} but camera is on {camera.device}")
    i, j, pixel_index = pixel_grid(cfg, dev)
    pix_keys = sampling.pixel_states(seed, pixel_index, cfg.rng)

    spb = cfg.samples_per_batch
    num_batches = cfg.spp // spb

    def render_chunk(pk, ic, jc):
        accum = torch.zeros((ic.shape[0], 3), dtype=torch.float32, device=dev)
        for b in range(num_batches):
            if spb == 1:
                out = _sample_radiance(scene, camera, cfg, pk, ic, jc, b)
            else:
                out = _merged_batch_radiance(scene, camera, cfg, pk, ic, jc,
                                             b, spb)
            accum = accum + out
        return accum

    n = cfg.num_pixels
    chunk = resolve_pixel_chunk(cfg)
    if chunk <= 0 or chunk >= n:
        accum = render_chunk(pix_keys, i, j)
    else:
        # Pad to a whole number of chunks by replaying the first pixels
        # (their keys are real; the results are sliced off).
        n_pad = (-n) % chunk
        pad = lambda x: torch.cat([x, x[:n_pad]]) if n_pad else x
        pk, ip, jp = pad(pix_keys), pad(i), pad(j)
        accum = torch.cat([
            render_chunk(pk[lo:lo + chunk], ip[lo:lo + chunk],
                         jp[lo:lo + chunk])
            for lo in range(0, n + n_pad, chunk)])[:n]
    return accum.reshape(cfg.height, cfg.width, 3)


def render(scene, camera, cfg: RenderConfig, seed: int) -> torch.Tensor:
    """Full batch render -> uint8 image [H, W, 3] (gamma-2, quantized)."""
    accum = render_linear(scene, camera, cfg, seed)
    return tonemap.to_uint8(accum, cfg.spp, cfg.quantizer)
