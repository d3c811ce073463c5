"""Top-level render API (counterpart of ``qt_raytracer_tpu.core.render``):
``render(scene, camera, config, key) -> image``.

The render runs on the device of the scene's tensors (a SphereScene or a
World); the camera must live there too. ``key`` is an int seed (the key
words [0, seed]) or a [2] tensor of key words. Pixel conventions match the
reference (RayTracerFboItem.cpp:102-127): row 0 is the top of the image, v
uses j = height-1-row, u = (i + jitter)/(width-1),
v = (j + jitter)/(height-1). The JAX package's ``lax.map`` over pixel chunks
and ``lax.scan`` over sample batches are Python loops here, with the same
padding rule and summation order.

A render of tensors that require grad runs with autograd on, each (chunk,
sample batch) under ``torch.utils.checkpoint`` (the counterpart of the JAX
package's ``jax.checkpoint``): the backward recomputes one batch at a time
instead of keeping every batch's per-bounce tensors. The recompute is exact,
because the RNG is counter-based and the kernels are deterministic. Other
renders run under ``torch.no_grad``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import camera as cam_mod
from . import sampling, tonemap
from .config import RenderConfig, mesh_search_options
from .integrator import trace
from .integrator_flat import build_tables, trace_flat, trace_flat_world
from .scene import SphereScene
from .world import World, tensors_of
from ..runtime import spans

# Auto-chunk constants, as in the JAX package: chunks are multiples of the
# 1024-ray kernel tile, ~414,720 rays (5 chunks at 1080p), and images under
# 256Ki rays are not split.
_CHUNK_TILE = 1024
_CHUNK_TARGET = 414720
_CHUNK_MIN_RAYS = 262144


def resolve_intersector(cfg: RenderConfig) -> str:
    """cfg.intersector with "auto" mapped to "fused": the flat path, whose
    kernels run on CUDA tensors and whose plain versions run on CPU
    tensors."""
    return "fused" if cfg.intersector == "auto" else cfg.intersector


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


def _route(scene, cfg: RenderConfig):
    """(scene, route) as the JAX package routes. A World without a mesh
    renders its spheres. "fused*" on a SphereScene takes trace_flat
    (route "flat"; diff=True for "fused_diff*"); "fused"/"fused_interpret"
    on a mesh world take trace_flat_world ("flat_world"); "fused_diff*" on
    a mesh world and "pallas*" anywhere take the [N,3] integrator trace
    with "pallas[_interpret]"; "xla" takes it with "xla", on sphere scenes
    and mesh worlds alike. Any route but the two flat ones is the
    integrator's intersector."""
    backend = resolve_intersector(cfg)
    if isinstance(scene, World) and scene.mesh is None:
        scene = scene.spheres
    if backend.startswith("fused"):
        if isinstance(scene, SphereScene):
            return scene, "flat"
        if not backend.startswith("fused_diff"):
            return scene, "flat_world"
        return scene, ("pallas_interpret" if backend.endswith("interpret")
                       else "pallas")
    return scene, backend


def _trace_dispatch(scene, origins, directions, samp_keys, cfg: RenderConfig,
                    tables=None):
    """Trace along _route(scene, cfg). Both mesh paths get cfg's
    mesh-search options (which "xla" ignores); cfg.mesh_compact and
    cfg.mesh_sort0 belong to the flat world path alone, as in JAX. tables:
    the flat route's shared_tables(scene, cfg), or None to build them in
    the trace."""
    backend = resolve_intersector(cfg)
    kw = dict(nee=cfg.nee, rr_start=cfg.rr_start)
    mesh_kw = mesh_search_options(cfg)
    scene, route = _route(scene, cfg)
    interpret = backend.endswith("interpret")
    if route == "flat":
        return trace_flat(scene, origins, directions, samp_keys,
                          cfg.max_depth, cfg.t_min, interpret=interpret,
                          diff=backend.startswith("fused_diff"),
                          tables=tables, **kw)
    if route == "flat_world":
        return trace_flat_world(scene, origins, directions, samp_keys,
                                cfg.max_depth, cfg.t_min,
                                interpret=interpret,
                                compact=cfg.mesh_compact,
                                mesh_sort0=cfg.mesh_sort0, tables=tables,
                                **kw, **mesh_kw)
    return trace(scene, origins, directions, samp_keys, cfg.max_depth,
                 cfg.t_min, intersector=route, **kw, **mesh_kw)


def shared_tables(scene, cfg: RenderConfig):
    """The kernel tables of the flat trace that scene takes under cfg,
    built once (integrator_flat.build_tables, with cfg's cluster rows and
    mt) for every trace of a forward render: they are a deterministic
    function of the unchanged scene, so each trace reads the bits it would
    build. None where the trace builds its own: a route but the two flat
    ones, and edge-aware renders. Call it only without autograd: under
    grad each checkpointed (chunk, batch) rebuilds its differentiable
    parameter table, the recompute too."""
    scene, route = _route(scene, cfg)
    if cfg.edge_aware or route not in ("flat", "flat_world"):
        return None
    return build_tables(scene, cfg.mesh_cluster_rows, cfg.mesh_mt)


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
                     sample_idx: int, tables=None):
    """Trace one sample for every pixel; returns [N,3] linear radiance.
    With cfg.edge_aware, the same radiance plus the primal-zero boundary
    term of ``diff.edge``. tables as _trace_dispatch."""
    if cfg.edge_aware:
        from ..diff.edge import sample_radiance_edge_aware

        return sample_radiance_edge_aware(scene, camera, cfg, pix_keys,
                                          i, j, sample_idx)
    samp_keys = sampling.sample_keys(pix_keys, sample_idx)
    origins, directions = _camera_rays(camera, cfg, samp_keys, i, j)
    return _trace_dispatch(scene, origins, directions, samp_keys, cfg,
                           tables)


def _merged_batch_radiance(scene, camera, cfg: RenderConfig, pix_keys, i, j,
                           batch_idx: int, spb: int, tables=None):
    """Trace spb samples of every pixel as one merged wavefront; the
    per-pixel sum runs in ascending sample order. tables as
    _trace_dispatch."""
    n = i.shape[0]
    rep = lambda x: torch.cat([x] * spb)
    sample_ids = batch_idx * spb + torch.arange(
        spb, dtype=torch.int64, device=i.device).repeat_interleave(n)
    samp_keys = sampling.sample_keys(rep(pix_keys), sample_ids)
    origins, directions = _camera_rays(camera, cfg, samp_keys, rep(i), rep(j))
    rad = _trace_dispatch(scene, origins, directions, samp_keys, cfg,
                          tables).reshape(spb, n, 3)
    acc = rad[0]
    for k in range(1, spb):
        acc = acc + rad[k]
    return acc


def _check_devices(scene, camera) -> torch.device:
    dev = scene.device
    if camera.device != dev:
        raise ValueError(f"scene is on {dev} but camera is on {camera.device}")
    return dev


def needs_grad(scene, camera) -> bool:
    """True when autograd is on and a scene or camera tensor requires
    grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors_of(scene) + tensors_of(camera))


def accumulate_pixels(scene, camera, cfg: RenderConfig, key, pixel_index,
                      first_sample: int, num_samples: int,
                      spb: int) -> torch.Tensor:
    """Sum of samples [first_sample, first_sample + num_samples) of the
    flat pixels pixel_index (row*W + col), [N, 3] f32: spb samples a batch
    (a merged wavefront when spb > 1; both counts multiples of spb), summed
    in ascending batch order from zeros. The pixels go in chunks of
    resolve_pixel_chunk(cfg), the last one padded to the chunk's shape by
    replaying the first pixels (their keys are real; the results are sliced
    off); each (chunk, batch) runs under ``torch.utils.checkpoint`` when a
    scene or camera tensor requires grad, and builds its own kernel tables;
    otherwise the render builds them once (shared_tables) for every (chunk,
    batch). The building block of ``render_linear`` and of the sharded
    render's pixel range."""
    dev = _check_devices(scene, camera)
    grad = needs_grad(scene, camera)
    with torch.set_grad_enabled(grad):
        tables = None if grad else shared_tables(scene, cfg)
        i = (pixel_index % cfg.width).to(torch.float32)
        j = (cfg.height - 1 - pixel_index // cfg.width).to(torch.float32)
        pix_keys = sampling.pixel_states(key, pixel_index, cfg.rng)
        batches = range(first_sample // spb,
                        (first_sample + num_samples) // spb)

        def one_batch(pk, ic, jc, b):
            # The span opens inside what checkpoint wraps: the recompute
            # in the backward opens it again.
            with spans.annotate(spans.CHUNK):
                if spb == 1:
                    return _sample_radiance(scene, camera, cfg, pk, ic, jc,
                                            b, tables)
                return _merged_batch_radiance(scene, camera, cfg, pk, ic, jc,
                                              b, spb, tables)

        def render_chunk(pk, ic, jc):
            accum = torch.zeros((ic.shape[0], 3), dtype=torch.float32,
                                device=dev)
            for b in batches:
                if grad:
                    out = checkpoint(one_batch, pk, ic, jc, b,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
                else:
                    out = one_batch(pk, ic, jc, b)
                accum = accum + out
            return accum

        n = pixel_index.shape[0]
        chunk = resolve_pixel_chunk(cfg)
        if chunk <= 0 or chunk >= n:
            return render_chunk(pix_keys, i, j)
        n_pad = (-n) % chunk
        pad = lambda x: torch.cat([x, x[:n_pad]]) if n_pad else x
        pk, ip, jp = pad(pix_keys), pad(i), pad(j)
        return torch.cat([
            render_chunk(pk[lo:lo + chunk], ip[lo:lo + chunk],
                         jp[lo:lo + chunk])
            for lo in range(0, n + n_pad, chunk)])[:n]


def render_linear(scene, camera, cfg: RenderConfig, key) -> torch.Tensor:
    """Sum of spp linear radiance samples, [H, W, 3] f32 (row 0 = top), on
    the scene's device. Divide by cfg.spp (or use tonemap.resolve) for the
    mean image. Differentiable when a scene or camera tensor requires grad
    (with a grad-capable intersector, see diff.inverse.grad_capable_config)."""
    dev = _check_devices(scene, camera)
    pixel_index = torch.arange(cfg.num_pixels, device=dev)
    accum = accumulate_pixels(scene, camera, cfg, key, pixel_index, 0,
                              cfg.spp, cfg.samples_per_batch)
    return accum.reshape(cfg.height, cfg.width, 3)


def render(scene, camera, cfg: RenderConfig, key) -> torch.Tensor:
    """Full batch render -> uint8 image [H, W, 3] (gamma-2, quantized)."""
    accum = render_linear(scene, camera, cfg, key)
    return tonemap.to_uint8(accum, cfg.spp, cfg.quantizer)


def render_sample_batch(scene, camera, cfg: RenderConfig, key,
                        start_sample: int, num_samples: int) -> torch.Tensor:
    """Linear radiance sum [H, W, 3] of samples [start, start + num), one
    wavefront per sample over the whole image (the progressive building
    block; no chunking, as in the JAX package). Without autograd the kernel
    tables are built once for every sample (shared_tables)."""
    dev = _check_devices(scene, camera)
    grad = needs_grad(scene, camera)
    with torch.set_grad_enabled(grad):
        tables = None if grad else shared_tables(scene, cfg)
        i, j, pixel_index = pixel_grid(cfg, dev)
        pix_keys = sampling.pixel_states(key, pixel_index, cfg.rng)
        accum = torch.zeros((cfg.num_pixels, 3), dtype=torch.float32,
                            device=dev)
        for k in range(num_samples):
            accum = accum + _sample_radiance(scene, camera, cfg, pix_keys, i,
                                             j, int(start_sample) + k, tables)
        return accum.reshape(cfg.height, cfg.width, 3)
