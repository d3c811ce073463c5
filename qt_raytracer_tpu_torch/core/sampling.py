"""Counter-based hash RNG and closed-form samplers (the ``rng="hash"``
branch of ``qt_raytracer_tpu.core.sampling``, bit for bit).

Hierarchy, as in the JAX package:

    pixel_state  = lowbias32(pixel * GOLDEN + lowbias32(lowbias32(seed)))
    sample_state = lowbias32(pixel_state ^ sample * GOLDEN)
    uniforms     = lowbias32(lowbias32(sample_state + stream * GOLDEN
                                       + slot * WEYL2) + GOLDEN) >> 8, * 2^-24

There is no global RNG state: every value is a pure function of an integer
seed and the pixel, sample, stream and slot ids. States are uint32 values
carried in int64 tensors, because torch's uint32 lacks `+` and `>>` on the
CPU; every `+` and `*` is masked back to 32 bits (the low 32 bits of an
int64 product are exact even when the product wraps).
"""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586

# Stream ids inside one sample. Bounce b uses STREAM_BOUNCE0 + b.
STREAM_GEN = 0        # pixel jitter (2) + lens disk (2)
STREAM_BOUNCE0 = 1

# Uniform slot layout of the per-bounce [*, 8] block:
#   0,1 -> unit-vector angles; 2 -> in-sphere radius (metal fuzz);
#   3 -> dielectric reflect-vs-refract; 4..7 -> NEE (7: Russian roulette).
UNIFORMS_PER_BOUNCE = 8
UNIFORMS_GEN = 4

GOLDEN = 0x9E3779B9   # 2^32 / phi (Weyl increment)
WEYL2 = 0x85EBCA77
_MASK = 0xFFFFFFFF


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    """Wellons' lowbias32 permutation on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK
    return x ^ (x >> 16)


def _as_u32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def hash_pixel_states(seed: int, pixel_index: torch.Tensor) -> torch.Tensor:
    """[N] per-pixel hash states (uint32 values in int64).

    Equals the JAX package's states for ``jax.random.PRNGKey(seed)``, whose
    key words are [0, seed] for 0 <= seed < 2^32.
    """
    seed = int(seed)
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    dev = pixel_index.device
    words = _lowbias32(torch.tensor([seed], dtype=torch.int64, device=dev))
    mixed = _lowbias32(words)          # lowbias32(0 ^ lowbias32(seed))
    px = _as_u32(pixel_index, dev)
    return _lowbias32((((px * GOLDEN) & _MASK) + mixed) & _MASK)


def pixel_states(seed: int, pixel_index: torch.Tensor,
                 rng: str = "hash") -> torch.Tensor:
    """Per-pixel RNG states for explicit pixel indices [N]."""
    if rng == "hash":
        return hash_pixel_states(seed, pixel_index)
    if rng == "threefry":
        raise NotImplementedError(
            "rng='threefry' is not ported yet: ROADMAP Queue A item 6")
    raise ValueError(f"unknown rng {rng!r}")


def sample_keys(pix_keys: torch.Tensor, sample_index) -> torch.Tensor:
    """Per-pixel state for one sample index; sample_index is an int or a
    per-pixel [N] tensor (merged sample batches)."""
    ids = _as_u32(sample_index, pix_keys.device)
    return _lowbias32(pix_keys ^ ((ids * GOLDEN) & _MASK))


def stream_uniforms(samp_keys: torch.Tensor, stream_id: int,
                    n: int) -> torch.Tensor:
    """[N, n] float32 uniforms in [0, 1) for one stream of each state."""
    slots = torch.arange(n, dtype=torch.int64, device=samp_keys.device)
    stream = (int(stream_id) * GOLDEN) & _MASK
    offset = (stream + slots * WEYL2) & _MASK
    counters = (samp_keys[:, None] + offset[None, :]) & _MASK
    bits = _lowbias32((_lowbias32(counters) + GOLDEN) & _MASK)
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def random_in_unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk, z=0 (closed-form polar), [N, 3]."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.zeros_like(r)], dim=-1)

