"""The renderer's counter-based random stream, as a specification: the
lowbias32 hash RNG (``rng="hash"``) and Threefry-2x32 ``fold_in`` for keys.

Every value is a pure function of a key and the pixel, sample, stream and
slot ids, so the reference can draw the uniforms of any pixel on its own.
Words are uint32 values carried in int64 tensors; every ``+``, ``*`` and
``<<`` is masked back to 32 bits.
"""

from __future__ import annotations

import torch

GOLDEN = 0x9E3779B9
WEYL2 = 0x85EBCA77
MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

STREAM_GEN = 0           # pixel jitter (2) + lens disk (2)
STREAM_BOUNCE0 = 1       # bounce b uses STREAM_BOUNCE0 + b
UNIFORMS_GEN = 4
UNIFORMS_PER_BOUNCE = 8  # 0,1 direction; 2 fuzz radius; 3 Fresnel; 4-6 NEE; 7 RR


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK
    return x ^ (x >> 16)


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 words in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def seed_key(seed: int) -> torch.Tensor:
    """[2] int64 key words of a whole-number seed of up to 64 bits: the high
    and the low word (for seeds under 2**32, jax.random.PRNGKey(seed))."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"a seed is a whole number in [0, 2**64), got {seed}")
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in on [2] key words and a uint32 datum (an int, or a
    tensor of data for a [..., 2] stack of keys)."""
    k = key.to(torch.int64) & MASK
    d = torch.as_tensor(data, dtype=torch.int64) & MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def pixel_states(key: torch.Tensor, pixel_index: torch.Tensor) -> torch.Tensor:
    """[N] hash states of the flat pixels pixel_index (row * W + col), for
    one key ([2] words) or one key per pixel ([N, 2])."""
    words = key.to(pixel_index.device).to(torch.int64) & MASK
    seed = words[..., 0] ^ lowbias32(words[..., 1])
    px = pixel_index.to(torch.int64) & MASK
    return lowbias32((((px * GOLDEN) & MASK) + lowbias32(seed)) & MASK)


def sample_states(pix: torch.Tensor, sample: int) -> torch.Tensor:
    return lowbias32(pix ^ ((int(sample) * GOLDEN) & MASK))


def uniforms(states: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """[N, n] float32 uniforms in [0, 1) of one stream of each state."""
    slots = torch.arange(n, dtype=torch.int64, device=states.device)
    offset = (((int(stream) * GOLDEN) & MASK) + slots * WEYL2) & MASK
    counters = (states[:, None] + offset[None, :]) & MASK
    bits = lowbias32((lowbias32(counters) + GOLDEN) & MASK)
    return (bits >> 8).to(torch.float32) * 2.0 ** -24
