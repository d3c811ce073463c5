"""Counter-based RNG and closed-form samplers (counterpart of
``qt_raytracer_tpu.core.sampling``, both branches, bit for bit).

A PRNG key is the two uint32 words of a JAX threefry key, held in an int64
tensor of shape [2] (``key_data(jax.random.PRNGKey(s)) == [0, s]``); an int
seed s stands for the words [0, s]. Two RNGs hang off it:

``rng="hash"`` (lowbias32, cheap):

    pixel_state  = lowbias32(pixel * GOLDEN + lowbias32(k0 ^ lowbias32(k1)))
    sample_state = lowbias32(pixel_state ^ sample * GOLDEN)
    uniforms     = lowbias32(lowbias32(sample_state + stream * GOLDEN
                                       + slot * WEYL2) + GOLDEN) >> 8, * 2^-24

``rng="threefry"`` (jax.random's own bits, with
``jax_threefry_partitionable=True``):

    pixel_key  = fold_in(key, pixel)
    sample_key = fold_in(pixel_key, sample)
    uniforms   = jax.random.uniform(fold_in(sample_key, stream), (n,))

Hash states are [N] tensors, threefry keys [N, 2]; the dimension tells them
apart, as in the JAX package. There is no global RNG state: every value is a
pure function of the key and the pixel, sample, stream and slot ids. Words
are uint32 values carried in int64 tensors, because torch's uint32 lacks `+`
and `>>` on the CPU; every `+`, `*` and `<<` is masked back to 32 bits (the
low 32 bits of an int64 product are exact even when the product wraps).
"""

from __future__ import annotations

import torch

from ..runtime.spans import RNG, spanned

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
_THREEFRY_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    """Wellons' lowbias32 permutation on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK
    return x ^ (x >> 16)


def _as_u32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def prng_key(seed: int, device=None) -> torch.Tensor:
    """Key words [0, seed] of ``jax.random.PRNGKey(seed)``, 0 <= seed < 2^32."""
    seed = int(seed)
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def key_words(key, device=None) -> torch.Tensor:
    """[2] int64 key words of an int seed or of a key, on `device`."""
    if isinstance(key, int):
        return prng_key(key, device)
    if not isinstance(key, torch.Tensor) or key.shape != (2,):
        raise ValueError(f"a key is an int seed or a [2] tensor of uint32 "
                         f"words, got {key!r}")
    return _as_u32(key, device if device is not None else key.device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 words in int64,
    broadcasting over its four operands; returns (y0, y1). The round and
    key-injection order of jax's threefry2x32 primitive."""
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` on key words [..., 2] and uint32 data (an int or
    a tensor that broadcasts against the key's leading dimensions)."""
    key = _as_u32(key, key.device)
    d = _as_u32(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def hash_pixel_states(key, pixel_index: torch.Tensor) -> torch.Tensor:
    """[N] per-pixel hash states (uint32 values in int64) of a key (or an
    int seed: the words [0, seed])."""
    dev = pixel_index.device
    words = key_words(key, dev)
    seed = words[0] ^ _lowbias32(words[1])
    px = _as_u32(pixel_index, dev)
    return _lowbias32((((px * GOLDEN) & _MASK) + _lowbias32(seed)) & _MASK)


@spanned(RNG)
def pixel_states(key, pixel_index: torch.Tensor,
                 rng: str = "hash") -> torch.Tensor:
    """Per-pixel RNG states for explicit pixel indices [N]: [N] hash states
    or [N, 2] threefry keys."""
    if rng == "hash":
        return hash_pixel_states(key, pixel_index)
    if rng == "threefry":
        return fold_in(key_words(key, pixel_index.device), pixel_index)
    raise ValueError(f"unknown rng {rng!r}")


def _is_hash_state(x: torch.Tensor) -> bool:
    return x.dim() == 1


@spanned(RNG)
def sample_keys(pix_keys: torch.Tensor, sample_index) -> torch.Tensor:
    """Per-pixel state for one sample index; sample_index is an int or a
    per-pixel [N] tensor (merged sample batches)."""
    if _is_hash_state(pix_keys):
        ids = _as_u32(sample_index, pix_keys.device)
        return _lowbias32(pix_keys ^ ((ids * GOLDEN) & _MASK))
    return fold_in(pix_keys, sample_index)


@spanned(RNG)
def stream_uniforms(samp_keys: torch.Tensor, stream_id: int,
                    n: int) -> torch.Tensor:
    """[N, n] float32 uniforms in [0, 1) for one stream of each state."""
    slots = torch.arange(n, dtype=torch.int64, device=samp_keys.device)
    if _is_hash_state(samp_keys):
        stream = (int(stream_id) * GOLDEN) & _MASK
        offset = (stream + slots * WEYL2) & _MASK
        counters = (samp_keys[:, None] + offset[None, :]) & _MASK
        bits = _lowbias32((_lowbias32(counters) + GOLDEN) & _MASK)
        return (bits >> 8).to(torch.float32) * 2.0 ** -24
    # jax.random.uniform with jax_threefry_partitionable: counter i of the
    # 64-bit iota is the word pair (0, i); the bits are y0 ^ y1; the top 23
    # of them fill the mantissa of a float in [1, 2), less 1.
    k = fold_in(samp_keys, stream_id)
    y0, y1 = threefry2x32(k[:, 0:1], k[:, 1:2], torch.zeros_like(slots),
                          slots)
    mant = ((y0 ^ y1) >> 9) | _ONE_F32_BITS
    return mant.to(torch.int32).view(torch.float32) - 1.0


def random_in_unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk, z=0 (closed-form polar), [N, 3]."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.zeros_like(r)], dim=-1)


def random_unit_vector(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere (closed form), [N, 3]."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 1.0e-20))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def random_in_unit_sphere(u1, u2, u3) -> torch.Tensor:
    """Uniform point inside the unit ball: a direction times cbrt(u3)."""
    return random_unit_vector(u1, u2) * torch.pow(u3, 1.0 / 3.0)[..., None]
