"""Port of the threefry RNG branch and of key handling
(qt_raytracer_tpu_torch.core.sampling) against jax.random, bit for bit:
the Threefry-2x32 block, fold_in, per-pixel keys, sample keys and stream
uniforms (jax.random.uniform under jax_threefry_partitionable, the setting
of this JAX), over uint32 edge values, and hash states from folded keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from qt_raytracer_tpu.core import sampling as jsam
from qt_raytracer_tpu_torch.core import sampling as tsam
from qt_raytracer_tpu_torch.utils.convert import key_from_words

EDGE = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                np.uint32)
SEEDS = [0, 1, 7, 123456789, 0xFFFFFFFF]


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    yield


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _u32(x: torch.Tensor) -> np.ndarray:
    arr = x.numpy()
    assert arr.min() >= 0 and arr.max() <= 0xFFFFFFFF
    return arr.astype(np.uint32)


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


def _pixels():
    rng = np.random.default_rng(4)
    return np.concatenate([EDGE, np.arange(64, dtype=np.uint32),
                           rng.integers(0, 2 ** 32, 256, dtype=np.uint32)])


def test_threefry2x32_block_bitwise():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, (2, 512), dtype=np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 512), dtype=np.uint32)
    k[:, :EDGE.size], x[:, :EDGE.size] = EDGE, EDGE[::-1]
    want = jprng.threefry2x32_p.bind(*map(jnp.asarray, (k[0], k[1], x[0],
                                                          x[1])))
    got = tsam.threefry2x32(*map(_t, (k[0], k[1], x[0], x[1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(tsam.prng_key(seed)), _words(key))
    for data in EDGE:
        np.testing.assert_array_equal(
            _u32(tsam.fold_in(tsam.prng_key(seed), int(data))),
            _words(jax.random.fold_in(key, data)))
    # A batch of keys folded with per-key data, as merged sample batches do.
    keys = np.stack([_words(jax.random.fold_in(key, d)) for d in EDGE])
    want = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(EDGE))
    np.testing.assert_array_equal(
        _u32(tsam.fold_in(_t(keys), _t(EDGE))), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_pixel_states_and_sample_keys_threefry_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    pix = _pixels()
    want = np.asarray(jsam.pixel_states(key, jnp.asarray(pix), "threefry"))
    got = tsam.pixel_states(seed, _t(pix), "threefry")
    assert got.shape == (pix.size, 2)
    np.testing.assert_array_equal(_u32(got), want)
    for sample in (0, 1, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            _u32(tsam.sample_keys(got, sample)),
            np.asarray(jsam.sample_keys(jnp.asarray(want), sample)))
    ids = np.resize(EDGE, pix.size)
    np.testing.assert_array_equal(
        _u32(tsam.sample_keys(got, _t(ids))),
        np.asarray(jsam.sample_keys(jnp.asarray(want), jnp.asarray(ids))))


@pytest.mark.parametrize("stream,n", [
    (tsam.STREAM_GEN, tsam.UNIFORMS_GEN),
    (tsam.STREAM_BOUNCE0, tsam.UNIFORMS_PER_BOUNCE),
    (tsam.STREAM_BOUNCE0 + 9, tsam.UNIFORMS_PER_BOUNCE),
    (0xFFFFFFFF, 3),
])
def test_stream_uniforms_threefry_bitwise(stream, n):
    pix = _pixels()
    keys = np.asarray(jsam.sample_keys(
        jsam.pixel_states(jax.random.PRNGKey(3), jnp.asarray(pix),
                          "threefry"), 5))
    got = tsam.stream_uniforms(_t(keys), stream, n)
    assert got.dtype == torch.float32 and got.shape == (pix.size, n)
    want = np.asarray(jsam.stream_uniforms(jnp.asarray(keys), stream, n))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


@pytest.mark.parametrize("fold", [101, 202, 0, 3])
def test_hash_states_from_folded_keys_bitwise(fold):
    # Per-view keys fold_in(key, v) and the dual loss's fold_in(key,
    # 101/202) feed the hash RNG through their key words.
    key = jax.random.fold_in(jax.random.PRNGKey(7), fold)
    pix = _pixels()
    want = np.asarray(jsam.hash_pixel_states(key, jnp.asarray(pix)))
    words = tsam.fold_in(tsam.prng_key(7), fold)
    np.testing.assert_array_equal(_u32(tsam.hash_pixel_states(words, _t(pix))),
                                  want)
    np.testing.assert_array_equal(
        _u32(tsam.pixel_states(key_from_words(_words(key)), _t(pix),
                               "hash")), want)


def test_key_words_and_refusals():
    np.testing.assert_array_equal(key_from_words(np.array([3, 9], np.uint32))
                                  .numpy(), [3, 9])
    np.testing.assert_array_equal(tsam.key_words(5).numpy(), [0, 5])
    with pytest.raises(ValueError):
        tsam.prng_key(2 ** 32)
    with pytest.raises(ValueError):
        tsam.key_words(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        key_from_words(np.arange(3))
    with pytest.raises(ValueError):
        tsam.pixel_states(0, torch.arange(4), "philox")
