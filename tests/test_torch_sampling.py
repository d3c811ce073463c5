"""Port of the hash RNG (qt_raytracer_tpu_torch.core.sampling) against the
JAX package, bit for bit: pixel states, sample states and stream uniforms
over pixel indices up to a 1920x1080 frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.core import sampling as jsam
from qt_raytracer_tpu_torch.core import sampling as tsam

N_PIX_1080P = 1920 * 1080


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (CLAUDE.md).
    jax.clear_caches()
    yield


def _pixels():
    rng = np.random.default_rng(11)
    idx = np.concatenate([np.arange(2048), rng.integers(0, N_PIX_1080P, 6000),
                          np.arange(N_PIX_1080P - 2048, N_PIX_1080P)])
    return idx.astype(np.uint32)


def _jax_states(seed, pix):
    return np.asarray(jsam.hash_pixel_states(jax.random.PRNGKey(seed),
                                             jnp.asarray(pix)))


def _torch_u32(x: torch.Tensor) -> np.ndarray:
    arr = x.numpy()
    assert arr.min() >= 0 and arr.max() <= 0xFFFFFFFF
    return arr.astype(np.uint32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_hash_pixel_states_bitwise(seed):
    pix = _pixels()
    np.testing.assert_array_equal(
        _torch_u32(tsam.hash_pixel_states(seed, _t(pix))),
        _jax_states(seed, pix))
    np.testing.assert_array_equal(
        _torch_u32(tsam.pixel_states(seed, _t(pix), "hash")),
        _jax_states(seed, pix))


@pytest.mark.parametrize("seed", [0, 123456789])
def test_sample_keys_scalar_and_per_ray_bitwise(seed):
    pix = _pixels()
    states = _jax_states(seed, pix)
    for sample in (0, 1, 999):
        np.testing.assert_array_equal(
            _torch_u32(tsam.sample_keys(_t(states), sample)),
            np.asarray(jsam.sample_keys(jnp.asarray(states), sample)))
    ids = np.random.default_rng(seed).integers(0, 1000, pix.size).astype(np.uint32)
    np.testing.assert_array_equal(
        _torch_u32(tsam.sample_keys(_t(states), _t(ids))),
        np.asarray(jsam.sample_keys(jnp.asarray(states), jnp.asarray(ids))))


@pytest.mark.parametrize("stream,n", [
    (tsam.STREAM_GEN, tsam.UNIFORMS_GEN),
    (tsam.STREAM_BOUNCE0, tsam.UNIFORMS_PER_BOUNCE),
    (tsam.STREAM_BOUNCE0 + 9, tsam.UNIFORMS_PER_BOUNCE),
])
def test_stream_uniforms_bitwise(stream, n):
    states = _jax_states(7, _pixels())
    keys = np.asarray(jsam.sample_keys(jnp.asarray(states), 3))
    got = tsam.stream_uniforms(_t(keys), stream, n)
    assert got.dtype == torch.float32 and got.shape == (keys.size, n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsam.stream_uniforms(jnp.asarray(keys), stream, n)))


def test_constants_match():
    assert tsam.STREAM_GEN == jsam.STREAM_GEN
    assert tsam.STREAM_BOUNCE0 == jsam.STREAM_BOUNCE0
    assert tsam.UNIFORMS_GEN == jsam.UNIFORMS_GEN
    assert tsam.UNIFORMS_PER_BOUNCE == jsam.UNIFORMS_PER_BOUNCE
    assert tsam.GOLDEN == int(jsam.GOLDEN) and tsam.WEYL2 == int(jsam.WEYL2)


def test_random_in_unit_disk_matches():
    rng = np.random.default_rng(3)
    u1, u2 = rng.random((2, 4096), dtype=np.float32)
    got = tsam.random_in_unit_disk(torch.from_numpy(u1), torch.from_numpy(u2))
    want = np.asarray(jsam.random_in_unit_disk(jnp.asarray(u1), jnp.asarray(u2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError):
        tsam.hash_pixel_states(2 ** 32, torch.arange(4))
    with pytest.raises(ValueError, match="unknown rng"):
        tsam.pixel_states(0, torch.arange(4), "xorshift")
