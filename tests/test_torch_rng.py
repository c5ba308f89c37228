"""ray_tpu_torch.ops.rng against ray_tpu.ops.rng: bit-exact.

The port computes 32-bit words in int64 (PyTorch's CPU uint32 has no shifts
or adds); every output is compared as uint32 bits, floats included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import rng as jrng
from ray_tpu_torch.ops import rng as trng


def _words(seed, n=4096):
    return np.random.RandomState(seed).randint(
        0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bits(x):
    """uint32 view of a port or reference output (int words or float32)."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.uint32)
    return x.astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["hash_u32", "reverse_bits32"])
def test_unary_bit_exact(fn, seed):
    x = _words(seed)
    np.testing.assert_array_equal(
        _bits(getattr(trng, fn)(_t(x))), _bits(getattr(jrng, fn)(jnp.asarray(x))))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(
    "fn", ["hash_combine", "laine_karras_permutation", "nested_uniform_scramble"])
def test_binary_bit_exact(fn, seed):
    a, b = _words(seed), _words(seed + 100)
    np.testing.assert_array_equal(
        _bits(getattr(trng, fn)(_t(a), _t(b))),
        _bits(getattr(jrng, fn)(jnp.asarray(a), jnp.asarray(b))))


def test_sobol02_bit_exact():
    idx = np.arange(1 << 16, dtype=np.uint32)
    tx, ty = trng.sobol02(_t(idx))
    jx, jy = jrng.sobol02(jnp.asarray(idx))
    np.testing.assert_array_equal(_bits(tx), _bits(jx))
    np.testing.assert_array_equal(_bits(ty), _bits(jy))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scrambled_2d_rand_bit_exact(seed):
    r = np.random.RandomState(seed)
    pix = _words(seed, 2048)
    dims = r.randint(0, 64, size=2048).astype(np.uint32)
    samples = r.randint(0, 1 << 20, size=2048).astype(np.uint32)
    tx, ty = trng.scrambled_2d_rand(_t(dims), _t(pix), _t(samples))
    jx, jy = jrng.scrambled_2d_rand(
        jnp.asarray(dims), jnp.asarray(pix), jnp.asarray(samples))
    assert tx.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tx), _bits(jx))
    np.testing.assert_array_equal(_bits(ty), _bits(jy))


@pytest.mark.parametrize("dim,sample", [(0, 0), (3, 7), (41, 65535)])
def test_scrambled_2d_rand_scalar_dims(dim, sample):
    """The integrator passes dims and sample indices as Python ints."""
    pix = _words(dim + 5, 1024)
    tx, ty = trng.scrambled_2d_rand(dim, _t(pix), sample)
    jx, jy = jrng.scrambled_2d_rand(
        jnp.uint32(dim), jnp.asarray(pix), jnp.uint32(sample))
    np.testing.assert_array_equal(_bits(tx), _bits(jx))
    np.testing.assert_array_equal(_bits(ty), _bits(jy))


@pytest.mark.parametrize("rand_seed", [0, 12345, 2**32 - 1])
def test_pixel_seed_bit_exact(rand_seed):
    r = np.random.RandomState(rand_seed % 1000)
    px = r.randint(0, 8192, size=4096).astype(np.int32)
    py = r.randint(0, 8192, size=4096).astype(np.int32)
    t = trng.pixel_seed(torch.from_numpy(px), torch.from_numpy(py), rand_seed)
    j = jrng.pixel_seed(jnp.asarray(px), jnp.asarray(py), jnp.uint32(rand_seed))
    np.testing.assert_array_equal(_bits(t), _bits(j))
