"""ray_tpu_torch.ops.rng against ray_tpu.ops.rng: bit-exact.

The port computes 32-bit words in int64 (PyTorch's CPU uint32 has no shifts
or adds); every output is compared as uint32 bits, floats included.  The
PMJ02 table mode (``table=True``) too, over a grid of dimensions (past the
table's 32 rows), seeds and sample indices (past its 4,096), with the
table a byte-for-byte copy of ``ray_tpu``'s; without the file it raises.
On CPU tensors the public functions are the plain version and never reach
the card's kernel (``csrc/rng_draw.cu``, held on the card by
``tests/test_torch_cuda.py``), whose wrappers refuse CPU tensors.
"""

import pathlib

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


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["scrambled_2d_rand", "scrambled_2d_rand_many"])
def test_table_mode_bit_exact(fn, seed):
    """Each (dim, sample) of a grid over 512 pixel seeds; ``_many`` takes
    the grid's dimensions as its list."""
    dims = np.array([0, 1, 2, 7, 31, 32, 33, 63, 1000], np.uint32)
    samples = np.array([0, 1, 5, 4095, 4096, 65535, 1 << 20], np.uint32)
    pix = _words(seed, 512)
    d, p, s = np.meshgrid(dims, pix, samples, indexing="ij")
    if fn == "scrambled_2d_rand":
        tx, ty = trng.scrambled_2d_rand(_t(d), _t(p), _t(s), table=True)
        jx, jy = jrng.scrambled_2d_rand(jnp.asarray(d), jnp.asarray(p),
                                        jnp.asarray(s), table=True)
        pairs = [((tx, ty), (jx, jy))]
    else:
        t = trng.scrambled_2d_rand_many([int(x) for x in dims], _t(pix),
                                        int(samples[seed]), table=True)
        j = jrng.scrambled_2d_rand_many(
            [jnp.uint32(x) for x in dims], jnp.asarray(pix),
            jnp.uint32(samples[seed]), table=True)
        pairs = list(zip(t, j))
    for (tx, ty), (jx, jy) in pairs:
        assert tx.dtype == torch.float32
        np.testing.assert_array_equal(_bits(tx), _bits(jx))
        np.testing.assert_array_equal(_bits(ty), _bits(jy))


def test_table_mode_differs_from_computed():
    seeds = _t(_words(9, 256))
    table = trng.scrambled_2d_rand(3, seeds, 7, table=True)
    computed = trng.scrambled_2d_rand(3, seeds, 7)
    assert not torch.equal(table[0], computed[0])


def test_pmj02_table_is_ray_tpus():
    ours = pathlib.Path(trng.__file__).parent.parent / "data" / "pmj02_samples.npz"
    ref = pathlib.Path(jrng.__file__).parent.parent / "data" / "pmj02_samples.npz"
    assert ours.read_bytes() == ref.read_bytes()


def test_missing_table_raises(monkeypatch, tmp_path):
    """``ray_tpu`` falls back to the computed sampler without its file; the
    port raises."""
    monkeypatch.setattr(trng, "_PMJ_PATH", tmp_path / "pmj02_samples.npz")
    trng._pmj_table.cache_clear()
    try:
        with pytest.raises(FileNotFoundError):
            trng.scrambled_2d_rand(3, 7, 1, table=True)
    finally:
        trng._pmj_table.cache_clear()


@pytest.mark.parametrize("table", [False, True])
def test_cpu_route_is_the_plain_version(monkeypatch, table):
    """Every draw form and ``pixel_seed`` on CPU tensors return the plain
    version's words, and nothing loads or launches a kernel."""
    from ray_tpu_torch.ops import cuda_build

    def no_kernel(name):
        raise AssertionError(f"a CPU draw loaded the {name} kernel")

    monkeypatch.setattr(cuda_build, "load", no_kernel)
    before = cuda_build.launch_counts.copy()
    seeds = _t(_words(21, 512))
    dims = _t(np.arange(512) % 48)
    samples = _t(_words(22, 512))
    for dim, sample in ((dims, 7), (5, samples), (dims, samples), (3, 0)):
        got = trng.scrambled_2d_rand(dim, seeds, sample, table=table)
        want = trng._scrambled_2d_rand_plain(dim, seeds, sample, table)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    many = trng.scrambled_2d_rand_many([0, 9], seeds, 4, table=table)
    for d, pair in zip([0, 9], many):
        for a, b in zip(pair, trng._scrambled_2d_rand_plain(d, seeds, 4,
                                                            table)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    px = torch.arange(-3, 509, dtype=torch.int32)
    py = torch.flip(px, (0,))
    np.testing.assert_array_equal(
        trng.pixel_seed(px, py, 2**32 - 1).numpy(),
        trng.pixel_seed_plain(px, py, 2**32 - 1).numpy())
    assert cuda_build.launch_counts == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel's wrappers never compute a CPU tensor's draw."""
    seeds = _t(_words(23, 64))
    px = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        trng.scrambled_2d_rand_cuda(3, seeds, 0)
    with pytest.raises(ValueError):
        trng.pixel_seed_cuda(px, px, 0)
