"""Low-discrepancy sampling: hash-based Owen-scrambled Sobol (0,2) sequence.

The port of ``ray_tpu.ops.rng`` in its computed (Sobol) mode — bit-exact
with it.  PyTorch's ``uint32`` has no shifts or adds on the CPU, so every
32-bit word here is an ``int64`` tensor holding a value in [0, 2^32), kept
there with ``& 0xFFFFFFFF`` after each step; multiplications by 32-bit
constants are split into 16-bit halves so no product leaves int64.  The
same code runs on the CPU and on CUDA.

A sample is a pure function of (pixel, iteration, dimension, seed) —
``scrambled_2d_rand`` never draws from a generator.  ``table=True`` reads
the reference's own PMJ02 table instead of computing Sobol points, with
the reference's addressing (CoreRef.cpp:1418-1426: a shuffled dimension
row, an Owen-shuffled sample index) and the same value scramble; the table
(``ray_tpu_torch/data/pmj02_samples.npz``, a byte-for-byte copy of
``ray_tpu``'s) is cached on each device that asks for it.  ``ray_tpu``
falls back to the computed sampler when its file is missing; here a
missing file raises: the sampler never changes unasked.  The integrator
uses the computed mode.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from ray_tpu_torch.utils import trace

# Random-sequence dimension map (reference: internal/Constants.inl:31-43).
RAND_DIM_FILTER = 0
RAND_DIM_LENS = 1
RAND_DIM_BASE_COUNT = 2  # independent from bounce count

# Per-bounce dimensions, offset by RAND_DIM_BASE_COUNT + bounce * RAND_DIM_BOUNCE_COUNT.
RAND_DIM_BSDF_PICK = 0
RAND_DIM_BSDF = 1
RAND_DIM_LIGHT_PICK = 2
RAND_DIM_LIGHT = 3
RAND_DIM_TEX = 4
RAND_DIM_CACHE = 5
RAND_DIM_TEX_ANISO = 6
RAND_DIM_BOUNCE_COUNT = 8

RAND_SAMPLES_COUNT = 1 << 16  # index domain of the Owen shuffle

_M32 = 0xFFFFFFFF

# the reference's PMJ02 table (data, like the tonemap LUTs)
_PMJ_PATH = (pathlib.Path(__file__).resolve().parent.parent / "data"
             / "pmj02_samples.npz")


@functools.lru_cache(maxsize=1)
def _pmj_table():
    """(samples, count, dims): the table's (dims * 2 * count,) uint32 words
    as int64, its samples a dimension and its dimensions.  Raises
    ``FileNotFoundError`` when the data file is missing."""
    with np.load(_PMJ_PATH) as z:
        return (torch.from_numpy(z["samples"].astype(np.int64)),
                int(z["sample_count"]), int(z["dims_count"]))


@functools.lru_cache(maxsize=None)
def _pmj_words(device: torch.device) -> torch.Tensor:
    """The table's words on ``device``, copied there once."""
    return _pmj_table()[0].to(device)


def _u32(x):
    """A tensor (or int) as int64 words in [0, 2^32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mul32(x, c: int):
    """(x * c) mod 2^32 for a 32-bit constant c, without int64 overflow."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 0x10000) & _M32


def hash_u32(x):
    """MurmurHash3 finalizer (reference internal/CoreRef.h:133)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_combine(seed, v):
    """Boost-style seed combiner (reference internal/CoreRef.h:143)."""
    seed = _u32(seed)
    v = _u32(v)
    return (seed ^ ((v + ((seed << 6) & _M32) + (seed >> 2)) & _M32)) & _M32


def reverse_bits32(x):
    x = _u32(x)
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _M32


def laine_karras_permutation(x, seed):
    """Low-bit-mixing permutation (Laine & Karras 2011 / Burley 2020)."""
    x = (_u32(x) + _u32(seed)) & _M32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def nested_uniform_scramble(x, seed):
    """Owen scramble of a 32-bit value: reverse, permute low bits, reverse."""
    return reverse_bits32(laine_karras_permutation(reverse_bits32(x), seed))


def _sobol2_directions():
    dirs = []
    v = 1 << 31
    for _ in range(32):
        dirs.append(v)
        v ^= v >> 1
    return dirs


_SOBOL2_DIRS = tuple(_sobol2_directions())


def sobol02(index):
    """First two dimensions of the Sobol' sequence for ``index``: dim 0 is
    the van der Corput radical inverse, dim 1 the direction-number XOR
    chain over the 16 index bits the Owen shuffle can set."""
    index = _u32(index)
    x = reverse_bits32(index)
    y = torch.zeros_like(index)
    for bit in range(16):
        take = ((index >> bit) & 1).to(torch.bool)
        y = torch.where(take, y ^ _SOBOL2_DIRS[bit], y)
    return x, y


def _u32_to_unit_float(x):
    """Map uint32 → [0, 1) float32 keeping 24 bits of precision."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _pmj_indices(dim, seed, sample, count, dims):
    """Reference table addressing (CoreRef.cpp:1418-1426): shuffled
    dimension row + Owen-shuffled sample index -> flat index of the x
    word."""
    shuffled_dim = nested_uniform_scramble(dim, seed) & (dims - 1)
    shuffled_i = nested_uniform_scramble(sample, hash_combine(seed, dim)) & (
        count - 1
    )
    return shuffled_dim * (2 * count) + 2 * shuffled_i


def scrambled_2d_rand(dim, seed, sample, /, table=False):
    """2-D low-discrepancy sample for (dimension, per-pixel seed, sample
    index): computed Owen-Sobol with the reference's addressing, or with
    ``table=True`` the reference's PMJ02 table words (on the device of the
    tensor arguments).  Returns two float32 tensors in [0, 1);
    ``dim``/``seed``/``sample`` broadcast."""
    with trace.span("rt.rng"):
        return _scrambled_2d_rand(dim, seed, sample, table)


def _scrambled_2d_rand(dim, seed, sample, table):
    dim = _u32(dim)
    seed = _u32(seed)
    sample = _u32(sample)
    if table:
        _, count, dims = _pmj_table()
        idx = torch.as_tensor(_pmj_indices(dim, seed, sample, count, dims))
        words = _pmj_words(idx.device)
        sx, sy = words[idx], words[idx + 1]
    else:
        shuffled_i = nested_uniform_scramble(
            sample, hash_combine(seed, dim)) & (RAND_SAMPLES_COUNT - 1)
        sx, sy = sobol02(shuffled_i)
    rx = nested_uniform_scramble(sx, hash_combine(seed, (dim * 2) & _M32))
    ry = nested_uniform_scramble(sy, hash_combine(seed, (dim * 2 + 1) & _M32))
    return _u32_to_unit_float(rx), _u32_to_unit_float(ry)


def scrambled_2d_rand_many(dim_list, seed, sample, /, table=False):
    """:func:`scrambled_2d_rand` for each dimension of ``dim_list``: a list
    of (rx, ry) pairs (``ray_tpu``'s table mode fetches every dimension's
    words with one gather, a TPU economy; the words are the same)."""
    with trace.span("rt.rng"):
        return [_scrambled_2d_rand(d, seed, sample, table) for d in dim_list]


def pixel_seed(px, py, rand_seed):
    """Per-pixel RNG seed: hash of packed pixel coords combined with the
    frame seed (reference internal/CoreRef.cpp:1477-1478)."""
    with trace.span("rt.rng"):
        packed = ((_u32(px) << 16) & _M32) | _u32(py)
        return hash_combine(hash_u32(packed), _u32(rand_seed))
