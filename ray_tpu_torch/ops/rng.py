"""Low-discrepancy sampling: hash-based Owen-scrambled Sobol (0,2) sequence.

The port of ``ray_tpu.ops.rng`` in its computed (Sobol) mode — bit-exact
with it.  Two routes, chosen by the device of the tensor arguments:

* CPU tensors take the plain version (``_scrambled_2d_rand_plain``,
  :func:`pixel_seed_plain` and the helpers they call).  PyTorch's
  ``uint32`` has no shifts or adds on the CPU, so every 32-bit word there
  is an ``int64`` tensor holding a value in [0, 2^32), kept there with
  ``& 0xFFFFFFFF`` after each step; multiplications by 32-bit constants
  are split into 16-bit halves so no product leaves int64.
* CUDA tensors launch ``csrc/rng_draw.cu``: one launch a draw, and one a
  pixel seed, computing in native ``uint32`` (bit-equal to the plain
  version).  The wrappers check device, dtype, shape and contiguity and
  raise on anything else; they never fall back to the plain version.

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

import ctypes
import functools
import numbers
import pathlib

import numpy as np
import torch

from ray_tpu_torch.ops import cuda_build
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
    tensor arguments).  Returns two float32 tensors in [0, 1).  On the CPU
    ``dim``/``seed``/``sample`` broadcast; on CUDA ``seed`` is an (R,)
    int64 tensor and ``dim`` and ``sample`` each an int or an (R,) int64
    tensor (:func:`scrambled_2d_rand_cuda`)."""
    with trace.span("rt.rng"):
        return _scrambled_2d_rand(dim, seed, sample, table)


def _on_cuda(*args) -> bool:
    """Whether any argument is a CUDA tensor: such a draw takes the
    kernel."""
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in args)


def _scrambled_2d_rand(dim, seed, sample, table):
    if _on_cuda(dim, seed, sample):
        return scrambled_2d_rand_cuda(dim, seed, sample, table)
    return _scrambled_2d_rand_plain(dim, seed, sample, table)


def _scrambled_2d_rand_plain(dim, seed, sample, table):
    """:func:`scrambled_2d_rand` in int64 words: the plain version."""
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
    frame seed (reference internal/CoreRef.cpp:1477-1478), as int64 words
    in [0, 2^32).  On CUDA ``px`` and ``py`` are (R,) int32 tensors and
    ``rand_seed`` an int (:func:`pixel_seed_cuda`)."""
    with trace.span("rt.rng"):
        if _on_cuda(px, py, rand_seed):
            return pixel_seed_cuda(px, py, rand_seed)
        return pixel_seed_plain(px, py, rand_seed)


def pixel_seed_plain(px, py, rand_seed):
    """:func:`pixel_seed` in int64 words: the plain version."""
    packed = ((_u32(px) << 16) & _M32) | _u32(py)
    return hash_combine(hash_u32(packed), _u32(rand_seed))


# ---- the CUDA route: csrc/rng_draw.cu ---------------------------------


def _lanes(name, x, device, dtype, n=None):
    """Check that ``x`` is a contiguous (n,) ``dtype`` tensor on
    ``device`` (any n when None); return its length."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != 1 or (n is not None and x.shape[0] != n):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"({'R' if n is None else n},)")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.shape[0]


def _word_or_lanes(name, x, device, n):
    """(pointer, value) of a per-lane int64 tensor or an int."""
    if isinstance(x, numbers.Integral):
        return None, int(x) & _M32
    _lanes(name, x, device, torch.int64, n)
    return x.data_ptr(), 0


def scrambled_2d_rand_cuda(dim, seed, sample, table=False):
    """:func:`scrambled_2d_rand` as one launch of ``csrc/rng_draw.cu``:
    ``seed`` a contiguous (R,) int64 CUDA tensor, ``dim`` and ``sample``
    each an int or a contiguous (R,) int64 tensor on the same device.
    Returns two (R,) float32 tensors, bit-equal to the plain version's."""
    if not (isinstance(seed, torch.Tensor) and seed.is_cuda):
        raise ValueError("seed must be a CUDA tensor")
    device = seed.device
    n = _lanes("seed", seed, device, torch.int64)
    dim_ptr, dim_value = _word_or_lanes("dim", dim, device, n)
    sample_ptr, sample_value = _word_or_lanes("sample", sample, device, n)
    table_ptr, count, dims = None, 0, 0
    if table:
        _, count, dims = _pmj_table()
        table_ptr = _pmj_words(device).data_ptr()
    out_x = torch.empty((n,), dtype=torch.float32, device=device)
    out_y = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return out_x, out_y
    with torch.cuda.device(device):
        err = _draw_fn()(seed.data_ptr(), dim_ptr, dim_value, sample_ptr,
                         sample_value, table_ptr, count, dims, n,
                         out_x.data_ptr(), out_y.data_ptr(),
                         torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rng_draw kernel launch failed: CUDA error {err}")
    cuda_build.launch_counts["rng_draw"] += 1
    return out_x, out_y


def pixel_seed_cuda(px, py, rand_seed):
    """:func:`pixel_seed` as one launch of ``csrc/rng_draw.cu``: ``px``
    and ``py`` contiguous (R,) int32 CUDA tensors on one device,
    ``rand_seed`` an int.  Returns the (R,) int64 seeds."""
    if not (isinstance(px, torch.Tensor) and px.is_cuda):
        raise ValueError("px must be a CUDA tensor")
    device = px.device
    n = _lanes("px", px, device, torch.int32)
    _lanes("py", py, device, torch.int32, n)
    if not isinstance(rand_seed, numbers.Integral):
        raise TypeError(f"rand_seed must be an int, not "
                        f"{type(rand_seed).__name__}")
    out = torch.empty((n,), dtype=torch.int64, device=device)
    if n == 0:
        return out
    with torch.cuda.device(device):
        err = _pixel_seed_fn()(px.data_ptr(), py.data_ptr(),
                               int(rand_seed) & _M32, n, out.data_ptr(),
                               torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rng_pixel_seed kernel launch failed: CUDA error "
                           f"{err}")
    cuda_build.launch_counts["rng_pixel_seed"] += 1
    return out


def _draw_fn():
    fn = cuda_build.load("rng_draw").rng_draw_launch
    if fn.argtypes is None:
        p, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
        fn.argtypes = [p, p, u32, p, u32, p, i64, i64, i64, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _pixel_seed_fn():
    fn = cuda_build.load("rng_draw").rng_pixel_seed_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_uint32, ctypes.c_int64, p, p]
        fn.restype = ctypes.c_int
    return fn
