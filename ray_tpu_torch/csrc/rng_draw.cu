// The renderer's random numbers: one Owen-scrambled Sobol (0,2) draw, and
// the per-pixel seed, each one launch in native uint32.
//
// Replaces no TPU kernel: ray_tpu computes these in XLA
// (ray_tpu/ops/rng.py scrambled_2d_rand and pixel_seed), where each 32-bit
// step fuses.  The port's plain version (ray_tpu_torch/ops/rng.py
// _scrambled_2d_rand_plain and pixel_seed_plain) holds every word in an
// int64 tensor, masks it after each step and splits each multiply into
// 16-bit halves; one draw over a frame's lanes is ~360 PyTorch launches,
// each reading and writing 8 B a lane.  Here one thread computes a lane's
// whole draw in registers.
//
// Semantics (bit-equal to the plain version): scrambled_2d_rand_kernel is
// hash_combine(seed, dim), the Owen shuffle of the sample index
// (nested_uniform_scramble: __brev, the Laine-Karras permutation as plain
// uint32 multiplies, __brev), the first two Sobol dimensions of the
// shuffled index (or, in table mode, the reference's PMJ02 addressing and
// the two table words), the two value scrambles and the >> 8 conversion to
// [0, 1).  Every input word is read as int64 and taken mod 2^32, as the
// plain version's & 0xFFFFFFFF does.  pixel_seed_kernel is
// hash_combine(hash_u32((px << 16) | py), rand_seed), written as int64.
// The kernels check nothing: the wrappers in ops/rng.py check devices,
// dtypes, shapes and contiguity before they launch.
//
// Bound on an H100 SXM: bytes.  A draw does ~100 integer operations a
// lane; per lane it reads the seed (8 B) and, where they are tensors, the
// dimension and the sample index (8 B each), and writes two float32
// (8 B): 24 B a lane on the integrator's draws (a per-lane dimension,
// the sample index an argument), 49.8 MB over a 1080p frame's 2,073,600
// lanes, ~15 us at 3.35 TB/s.  pixel_seed reads 8 B and writes 8 B a lane.
// The design: one lane a thread, 256 threads a block, every read and
// write coalesced (neighbouring threads on neighbouring words); a
// per-lane or scalar dimension and sample index, and table mode, are
// uniform branches on arguments.  The PMJ02 table (a few hundred KB of
// int64 words) is read through __ldg and stays in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSamplesMask = (1u << 16) - 1;  // RAND_SAMPLES_COUNT - 1

__device__ __forceinline__ uint32_t hash_combine(uint32_t seed, uint32_t v) {
  return seed ^ (v + (seed << 6) + (seed >> 2));
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

__device__ __forceinline__ uint32_t nested_uniform_scramble(uint32_t x,
                                                            uint32_t seed) {
  return __brev(laine_karras(__brev(x), seed));
}

// dimension 1 of Sobol's sequence: the direction numbers v_0 = 2^31,
// v_{b+1} = v_b ^ (v_b >> 1), XORed for each set bit of the 16-bit index
__device__ __forceinline__ uint32_t sobol_dim1(uint32_t index) {
  uint32_t y = 0;
  uint32_t v = 1u << 31;
#pragma unroll
  for (int bit = 0; bit < 16; ++bit) {
    if ((index >> bit) & 1u) y ^= v;
    v ^= v >> 1;
  }
  return y;
}

__device__ __forceinline__ float unit_float(uint32_t x) {
  return __uint2float_rn(x >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads) scrambled_2d_rand_kernel(
    const int64_t* __restrict__ seed,
    const int64_t* __restrict__ dim,     // null: every lane dim_value
    uint32_t dim_value,
    const int64_t* __restrict__ sample,  // null: every lane sample_value
    uint32_t sample_value,
    const int64_t* __restrict__ table,   // null: computed (Sobol) mode
    int64_t count, int64_t dims, int64_t n,
    float* __restrict__ out_x, float* __restrict__ out_y) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t s = static_cast<uint32_t>(seed[i]);
  const uint32_t d = dim ? static_cast<uint32_t>(dim[i]) : dim_value;
  const uint32_t k = sample ? static_cast<uint32_t>(sample[i]) : sample_value;
  uint32_t sx, sy;
  if (table) {
    // the reference's addressing (CoreRef.cpp:1418-1426): a shuffled
    // dimension row and an Owen-shuffled sample index
    const int64_t row =
        nested_uniform_scramble(d, s) & static_cast<uint32_t>(dims - 1);
    const int64_t col = nested_uniform_scramble(k, hash_combine(s, d)) &
                        static_cast<uint32_t>(count - 1);
    const int64_t at = row * (2 * count) + 2 * col;
    sx = static_cast<uint32_t>(__ldg(table + at));
    sy = static_cast<uint32_t>(__ldg(table + at + 1));
  } else {
    const uint32_t idx =
        nested_uniform_scramble(k, hash_combine(s, d)) & kSamplesMask;
    sx = __brev(idx);
    sy = sobol_dim1(idx);
  }
  out_x[i] = unit_float(nested_uniform_scramble(sx, hash_combine(s, d * 2u)));
  out_y[i] =
      unit_float(nested_uniform_scramble(sy, hash_combine(s, d * 2u + 1u)));
}

__global__ void __launch_bounds__(kThreads) pixel_seed_kernel(
    const int32_t* __restrict__ px, const int32_t* __restrict__ py,
    uint32_t rand_seed, int64_t n, int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t packed = (static_cast<uint32_t>(px[i]) << 16) |
                          static_cast<uint32_t>(py[i]);
  out[i] = static_cast<int64_t>(hash_combine(hash_u32(packed), rand_seed));
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on ``stream`` and
// returns the launch's cudaGetLastError() (0 on success); never
// synchronises.  n lanes, 1 <= n < 2^31 * 256 (the grid's x limit).
extern "C" int rng_draw_launch(const void* seed, const void* dim,
                               uint32_t dim_value, const void* sample,
                               uint32_t sample_value, const void* table,
                               int64_t count, int64_t dims, int64_t n,
                               void* out_x, void* out_y, void* stream) {
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7FFFFFFF ||
      (table && (count <= 0 || dims <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scrambled_2d_rand_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seed), static_cast<const int64_t*>(dim),
      dim_value, static_cast<const int64_t*>(sample), sample_value,
      static_cast<const int64_t*>(table), count, dims, n,
      static_cast<float*>(out_x), static_cast<float*>(out_y));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rng_pixel_seed_launch(const void* px, const void* py,
                                     uint32_t rand_seed, int64_t n, void* out,
                                     void* stream) {
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pixel_seed_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(px), static_cast<const int32_t*>(py),
      rand_seed, n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
