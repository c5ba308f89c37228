// The spatial radiance cache's accumulate: for each valid lane i, in lane
// order, rad_curr[entry[i]] += rad[i] and cnt_curr[entry[i]] += cnt[i].
//
// Replaces no Pallas kernel: ray_tpu/render/radcache.py:232-241
// (``accumulate``) is an XLA scatter-add, which on the CPU adds the lanes in
// order.  On CUDA, PyTorch's index_add_ adds with atomics in any order, so
// two runs of one cache update differ in the last bits and the card's cache
// could be held against nothing exactly.  This kernel makes the order
// fixed: the wrapper (accumulate_segments in ray_tpu_torch/render/
// radcache.py) sorts the lanes by entry with a stable sort (invalid lanes
// keyed n_rows, past every entry), and here one thread takes one segment
// of equal entries: it starts from the table's rad_curr[e] / cnt_curr[e]
// and adds its lanes' values in the sorted (= lane) order, then writes the
// entry once.  No atomics: deterministic, and bit-equal to the sequential
// index_add_ of accumulate_plain on the same inputs (float adds, no
// contraction to be had; built -fmad=false all the same).
//
// Threads: one per sorted position; a thread whose position starts a
// segment walks it, the others return.  A long segment (a coarse voxel on
// a large wall can gather thousands of lanes) is walked by one thread
// alone: simple and right first; a segmented reduction in a fixed tree
// order would be the faster design, at the price of another summation
// order than the plain version's.
//
// Bound on an H100 SXM: bytes.  Each lane reads its sorted key (4 B), its
// lane index (4 B), its radiance (12 B) and count (4 B); each touched
// entry reads and writes its radiance and count (2 x 16 B).  Sorting is
// not counted: it is the wrapper's torch.sort.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) radcache_accumulate_kernel(
    const int32_t* __restrict__ keys,    // (n_lanes,) sorted entries
    const int32_t* __restrict__ order,   // (n_lanes,) lane of each position
    int64_t n_lanes, int64_t n_rows,
    const float* __restrict__ rad,       // (lanes, 3)
    const int32_t* __restrict__ cnt,     // (lanes,)
    float* __restrict__ rad_curr,        // (n_rows, 3), updated in place
    int32_t* __restrict__ cnt_curr) {    // (n_rows,)
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const int32_t e = keys[i];
  if (e < 0 || e >= n_rows) return;          // an invalid lane's key
  if (i > 0 && keys[i - 1] == e) return;     // not the segment's head
  float r0 = rad_curr[3 * static_cast<int64_t>(e) + 0];
  float r1 = rad_curr[3 * static_cast<int64_t>(e) + 1];
  float r2 = rad_curr[3 * static_cast<int64_t>(e) + 2];
  int32_t c = cnt_curr[e];
  for (int64_t j = i; j < n_lanes && keys[j] == e; ++j) {
    const int64_t lane = order[j];
    r0 = __fadd_rn(r0, rad[3 * lane + 0]);
    r1 = __fadd_rn(r1, rad[3 * lane + 1]);
    r2 = __fadd_rn(r2, rad[3 * lane + 2]);
    c += cnt[lane];
  }
  rad_curr[3 * static_cast<int64_t>(e) + 0] = r0;
  rad_curr[3 * static_cast<int64_t>(e) + 1] = r1;
  rad_curr[3 * static_cast<int64_t>(e) + 2] = r2;
  cnt_curr[e] = c;
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream`` and returns the
// launch's cudaGetLastError() (0 on success); never synchronises.
extern "C" int radcache_accumulate_launch(const void* keys, const void* order,
                                          int64_t n_lanes, int64_t n_rows,
                                          const void* rad, const void* cnt,
                                          void* rad_curr, void* cnt_curr,
                                          void* stream) {
  if (n_lanes <= 0 || n_rows <= 0 || n_rows > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  radcache_accumulate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(order),
      n_lanes, n_rows, static_cast<const float*>(rad),
      static_cast<const int32_t*>(cnt), static_cast<float*>(rad_curr),
      static_cast<int32_t*>(cnt_curr));
  return static_cast<int>(cudaGetLastError());
}
