// Per-lane table gather: out[i] = table[idx[i]], one thread per output.
//
// Replaces the TPU kernel scripts/test_pallas_gather.py:try_kernel (its
// pl.pallas_call and the three bodies k_take, k_index and k_take_along,
// which all compute out = table.reshape(-1)[idx] on a (1024,) or (1, 1024)
// float32 table and an (8, 128) int32 index).  On the TPU that script was a
// compiler probe: whether Mosaic lowers a per-lane gather from VMEM.  No
// path of the renderer runs it, in ray_tpu or in the port.
//
// Semantics (bit-equal to gather_table_plain in
// ray_tpu_torch/ops/gather_probe.py): the 32-bit word of table entry
// idx[i] is copied to out[i], so NaN payloads and -0 come through
// unchanged.  The kernel range-checks nothing: the wrapper gather_table
// raises on an index outside [0, table length) before it launches.
// General in the sizes: any number of outputs (64-bit count, grid-stride
// loop) and any table length below 2^31 (the index is int32).
//
// Bound on an H100 SXM: bytes.  The gather does no arithmetic; it reads
// each index (4 B) and writes each output (4 B), and reads the table once
// (4 B an entry): (4 x table + 8 x outputs) B over 3.35 TB/s.  At one
// 1080p frame of lanes (2,073,600) and the probe's 1,024-entry table that
// is 16.6 MB, ~5.0 us; at the probe's (8, 128) it is 12 KB, nanoseconds,
// where the launch latency sets the time.  The design reads the table
// through __ldg (the read-only path: a 4 KB table stays in L1/L2 and every
// warp's scattered reads hit there) and the index and output coalesced,
// neighbouring threads on neighbouring words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_table_kernel(
    const uint32_t* __restrict__ table,  // float32 words, copied as bits
    const int32_t* __restrict__ idx,
    int64_t n_out,
    uint32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    out[i] = __ldg(table + idx[i]);
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream`` and returns the
// launch's cudaGetLastError() (0 on success); never synchronises.
extern "C" int gather_table_launch(const void* table, int64_t n_table,
                                   const void* idx, int64_t n_out, void* out,
                                   void* stream) {
  if (n_table <= 0 || n_table > 0x7FFFFFFF || n_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // enough blocks to fill the card many times over; the loop covers the rest
  int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  gather_table_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(idx),
      n_out, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
