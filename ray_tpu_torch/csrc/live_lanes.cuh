// Packing a block's active lanes onto its first threads: the lane
// compaction of trace_brute.cu and trace_bvh.cu.
//
// After the first bounce a trace's active lanes are scattered: a path
// that ended leaves its pixel's lane inactive, anywhere in the frame.  A
// warp holding one active lane runs every step that lane needs, so a
// launch whose lanes are half inactive costs nearly what a full one does.
// pack_live lists the block's active lanes, in lane order, in shared
// memory; thread i of the block then runs the i-th of them, and the
// block's other warps end at once.  Each ray's own computation does not
// change, only which thread runs it, so results do not either; rays keep
// their order, so the coherent primary rays stay together in a warp.

#pragma once

namespace live_lanes {

// ``live``: this thread's lane is active.  Writes the block offsets
// (threadIdx.x) of the active lanes, in order, to s_list[0 .. count) and
// returns count; ``s_count`` holds a count a warp.  Every thread of the
// block must call it (it holds two barriers).
template <int kThreads>
__device__ __forceinline__ int pack_live(bool live, int* s_list,
                                         int* s_count) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_count[warp] = __popc(mask);
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_count[w];
    before += w < warp ? c : 0;
    count += c;
  }
  if (live) s_list[before + __popc(mask & ((1u << lane) - 1u))] = threadIdx.x;
  __syncthreads();
  return count;
}

}  // namespace live_lanes
