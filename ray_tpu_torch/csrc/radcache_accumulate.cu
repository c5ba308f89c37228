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
// keyed n_rows, past every entry) and hands over torch.sort's int32 keys
// and int64 indices as they come.  Each segment of equal keys starts from
// the table's rad_curr[e] / cnt_curr[e], adds its lanes' radiance in the
// sorted (= lane) order, one __fadd_rn at a time, and writes the entry
// once.  No atomics: deterministic, and bit-equal to the sequential
// index_add_ of accumulate_plain on the same inputs (built -fmad=false).
//
// NaN.  The card's FADD returns the canonical NaN 0x7FFFFFFF; an x86 CPU,
// where the plain version runs, returns the first NaN operand, quieted,
// and 0xFFC00000 for inf + -inf.  index_add_ there adds (sum, lane), so a
// NaN sum holds the first NaN of its sequence (the table's value, then the
// lanes in order) or the default NaN.  The folds keep bare FADDs on their
// chains; a segment whose sum comes out NaN (never on a finite cache) is
// added again with add_as_cpu, which gives those bits.  (ray_tpu's XLA
// scatter-add adds (lane, sum), so where two NaNs meet it keeps the later
// lane's: the same sums and the same NaNs, other payloads.  The kernel
// keeps its plain version's; tests/test_torch_radcache.py holds each to
// its rule.)
//
// What bounds it on an H100 SXM: bytes, and the longest segment's chain of
// dependent adds.  Each valid lane reads its sorted key (4 B), its sort
// index (8 B), its radiance (12 B) and count (4 B); each touched entry
// reads and writes its radiance and count (2 x 16 B): ~2.4 us at an update
// pass's ~272,000 valid lanes.  An L-lane segment is 3 chains of L adds
// (~4 cycles each): ~0.4 us at 162 lanes, ~0.2 ms at 100,000.  Between
// the two stand the dependent round trips of a sort's output (a key, then
// its index, then the radiance the index points at) and the gathers
// themselves: a segment's lanes lie scattered over ``rad``, so each row
// and count costs a 32-byte sector or two of its own.
//
// The earlier design (one thread a sorted position; a segment's head
// thread walked it alone, a key, an index and a radiance load in turn
// before each add) paid the longest segment times three round trips, ~40
// us at 162 lanes, and launched a thread for every invalid position.  This
// one takes the round trips off the chains:
// * A block takes a tile of kTile sorted positions, kPer a thread.  A tile
//   in the sorted tail of invalid keys reads its first key and exits.
// * A tile's threads read their keys and indices (a warp's lanes on
//   consecutive positions: coalesced), then copy the radiance and count of
//   each valid one into shared memory, all at once and asynchronously
//   (cp.async: no registers held); the segment boundaries (keys[i] !=
//   keys[i-1]) are found with ballots and compacted in order, and each
//   one's table row is copied beside the radiance.  Two round trips a
//   tile; a tile owns the segments whose heads it holds and knows their
//   lengths.
// * A segment inside its tile is folded by one thread from shared memory:
//   kFold values read at once, then a chain of adds.
// * A segment that runs past its tile is folded by the tile's last warp,
//   every lane redundantly, in steps of kAhead positions past the tile:
//   the warp reads a step's keys and indices (coalesced) and copies the
//   radiance of those in the segment into one half of s_ahead, while it
//   folds the step before from the other half.  The first step is read
//   with the tile's own round trips, so an overhang of up to kAhead lanes
//   costs none.
// So a warp folds a segment iff it runs past its tile (512 positions); a
// thread folds any other.  On the update passes of five cached 1080p
// scenes (tools/accumulate_segments.py) the longest segment was 165 lanes
// and the longest overhang 133 positions: the first step, now and then a
// second, covers them; the steps keep any length right, as the
// 100,000-lane stress case checks.  kThreads x kPer = 512 positions a
// tile, at kMinBlocks blocks a SM, put an update pass's ~530 valid tiles
// in one wave of the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                  // sorted positions a thread
constexpr int kTile = kThreads * kPer;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the warp that folds a segment running past its tile, kAhead positions
// a step
constexpr int kFolder = kWarps - 1;
constexpr int kAhead = kPer * 32;
// a fold's reads in flight
constexpr int kFold = 16;
// blocks a SM: with no minimum ptxas builds the kernel in 64 registers and
// keeps fewer of a fold's reads in flight; 5 let it take 96, no spills,
// and 132 x 5 = 660 resident blocks hold an update pass's ~530 valid tiles
// in one wave
constexpr int kMinBlocks = 5;

// ``a + b`` with an x86 CPU's NaN: the first NaN operand quieted, else the
// default NaN 0xFFC00000 (inf + -inf).
__device__ __forceinline__ float add_as_cpu(float a, float b) {
  const float s = __fadd_rn(a, b);
  if (!isnan(s)) return s;
  const uint32_t bits = isnan(a)   ? __float_as_uint(a)
                        : isnan(b) ? __float_as_uint(b)
                                   : 0xFFC00000u;
  return __uint_as_float(bits | 0x00400000u);
}

// r += the radiance (x y z) and c += the count (w's bits) of v[0 .. n), in
// order: kFold values read at once, then added; the last block's
// positions past n add -0 and 0, which leave every sum as it is.
__device__ __forceinline__ void fold(const float4* v, int n, float r[3],
                                     int32_t& c) {
  float4 q[kFold];
  auto add = [&]() {
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      r[0] = __fadd_rn(r[0], q[u].x);
      r[1] = __fadd_rn(r[1], q[u].y);
      r[2] = __fadd_rn(r[2], q[u].z);
      c += __float_as_int(q[u].w);
    }
  };
  int j = 0;
  for (; j + kFold <= n; j += kFold) {
#pragma unroll
    for (int u = 0; u < kFold; ++u) q[u] = v[j + u];
    add();
  }
  if (j < n) {
    const float4 pad = make_float4(-0.0f, -0.0f, -0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < kFold; ++u) q[u] = j + u < n ? v[j + u] : pad;
    add();
  }
}

// A segment whose sum came out NaN: r (the table's row) += the radiance of
// its sorted lanes [start, end) again, one at a time, with the CPU's NaN.
__device__ void refold_as_cpu(const int64_t* __restrict__ order,
                              const float* __restrict__ rad, int64_t start,
                              int64_t end, float r[3]) {
  for (int64_t j = start; j < end; ++j) {
    const int64_t l = order[j];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) r[ch] = add_as_cpu(r[ch], rad[3 * l + ch]);
  }
}

__device__ __forceinline__ bool any_nan(const float r[3]) {
  return isnan(r[0]) || isnan(r[1]) || isnan(r[2]);
}

// An asynchronous 4-byte copy from global to shared memory (cp.async):
// nothing of it is held in registers; copies_done() waits for this
// thread's.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// *dst = row i of the (N, 3) floats ``f`` and, in w, element i of the
// ints ``k`` (a lane's radiance and count, or an entry's table row)
__device__ __forceinline__ void copy_row(float4* dst,
                                         const float* __restrict__ f,
                                         const int32_t* __restrict__ k,
                                         int64_t i) {
  copy4(&dst->x, f + 3 * i);
  copy4(&dst->y, f + 3 * i + 1);
  copy4(&dst->z, f + 3 * i + 2);
  copy4(&dst->w, k + i);
}

__device__ __forceinline__ void store_row(float* __restrict__ rad_curr,
                                          int32_t* __restrict__ cnt_curr,
                                          int32_t e, const float r[3],
                                          int32_t c) {
  const int64_t r3 = 3 * static_cast<int64_t>(e);
  rad_curr[r3] = r[0];
  rad_curr[r3 + 1] = r[1];
  rad_curr[r3 + 2] = r[2];
  cnt_curr[e] = c;
}

// The folder warp's keys and indices of the kAhead positions from p (a
// key -1 past n: in no segment).
__device__ __forceinline__ void load_step(const int32_t* __restrict__ keys,
                                          const int64_t* __restrict__ order,
                                          int64_t n, int64_t p, int lane,
                                          int32_t key[kPer],
                                          int64_t l[kPer]) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int64_t q = p + 32 * u + lane;
    key[u] = q < n ? keys[q] : -1;
    l[u] = q < n ? order[q] : 0;
  }
}

// The folder warp copies the radiance and count of the positions of a
// step that lie in segment e (a prefix: the keys are sorted) to ``buf``
// and returns how many.
__device__ __forceinline__ int copy_step(const float* __restrict__ rad,
                                         const int32_t* __restrict__ cnt,
                                         const int32_t key[kPer],
                                         const int64_t l[kPer], int32_t e,
                                         int lane, float4* buf) {
  int n = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const bool mine = key[u] == e;
    n += __popc(__ballot_sync(kFull, mine));
    if (mine) copy_row(buf + 32 * u + lane, rad, cnt, l[u]);
  }
  return n;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    radcache_accumulate_kernel(
    const int32_t* __restrict__ keys,    // (n_lanes,) sorted entries
    const int64_t* __restrict__ order,   // (n_lanes,) lane of each position
    int64_t n_lanes, int64_t n_rows,
    const float* __restrict__ rad,       // (lanes, 3)
    const int32_t* __restrict__ cnt,     // (lanes,)
    float* __restrict__ rad_curr,        // (n_rows, 3), updated in place
    int32_t* __restrict__ cnt_curr) {    // (n_rows,)
  __shared__ float4 s_val[kTile];   // each position's radiance and count
  __shared__ float4 s_row[kTile];   // the table row of each segment head
  __shared__ int32_t s_off[kTile + 1];   // each boundary's offset; the end
  __shared__ int32_t s_key[kTile];       // each boundary's key
  __shared__ float4 s_ahead[2 * kAhead];  // two steps past the tile
  __shared__ int32_t s_count[kPer][kWarps];
  __shared__ int32_t s_cross;            // does it run past the tile?

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool folder = warp == kFolder;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTile;
  if (keys[tile] >= n_rows) return;  // the sorted tail of invalid keys
  const int n_here =
      static_cast<int>(n_lanes - tile < kTile ? n_lanes - tile : kTile);
  const int64_t tile_end = tile + n_here;

  // round trip 1: the keys and indices of positions t + kThreads j
  // (coalesced; a warp's lanes on consecutive positions, so its gathers
  // meet the neighbouring rows of a segment's neighbouring lanes); the
  // folder warp's the keys just before, at the end of and past the tile,
  // and the indices past it
  int32_t key[kPer], before_j[kPer];
  int64_t l[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t p = tile + t + kThreads * j;
    key[j] = p < tile_end ? keys[p] : -1;
    l[j] = p < tile_end ? order[p] : 0;
    before_j[j] = lane == 0 && p > 0 && p < tile_end ? keys[p - 1] : -1;
  }
  int32_t ahead[kPer];
  int64_t l_ahead[kPer];
  load_step(keys, order, folder ? n_lanes : 0, tile_end, lane, ahead,
            l_ahead);
  const int32_t last = folder ? keys[tile_end - 1] : -1;
  const int32_t before = folder && tile > 0 ? keys[tile - 1] : -1;

  // round trip 2, asynchronous copies into shared memory: the radiance
  // and count of each valid position, the table row of each that starts
  // a segment, the folder warp's positions past the tile
  unsigned ballot[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int o = t + kThreads * j;
    const bool in = tile + o < tile_end;
    const bool live = in && key[j] < n_rows;
    const int32_t up = __shfl_up_sync(kFull, key[j], 1);
    const bool bnd = in && key[j] != (lane == 0 ? before_j[j] : up);
    ballot[j] = __ballot_sync(kFull, bnd);
    if (live) copy_row(s_val + o, rad, cnt, l[j]);
    if (bnd && live) copy_row(s_row + o, rad_curr, cnt_curr, key[j]);
  }
  // the folder warp: does the tile's last segment run past it (with its
  // head in the tile)?  Then the first step past the tile, and the keys
  // and indices of the second if the segment fills the first
  int n_ahead = 0;
  if (folder) {
    const bool cross = __shfl_sync(kFull, ahead[0], 0) == last &&
                       last < n_rows && before != last;
    if (cross) {
      n_ahead = copy_step(rad, cnt, ahead, l_ahead, last, lane, s_ahead);
      if (n_ahead == kAhead) {
        load_step(keys, order, n_lanes, tile_end + kAhead, lane, ahead,
                  l_ahead);
      }
    }
    if (lane == 0) s_cross = cross;
  }

  // the boundaries, compacted in position order (j, then warp, then
  // lane) from each warp's ballots
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) s_count[j][warp] = __popc(ballot[j]);
  }
  __syncthreads();
  int nb = 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int k = nb + __popc(ballot[j] & below);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      k += w < warp ? s_count[j][w] : 0;
      nb += s_count[j][w];
    }
    if (ballot[j] >> lane & 1u) {
      s_off[k] = t + kThreads * j;
      s_key[k] = key[j];
    }
  }
  if (t == 0) s_off[nb] = n_here;
  copies_done();
  __syncthreads();

  const bool crossing = s_cross != 0;
  // the segments inside the tile, one a thread
  for (int b = t; b < nb; b += kThreads) {
    if (s_key[b] >= n_rows || (crossing && b == nb - 1)) continue;
    const int a = s_off[b], z = s_off[b + 1];
    const float4 q = s_row[a];
    float r[3] = {q.x, q.y, q.z};
    int32_t c = __float_as_int(q.w);
    fold(s_val + a, z - a, r, c);
    if (any_nan(r)) {
      r[0] = q.x, r[1] = q.y, r[2] = q.z;
      refold_as_cpu(order, rad, tile + a, tile + z, r);
    }
    store_row(rad_curr, cnt_curr, s_key[b], r, c);
  }
  if (crossing && folder) {
    const int a = s_off[nb - 1];
    const int32_t e = s_key[nb - 1];
    const float4 q = s_row[a];
    float r[3] = {q.x, q.y, q.z};
    int32_t c = __float_as_int(q.w);
    fold(s_val + a, n_here - a, r, c);
    // the steps past the tile: step k is folded from half k % 2 of s_ahead
    // while step k + 1's rows are copied into the other half and step k +
    // 2's keys and indices are loaded
    int64_t p = tile_end;  // the first position of the step folded
    int n = n_ahead;       // its positions in the segment
    for (int h = 0;; h ^= 1) {
      int n_next = 0;
      if (n == kAhead) {  // warp-uniform
        n_next = copy_step(rad, cnt, ahead, l_ahead, e, lane,
                           s_ahead + (h ^ 1) * kAhead);
        if (n_next == kAhead) {
          load_step(keys, order, n_lanes, p + 2 * kAhead, lane, ahead,
                    l_ahead);
        }
      }
      fold(s_ahead + h * kAhead, n, r, c);
      if (n < kAhead) break;
      p += kAhead;
      n = n_next;
      copies_done();
      __syncwarp();  // the next half is in; every lane has read this one
    }
    if (any_nan(r)) {
      r[0] = q.x, r[1] = q.y, r[2] = q.z;
      if (lane == 0) refold_as_cpu(order, rad, tile + a, p + n, r);
    }
    if (lane == 0) store_row(rad_curr, cnt_curr, e, r, c);
  }
}

}  // namespace

// Plain C entry point for ctypes.  ``keys`` int32 and ``order`` int64 are
// torch.sort's outputs.  Launches one block a tile on ``stream`` and
// returns the launch's cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int radcache_accumulate_launch(const void* keys, const void* order,
                                          int64_t n_lanes, int64_t n_rows,
                                          const void* rad, const void* cnt,
                                          void* rad_curr, void* cnt_curr,
                                          void* stream) {
  if (n_lanes <= 0 || n_rows <= 0 || n_rows > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_lanes + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  radcache_accumulate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int64_t*>(order),
      n_lanes, n_rows, static_cast<const float*>(rad),
      static_cast<const int32_t*>(cnt), static_cast<float*>(rad_curr),
      static_cast<int32_t*>(cnt_curr));
  return static_cast<int>(cudaGetLastError());
}
