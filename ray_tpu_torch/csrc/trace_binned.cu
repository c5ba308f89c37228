// Binned ray trace of big flatten scenes: the BVH2 is cut into S <= 512
// subtree slabs of at most 512 node and 512 triangle rows
// (ray_tpu_torch/scene/binned.py pack_binned_scene), and each ray visits
// the subtrees its ray enters, near to far, walking each one's slab with
// its own stack (two child boxes per node, up to max_leaf triangles per
// leaf, Möller–Trumbore).  A second, small kernel computes the key the
// wrapper sorts rays by before the trace.
//
// Replaces the TPU kernel ray_tpu/ops/traverse_pallas.py:_binned_kernel
// (pl.pallas_call in _trace_binned_call, entry trace_flat_binned), which
// ray_tpu's _pallas_mode routes every flatten scene finalized with
// pallas_binned=True to on a TPU.
//
// Semantics (those of _binned_kernel for each lane, and bit-equal to the
// plain PyTorch version trace_binned_plain in ray_tpu_torch/ops/traverse.py):
//   * a ray keeps a frontier (f_t, f_sid) = (-3.4e38f, -1) and a hit record,
//     and runs rounds until no subtree is left (any hit: or it has a hit);
//   * a round scans the S subtree boxes in sid order with the slab test
//     (safe_inv directions, min/max that propagate NaN, _aabb_c's operand
//     order, the exit capped by t_best before the 1.00000024f slack) and
//     takes box s when it is hit, lies after the frontier (tn > f_t, or
//     tn == f_t and s > f_sid) and is better than the best so far (tn < bt,
//     or tn == bt and s < bs; the best starts at 3.4e38f, INT32_MAX);
//   * the chosen slab is walked from its root as trace_bvh.cu walks a BVH2
//     (near child by t0 <= t1, the far child pushed only when both are hit,
//     a leaf tests min(count, max_leaf) slots, any hit tests against t_max
//     and ends after the leaf that hit), with a fresh stack each round, on
//     local codes; prim is the slab's local -> global triangle map;
//   * the frontier moves to (bt, bs).
// _binned_kernel serialises a block's lanes over rounds (a lane whose next
// subtree is not the block's smallest pending sid sits the round out,
// keeping its frontier and best hit), so every lane visits the same
// subtrees in the same order as here.  A push at sp >= stack_size is
// dropped but counted, its pop yields EMPTY, and the ray pops on until its
// stack is empty (ray_tpu's walk stops once every lane of the block is
// done: ROADMAP Queue 3).  A miss or an inactive lane returns t = t_max,
// prim = -1, u = v = 0, backface = false.  Bit-equality needs IEEE float32
// with no contraction: build with -fmad=false -prec-div=true, never
// --use_fast_math.
//
// Slab layout: entry idx of column c of subtree s is
// slab_f[(s * 88 + c * 4) * 128 + idx] (columns 0-11 the child boxes lo0
// hi0 lo1 hi1, 12-20 the vertices p0 p1 p2) and slab_i[(s * 16 + c * 4) *
// 128 + idx] (columns 0-1 the child codes, 2 the triangle map).
//
// Sort key (trace_flat_binned's pre-pass, binned_sort_key_plain): each
// ray's first subtree in trace_flat_binned's own arithmetic (the entry is
// the max over the axes of the slab minima, the exit the max of the maxima
// times the slack, then capped by t_max; the first box with the smallest
// entry below 3.4e38f wins), S when none is hit or the lane is inactive.
// It decides only the order of the rays, never a result.
//
// Bound (chip_smoke.py kernel_timings).  Operations: 13 float ops per
// subtree box scanned (S for every round of every lane, and one more scan
// that finds nothing), 26 per node step, 46 per triangle test, counted from
// the plain version's walk at each launch's own inputs.  Bytes: every lane
// reads t_max and active (5 B) and writes t, u, v, prim, backface (17 B);
// an active lane also reads ro, rd, t_min (28 B); the slabs are read once.
//
// Design: one thread runs one ray from start to finish.  The S subtree
// boxes (6 x 512 floats, 12 KB) are staged in shared memory once per block
// and read by every thread of a warp at the same address (a broadcast).
// Slab entries are read from global memory through the read-only path
// (__ldg); all slabs of a scene of S = 469 take 25 MB, which the 50 MB L2
// holds.  The stack is a per-thread int[64] indexed below stack_size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSub = 512;     // ray_tpu's binned limit
constexpr int kMaxStack = 64;    // MAX_STACK_SIZE
constexpr int kMaxLeaf = 15;     // LEAF_COUNT_MASK
constexpr int kRows = 512;       // entries of a slab column (SUB_ROWS)
constexpr int kCF = 88;          // f32 slab rows of a subtree
constexpr int kCI = 16;          // i32 slab rows of a subtree
constexpr int32_t kEmpty = INT32_MIN;

// jnp.float32(3.4e38): "no subtree yet" in the scan and the sort key
__device__ __forceinline__ float big() { return __int_as_float(0x7f7fc99e); }

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v >= 0.0f ? 1e-7f : -1e-7f;
  return 1.0f / (fabsf(v) > 1e-7f ? v : tiny);
}

// _aabb_c / aabb_t: returns hit, writes the entry distance tn
__device__ __forceinline__ bool slab_test(
    float lox, float loy, float loz, float hix, float hiy, float hiz,
    float ox, float oy, float oz, float ix, float iy, float iz, float t_min,
    float t_cap, float* tn_out) {
  const float tx0 = (lox - ox) * ix;
  const float tx1 = (hix - ox) * ix;
  const float ty0 = (loy - oy) * iy;
  const float ty1 = (hiy - oy) * iy;
  const float tz0 = (loz - oz) * iz;
  const float tz1 = (hiz - oz) * iz;
  const float tn = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                           max_nan(min_nan(tz0, tz1), t_min));
  const float tf = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                           min_nan(max_nan(tz0, tz1), t_cap));
  *tn_out = tn;
  return tn <= tf * 1.00000024f;
}

// the S subtree boxes as six SoA rows of n_sub floats
__device__ __forceinline__ void stage_boxes(const float* __restrict__ sub_lo,
                                            const float* __restrict__ sub_hi,
                                            int n_sub, float* s_box) {
  for (int i = threadIdx.x; i < 3 * n_sub; i += blockDim.x) {
    const int s = i / 3, a = i % 3;
    s_box[a * n_sub + s] = sub_lo[i];
    s_box[(3 + a) * n_sub + s] = sub_hi[i];
  }
  __syncthreads();
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) trace_binned_kernel(
    const float* __restrict__ slab_f,   // (S * 88, 128)
    const int32_t* __restrict__ slab_i, // (S * 16, 128)
    const float* __restrict__ sub_lo,   // (S, 3)
    const float* __restrict__ sub_hi,   // (S, 3)
    int n_sub,
    const float* __restrict__ ro,       // (R, 3)
    const float* __restrict__ rd,       // (R, 3)
    const float* __restrict__ t_min,
    const float* __restrict__ t_max,
    const bool* __restrict__ active,
    int64_t n_rays,
    float* __restrict__ out_t,
    int32_t* __restrict__ out_prim,
    float* __restrict__ out_u,
    float* __restrict__ out_v,
    bool* __restrict__ out_bf,
    int max_leaf,
    int stack_size) {
  __shared__ float s_box[6 * kMaxSub];
  stage_boxes(sub_lo, sub_hi, n_sub, s_box);

  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  const float tmx = t_max[r];
  float t_best = tmx;
  int32_t prim = -1;
  float u_b = 0.0f, v_b = 0.0f;
  bool bf = false;

  if (active[r]) {
    const float ox = ro[3 * r], oy = ro[3 * r + 1], oz = ro[3 * r + 2];
    const float dx = rd[3 * r], dy = rd[3 * r + 1], dz = rd[3 * r + 2];
    const float tmn = t_min[r];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    float f_t = -big();
    int f_sid = -1;
    int32_t stack[kMaxStack];
    while (!(kAnyHit && prim >= 0)) {
      // ---- the next subtree: lexicographic-min (t_enter, sid) ----
      float bt = big();
      int bs = INT32_MAX;
      for (int s = 0; s < n_sub; ++s) {
        float tn;
        const bool hit = slab_test(
            s_box[s], s_box[n_sub + s], s_box[2 * n_sub + s],
            s_box[3 * n_sub + s], s_box[4 * n_sub + s], s_box[5 * n_sub + s],
            ox, oy, oz, ix, iy, iz, tmn, t_best, &tn);
        const bool after = tn > f_t || (tn == f_t && s > f_sid);
        const bool better = tn < bt || (tn == bt && s < bs);
        if (hit && after && better) {
          bt = tn;
          bs = s;
        }
      }
      if (bs == INT32_MAX) break;

      // ---- walk its slab from the root ----
      const float* F = slab_f + static_cast<int64_t>(bs) * kCF * 128;
      const int32_t* I = slab_i + static_cast<int64_t>(bs) * kCI * 128;
      int sp = 0;
      int32_t cur = 0;
      while (cur != kEmpty) {
        int32_t next = kEmpty;
        if (cur >= 0) {
          float t0, t1;
          const bool h0 = slab_test(
              __ldg(F + 0 * kRows + cur), __ldg(F + 1 * kRows + cur),
              __ldg(F + 2 * kRows + cur), __ldg(F + 3 * kRows + cur),
              __ldg(F + 4 * kRows + cur), __ldg(F + 5 * kRows + cur),
              ox, oy, oz, ix, iy, iz, tmn, t_best, &t0);
          const bool h1 = slab_test(
              __ldg(F + 6 * kRows + cur), __ldg(F + 7 * kRows + cur),
              __ldg(F + 8 * kRows + cur), __ldg(F + 9 * kRows + cur),
              __ldg(F + 10 * kRows + cur), __ldg(F + 11 * kRows + cur),
              ox, oy, oz, ix, iy, iz, tmn, t_best, &t1);
          const int32_t c0 = __ldg(I + cur);
          const int32_t c1 = __ldg(I + kRows + cur);
          const bool near_is_0 = t0 <= t1;
          const int32_t near_code = near_is_0 ? c0 : c1;
          const int32_t far_code = near_is_0 ? c1 : c0;
          const bool near_hit = near_is_0 ? h0 : h1;
          const bool far_hit = near_is_0 ? h1 : h0;
          if (near_hit && far_hit) {
            if (sp < stack_size) stack[sp] = far_code;
            ++sp;
          }
          next = near_hit ? near_code : (far_hit ? far_code : kEmpty);
        } else {
          const int32_t leaf = -cur - 1;
          const int first = leaf >> 4;
          const int count = leaf & 15;
          for (int k = 0; k < max_leaf && k < count; ++k) {
            const int tri = first + k;
            const float p0x = __ldg(F + 12 * kRows + tri);
            const float p0y = __ldg(F + 13 * kRows + tri);
            const float p0z = __ldg(F + 14 * kRows + tri);
            const float e1x = __ldg(F + 15 * kRows + tri) - p0x;
            const float e1y = __ldg(F + 16 * kRows + tri) - p0y;
            const float e1z = __ldg(F + 17 * kRows + tri) - p0z;
            const float e2x = __ldg(F + 18 * kRows + tri) - p0x;
            const float e2y = __ldg(F + 19 * kRows + tri) - p0y;
            const float e2z = __ldg(F + 20 * kRows + tri) - p0z;
            const float pvx = dy * e2z - dz * e2y;
            const float pvy = dz * e2x - dx * e2z;
            const float pvz = dx * e2y - dy * e2x;
            const float det = e1x * pvx + e1y * pvy + e1z * pvz;
            const bool valid_det = det != 0.0f;
            const float inv_det = 1.0f / (valid_det ? det : 1.0f);
            const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
            const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
            const float qvx = tvy * e1z - tvz * e1y;
            const float qvy = tvz * e1x - tvx * e1z;
            const float qvz = tvx * e1y - tvy * e1x;
            const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
            const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
            const float upper = kAnyHit ? tmx : t_best;
            if (valid_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                t > tmn && t < upper) {
              t_best = t;
              prim = __ldg(I + 2 * kRows + tri);
              u_b = u;
              v_b = v;
              bf = det < 0.0f;
            }
          }
        }
        if (kAnyHit && prim >= 0) {
          sp = 0;
          next = kEmpty;
        }
        while (next == kEmpty && sp > 0) {
          const int top = sp - 1;
          next = top < stack_size ? stack[top] : kEmpty;
          sp = top;
        }
        cur = next;
      }
      f_t = bt;
      f_sid = bs;
    }
  }
  out_t[r] = t_best;
  out_prim[r] = prim;
  out_u[r] = u_b;
  out_v[r] = v_b;
  out_bf[r] = bf;
}

__global__ void __launch_bounds__(kThreads) binned_sort_key_kernel(
    const float* __restrict__ sub_lo, const float* __restrict__ sub_hi,
    int n_sub, const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const bool* __restrict__ active, int64_t n_rays,
    int32_t* __restrict__ key) {
  __shared__ float s_box[6 * kMaxSub];
  stage_boxes(sub_lo, sub_hi, n_sub, s_box);

  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  int best_s = n_sub;
  if (active[r]) {
    const float o[3] = {ro[3 * r], ro[3 * r + 1], ro[3 * r + 2]};
    const float inv[3] = {safe_inv(rd[3 * r]), safe_inv(rd[3 * r + 1]),
                          safe_inv(rd[3 * r + 2])};
    const float tmn = t_min[r], tmx = t_max[r];
    float best_t = big();
    for (int s = 0; s < n_sub; ++s) {
      float lo_max = 0.0f, hi_max = 0.0f;
      for (int a = 0; a < 3; ++a) {
        const float t0 = (s_box[a * n_sub + s] - o[a]) * inv[a];
        const float t1 = (s_box[(3 + a) * n_sub + s] - o[a]) * inv[a];
        const float lo = min_nan(t0, t1), hi = max_nan(t0, t1);
        lo_max = a == 0 ? lo : max_nan(lo_max, lo);
        hi_max = a == 0 ? hi : max_nan(hi_max, hi);
      }
      const float tn = max_nan(lo_max, tmn);
      const float tf = min_nan(hi_max * 1.00000024f, tmx);
      if (tn <= tf && tn < best_t) {
        best_t = tn;
        best_s = s;
      }
    }
  }
  key[r] = best_s;
}

bool bad_launch(int n_sub, int64_t n_rays) {
  return n_sub < 2 || n_sub > kMaxSub || n_rays <= 0 ||
         (n_rays + kThreads - 1) / kThreads > 0x7FFFFFFF;
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on ``stream`` and returns
// the launch's cudaGetLastError() (0 on success); never synchronises.
extern "C" int trace_binned_launch(
    const void* slab_f, const void* slab_i, const void* sub_lo,
    const void* sub_hi, int n_sub, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* active, int64_t n_rays,
    void* out_t, void* out_prim, void* out_u, void* out_v, void* out_bf,
    int max_leaf, int stack_size, int any_hit, void* stream) {
  if (bad_launch(n_sub, n_rays) || max_leaf < 1 || max_leaf > kMaxLeaf ||
      stack_size < 1 || stack_size > kMaxStack) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n_rays + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(slab_f);
  const int32_t* si = static_cast<const int32_t*>(slab_i);
  const float* lo = static_cast<const float*>(sub_lo);
  const float* hi = static_cast<const float*>(sub_hi);
  const float* o = static_cast<const float*>(ro);
  const float* d = static_cast<const float*>(rd);
  const float* tn = static_cast<const float*>(t_min);
  const float* tx = static_cast<const float*>(t_max);
  const bool* a = static_cast<const bool*>(active);
  float* ot = static_cast<float*>(out_t);
  int32_t* op = static_cast<int32_t*>(out_prim);
  float* ou = static_cast<float*>(out_u);
  float* ov = static_cast<float*>(out_v);
  bool* ob = static_cast<bool*>(out_bf);
  if (any_hit) {
    trace_binned_kernel<true><<<blocks, kThreads, 0, s>>>(
        sf, si, lo, hi, n_sub, o, d, tn, tx, a, n_rays, ot, op, ou, ov, ob,
        max_leaf, stack_size);
  } else {
    trace_binned_kernel<false><<<blocks, kThreads, 0, s>>>(
        sf, si, lo, hi, n_sub, o, d, tn, tx, a, n_rays, ot, op, ou, ov, ob,
        max_leaf, stack_size);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int binned_sort_key_launch(
    const void* sub_lo, const void* sub_hi, int n_sub, const void* ro,
    const void* rd, const void* t_min, const void* t_max, const void* active,
    int64_t n_rays, void* key, void* stream) {
  if (bad_launch(n_sub, n_rays)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n_rays + kThreads - 1) / kThreads);
  binned_sort_key_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sub_lo), static_cast<const float*>(sub_hi),
      n_sub, static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(t_min), static_cast<const float*>(t_max),
      static_cast<const bool*>(active), n_rays, static_cast<int32_t*>(key));
  return static_cast<int>(cudaGetLastError());
}
