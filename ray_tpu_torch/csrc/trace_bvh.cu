// BVH2 ray trace: each ray walks the tree with its own stack, testing two
// child boxes per node and up to max_leaf triangles per leaf
// (Möller–Trumbore), optionally only the triangles whose per-ray-type
// visibility mask meets the ray's.
//
// Replaces the TPU kernel ray_tpu/ops/traverse_pallas.py:_bvh_kernel
// (pl.pallas_call in _trace_bvh_call, entry trace_bvh_pallas), which
// ray_tpu's _pallas_mode routes every scene of 41 to 512 rows to, and
// ray_tpu's XLA walk _traverse, which takes the larger scenes without an
// 8-wide table and every masked trace without one (ray_tpu/ops/
// traverse.py:118, the tri_vis test at :195-198).  The 512-row cap was the
// TPU's VMEM: this kernel reads its rows from global memory and takes any
// table below 2^27 rows.
//
// Semantics (identical to _bvh_kernel and to ray_tpu's XLA walk _traverse,
// and bit-equal to the plain PyTorch version trace_bvh_plain in
// ray_tpu_torch/ops/traverse.py):
//   * one step retires one node or one leaf, and the following pop is
//     folded into the same step;
//   * a node tests both child boxes against [t_min, t_best] with the slab
//     test: safe_inv directions, min/max that propagate NaN, in _aabb_c's
//     operand order, hit when tn <= tf * 1.00000024f (1 + 2 ulp);
//   * the near child is the one with t0 <= t1 on the entry distances, hit
//     or not; the walk descends into the near child if it is hit, else
//     into the far child if that is hit, and pushes the far child only
//     when both are hit;
//   * a push at sp >= stack_size is dropped but sp still counts it, the
//     pop of such a slot yields EMPTY, and the ray pops on until it finds
//     an entry or its stack is empty (what _traverse does while any other
//     lane of its batch still walks);
//   * a leaf code c < 0 holds first = (-c-1) >> 4 and count = (-c-1) & 15,
//     and tests triangles k < max_leaf && k < count; the masked
//     instantiation (kVis) skips a triangle whose mask (word 9 of its row)
//     shares no bit with the ray's ray_mask;
//   * a triangle counts when det != 0, u >= 0, v >= 0, u + v <= 1,
//     t > t_min and t < t_best (closest hit) or t < t_max (any hit);
//   * any hit: a later passing triangle of the same leaf overwrites an
//     earlier one, and the walk ends after the leaf that hit.
// A miss or an inactive lane returns t = t_max, prim = -1, u = v = 0,
// backface = false.  Child codes ride in the node row as int bits.
// Bit-equality needs IEEE float32 with no contraction: build with
// -fmad=false -prec-div=true, never --use_fast_math.
//
// Bound (chip_smoke.py launch_bound).  Bytes: every lane reads t_max and
// active (5 B) and writes t, u, v, prim, backface (17 B); an active lane
// also reads ro, rd, t_min (28 B).  Operations: 13 float ops per box (6
// subtract, 6 multiply, 1 slack multiply), two boxes per node step, and 46
// per triangle test, counted from the plain version's walk at each
// launch's own inputs.  Either way a few tens of microseconds at the
// cornell_sphere frame's 2,073,600 lanes: the walk itself is bound by its
// chain of dependent row reads and its divergence, not by either.
//
// Design.  One thread runs one ray from start to finish.
//   * Inactive lanes write the miss record and load no ray, and a block of
//     256 packs its active lanes onto its first threads (live_lanes.cuh),
//     so a warp walks 32 active rays, not the few active ones among 32
//     lanes of a late bounce.
//   * The tables are the wrapper's cached, 16-byte-aligned rows
//     (ops/traverse.py node_rows and tri_rows, built once a scene): node
//     rows of 16 floats (lo0 hi0 lo1 hi1, the child codes, two zero words)
//     read as four float4, and triangle rows of 12 (p0 e1 e2, tri_test.cuh)
//     read as three.
//   * They are read from global memory through the read-only path
//     (__ldg), not staged: 21.8 KB for cornell_sphere's 59 + 376 rows,
//     which stay in each SM's L1 after the first touches (a larger table
//     lives in the 50 MB L2).  Staging them in shared memory once a block made each
//     block copy the whole table before its first step (8,100 blocks x 21.8
//     KB a full-width launch through L2), and a grid of a few blocks an SM
//     that stages once and walks its rays grid-stride lost the hardware's
//     balancing of blocks of uneven work; both measured slower
//     (tools/kernel_variants.py).
//   * The walk is a while-while loop (Aila & Laine, HPG 2009): node steps
//     run until the ray holds a leaf, then the leaf step runs, so a warp's
//     lanes at inner nodes go on descending together while others test
//     leaves.  Each ray's own sequence of steps, pushes, pops and overflow
//     is the one above.
//   * Box tests take min and max from the hardware's NaN-propagating
//     max.NaN / min.NaN: they agree with jnp.maximum / jnp.minimum except
//     for the sign of a zero, which only ever meets comparisons.
//   * A triangle test is tri_test.cuh's: a divide-free pre-test, and the
//     full test only for the pairs it cannot reject.
//   * The stack is a per-thread int[64] (local memory, cached in L1)
//     indexed below stack_size.
//   * Visibility masks are a compile-time flag: the mask rides in the
//     triangle row's spare word 9 (the wrapper's second cached copy of the
//     rows, ops/traverse.py tri_rows(tris, tri_vis)), so the masked walk
//     issues no extra load, and the unmasked instantiation is the kernel
//     it was.

#include <cuda_runtime.h>
#include <stdint.h>

#include "live_lanes.cuh"
#include "tri_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 1 << 27;  // a leaf code's first << 4 | count
constexpr int kMaxStack = 64;   // MAX_STACK_SIZE
constexpr int kMaxLeaf = 15;    // LEAF_COUNT_MASK
constexpr int kNode4 = 4;       // float4 a node row
constexpr int kTri4 = 3;        // float4 a triangle row
constexpr int32_t kEmpty = INT32_MIN;

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v >= 0.0f ? 1e-7f : -1e-7f;
  return 1.0f / (fabsf(v) > 1e-7f ? v : tiny);
}

// Node row i: lo0 hi0 lo1 hi1 (q0.x .. q2.w), the child codes (q3.x, q3.y).
__device__ __forceinline__ void node_row(const float4* __restrict__ nodes,
                                         int i, float4& q0, float4& q1,
                                         float4& q2, float4& q3) {
  const float4* n = nodes + kNode4 * i;
  q0 = __ldg(&n[0]);
  q1 = __ldg(&n[1]);
  q2 = __ldg(&n[2]);
  q3 = __ldg(&n[3]);
}

// Triangle row k (tri_test.cuh's layout).
__device__ __forceinline__ void tri_row(const float4* __restrict__ tris, int k,
                                        float4& r0, float4& r1, float4& r2) {
  const float4* p = tris + kTri4 * k;
  r0 = __ldg(&p[0]);
  r1 = __ldg(&p[1]);
  r2 = __ldg(&p[2]);
}

// _aabb_c: returns hit, writes the entry distance tn
__device__ __forceinline__ bool slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     float ox, float oy, float oz, float ix,
                                     float iy, float iz, float t_min,
                                     float t_max, float* tn_out) {
  const float tx0 = (lox - ox) * ix;
  const float tx1 = (hix - ox) * ix;
  const float ty0 = (loy - oy) * iy;
  const float ty1 = (hiy - oy) * iy;
  const float tz0 = (loz - oz) * iz;
  const float tz1 = (hiz - oz) * iz;
  const float tn = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                           max_nan(min_nan(tz0, tz1), t_min));
  const float tf = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                           min_nan(max_nan(tz0, tz1), t_max));
  *tn_out = tn;
  return tn <= tf * 1.00000024f;
}

// The walk of the active ray r; writes its hit record.
template <bool kAnyHit, bool kVis>
__device__ __forceinline__ void trace_ray(
    int64_t r, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ t_min,
    const float* __restrict__ t_max, const int32_t* __restrict__ ray_mask,
    float* __restrict__ out_t, int32_t* __restrict__ out_prim,
    float* __restrict__ out_u, float* __restrict__ out_v,
    bool* __restrict__ out_bf, int max_leaf, int stack_size) {
  const float ox = ro[3 * r], oy = ro[3 * r + 1], oz = ro[3 * r + 2];
  const float dx = rd[3 * r], dy = rd[3 * r + 1], dz = rd[3 * r + 2];
  const float tmn = t_min[r], tmx = t_max[r];
  float t_best = tmx;
  int32_t prim = -1;
  float u_b = 0.0f, v_b = 0.0f;
  bool bf = false;
  const bool tmn_nonneg = tmn >= 0.0f;
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const int32_t rmask = kVis ? ray_mask[r] : 0;
  int32_t stack[kMaxStack];
  int sp = 0;
  int32_t cur = 0;  // the root slot
  while (true) {
    // ---- node steps, until the ray holds a leaf or nothing ----
    while (cur >= 0) {
      float4 q0, q1, q2, q3;
      node_row(nodes, cur, q0, q1, q2, q3);
      float t0, t1;
      const bool h0 = slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ox, oy, oz,
                           ix, iy, iz, tmn, t_best, &t0);
      const bool h1 = slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, ox, oy, oz,
                           ix, iy, iz, tmn, t_best, &t1);
      const int32_t c0 = __float_as_int(q3.x);
      const int32_t c1 = __float_as_int(q3.y);
      const bool near_is_0 = t0 <= t1;
      const int32_t near_code = near_is_0 ? c0 : c1;
      const int32_t far_code = near_is_0 ? c1 : c0;
      const bool near_hit = near_is_0 ? h0 : h1;
      const bool far_hit = near_is_0 ? h1 : h0;
      if (near_hit && far_hit) {
        if (sp < stack_size) stack[sp] = far_code;
        ++sp;
      }
      int32_t next = near_hit ? near_code : (far_hit ? far_code : kEmpty);
      while (next == kEmpty && sp > 0) {
        const int top = sp - 1;
        next = top < stack_size ? stack[top] : kEmpty;
        sp = top;
      }
      cur = next;
    }
    if (cur == kEmpty) break;

    // ---- one leaf step ----
    const int32_t leaf = -cur - 1;
    const int first = leaf >> 4;
    const int count = leaf & 15;
    for (int k = 0; k < max_leaf && k < count; ++k) {
      float4 r0, r1, r2;
      tri_row(tris, first + k, r0, r1, r2);
      if (kVis && (__float_as_int(r2.y) & rmask) == 0) continue;
      const float upper = kAnyHit ? tmx : t_best;
      if (tri_test::hit(r0, r1, r2, ox, oy, oz, dx, dy, dz, tmn, tmn_nonneg,
                        upper, t_best, u_b, v_b, bf)) {
        prim = first + k;
      }
    }
    if (kAnyHit && prim >= 0) sp = 0;
    int32_t next = kEmpty;
    while (next == kEmpty && sp > 0) {
      const int top = sp - 1;
      next = top < stack_size ? stack[top] : kEmpty;
      sp = top;
    }
    cur = next;
  }
  out_t[r] = t_best;
  out_prim[r] = prim;
  out_u[r] = u_b;
  out_v[r] = v_b;
  out_bf[r] = bf;
}

template <bool kAnyHit, bool kVis>
__global__ void __launch_bounds__(kThreads) trace_bvh_kernel(
    const float4* __restrict__ nodes,  // (N, 16): lo0 hi0 lo1 hi1 c0 c1 0 0
    const float4* __restrict__ tris,   // (T, 12): p0 e1 e2 vis 0 0
    const float* __restrict__ ro,      // (R, 3)
    const float* __restrict__ rd,      // (R, 3)
    const float* __restrict__ t_min,
    const float* __restrict__ t_max,
    const bool* __restrict__ active,
    const int32_t* __restrict__ ray_mask,  // (R,) with kVis, else unread
    int64_t n_rays,
    float* __restrict__ out_t,
    int32_t* __restrict__ out_prim,
    float* __restrict__ out_u,
    float* __restrict__ out_v,
    bool* __restrict__ out_bf,
    int max_leaf,
    int stack_size) {
  __shared__ int s_list[kThreads];
  __shared__ int s_count[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t own = base + threadIdx.x;
  const bool live = own < n_rays && active[own];
  if (own < n_rays && !live) {  // the miss record
    out_t[own] = t_max[own];
    out_prim[own] = -1;
    out_u[own] = 0.0f;
    out_v[own] = 0.0f;
    out_bf[own] = false;
  }
  const int n_live = live_lanes::pack_live<kThreads>(live, s_list, s_count);
  if (static_cast<int>(threadIdx.x) < n_live) {
    trace_ray<kAnyHit, kVis>(base + s_list[threadIdx.x], nodes, tris, ro, rd,
                             t_min, t_max, ray_mask, out_t, out_prim, out_u,
                             out_v, out_bf, max_leaf, stack_size);
  }
}

template <bool kVis>
int launch(const void* nodes, int n_nodes, const void* tris, int n_tris,
           const void* ro, const void* rd, const void* t_min,
           const void* t_max, const void* active, const void* ray_mask,
           int64_t n_rays, void* out_t, void* out_prim, void* out_u,
           void* out_v, void* out_bf, int max_leaf, int stack_size,
           int any_hit, void* stream) {
  if (n_nodes < 1 || n_nodes >= kMaxRows || n_tris < 1 ||
      n_tris >= kMaxRows || max_leaf < 1 || max_leaf > kMaxLeaf ||
      stack_size < 1 || stack_size > kMaxStack || n_rays <= 0 ||
      (kVis && ray_mask == nullptr) ||
      reinterpret_cast<uintptr_t>(nodes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(tris) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* nd = static_cast<const float4*>(nodes);
  const float4* tr = static_cast<const float4*>(tris);
  const float* o = static_cast<const float*>(ro);
  const float* d = static_cast<const float*>(rd);
  const float* tn = static_cast<const float*>(t_min);
  const float* tx = static_cast<const float*>(t_max);
  const bool* a = static_cast<const bool*>(active);
  const int32_t* m = static_cast<const int32_t*>(ray_mask);
  float* ot = static_cast<float*>(out_t);
  int32_t* op = static_cast<int32_t*>(out_prim);
  float* ou = static_cast<float*>(out_u);
  float* ov = static_cast<float*>(out_v);
  bool* ob = static_cast<bool*>(out_bf);
  if (any_hit) {
    trace_bvh_kernel<true, kVis>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            nd, tr, o, d, tn, tx, a, m, n_rays, ot, op, ou, ov, ob, max_leaf,
            stack_size);
  } else {
    trace_bvh_kernel<false, kVis>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            nd, tr, o, d, tn, tx, a, m, n_rays, ot, op, ou, ov, ob, max_leaf,
            stack_size);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  ``nodes``: the (n_nodes, 16) and
// ``tris`` the (n_tris, 12) cached rows, both 16-byte aligned.  Launch on
// ``stream`` and return the launch's cudaGetLastError() (0 on success);
// never synchronise.
extern "C" int trace_bvh_launch(
    const void* nodes, int n_nodes, const void* tris, int n_tris,
    const void* ro, const void* rd, const void* t_min, const void* t_max,
    const void* active, int64_t n_rays, void* out_t, void* out_prim,
    void* out_u, void* out_v, void* out_bf, int max_leaf, int stack_size,
    int any_hit, void* stream) {
  return launch<false>(nodes, n_nodes, tris, n_tris, ro, rd, t_min, t_max,
                       active, nullptr, n_rays, out_t, out_prim, out_u, out_v,
                       out_bf, max_leaf, stack_size, any_hit, stream);
}

// The masked walk: ``tris`` carries each triangle's visibility mask in word
// 9 (int bits) and ``ray_mask`` (n_rays,) i32 the rays' type bits.
extern "C" int trace_bvh_vis_launch(
    const void* nodes, int n_nodes, const void* tris, int n_tris,
    const void* ro, const void* rd, const void* t_min, const void* t_max,
    const void* active, int64_t n_rays, void* out_t, void* out_prim,
    void* out_u, void* out_v, void* out_bf, int max_leaf, int stack_size,
    const void* ray_mask, int any_hit, void* stream) {
  return launch<true>(nodes, n_nodes, tris, n_tris, ro, rd, t_min, t_max,
                      active, ray_mask, n_rays, out_t, out_prim, out_u, out_v,
                      out_bf, max_leaf, stack_size, any_hit, stream);
}
