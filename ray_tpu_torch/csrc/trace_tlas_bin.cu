// Binary two-level ray trace (a BVH2 over the instances, one BVH2 per
// mesh in object space) for tlas scenes without the 8-wide table: each ray
// walks the instance tree with its own stack, enters the mesh tree of
// every instance it reaches and may see, and tests up to max_leaf
// triangles per leaf (Möller–Trumbore).
//
// Replaces ray_tpu's XLA walk _traverse_tlas (ray_tpu/ops/traverse.py:
// 844-986), which ray_tpu's trace_closest_tlas / trace_occlusion_tlas run
// for every two-level scene finalized without wrows_tlas (those of <= 256
// unique triangles, ray_tpu/scene/scene.py:811).  It is XLA code, not a
// Pallas kernel: ray_tpu has no TPU kernel for it.
//
// Semantics (identical to _traverse_tlas, and bit-equal to the plain
// PyTorch version trace_tlas_bin_plain in ray_tpu_torch/ops/traverse.py).
// The tables are the tlas finalize's: node rows (the TLAS first, then
// every mesh's BVH, child codes pre-offset), object-space triangle rows,
// and one row an instance.  The current code ``cur`` says what to do:
//   * cur >= 0: node cur.  Both child boxes are tested in the current-
//     space ray with the slab test (safe_inv directions, min/max that
//     propagate NaN, _aabb_c's operand order, hit when tn <= tf *
//     1.00000024f) against [t_min, t_best]; the near child is the one with
//     t0 <= t1 on the entry distances, hit or not; the walk descends into
//     the near child if it is hit, else into the far child if that is hit,
//     and pushes the far child only when both are hit;
//   * cur < 0, v = -cur - 1 with INST_LEAF_FLAG (1 << 28) set: instance
//     v & ~FLAG.  When its visibility mask meets ray_mask the walk pushes
//     RESTORE, moves the ray into object space — origin ((m0 x + m1 y) +
//     m2 z) + t, direction the same without t, not renormalised, so t
//     stays world-metric — recomputes safe_inv and descends into the
//     mesh's root code; otherwise nothing;
//   * any other negative code: a triangle leaf, first = v >> 4, count =
//     v & 15; triangles k < max_leaf && k < count are tested against
//     t_best (closest hit) or t_max (any hit, where a later passing
//     triangle of the leaf overwrites an earlier one), each take recording
//     the instance the ray is in; any hit ends the walk after the leaf
//     that hit;
//   * RESTORE brings back the world-space ray; EMPTY means nothing to do.
// The following pop is folded into each step.  A push at sp >= stack_size
// is dropped but sp still counts it, the pop of such a slot yields EMPTY,
// and the ray pops on until it finds an entry or its stack is empty (what
// _traverse_tlas does while any other lane of its batch still walks).  A
// miss or an inactive lane returns t = t_max, prim = -1, u = v = 0,
// backface = false, instance -1.  Bit-equality needs IEEE float32 with no
// contraction: build with -fmad=false -prec-div=true, never
// --use_fast_math.
//
// Bound (chip_smoke.py launch_bound).  Bytes: every lane reads t_max and
// active (5 B), a ray mask when given (4 B), and writes t, u, v, prim,
// backface and instance (21 B); an active lane also reads ro, rd, t_min
// (28 B); the tables are read once.  Operations: 26 float ops a node step
// (two boxes of 13), 36 an instance entry (the 3x4 transform of origin
// and direction, three reciprocals), 46 a triangle test, counted from the
// plain version's walk at each launch's own inputs.  A Cornell-sized scene
// needs a few tens of microseconds either way at 2,073,600 lanes; the walk
// itself is bound by its chain of dependent row reads and its divergence.
//
// Design: trace_bvh.cu's, the BVH2 walk this one nests twice.
//   * One thread runs one ray from start to finish.  Inactive lanes write
//     the miss record and load no ray, and a block of 256 packs its active
//     lanes onto its first threads (live_lanes.cuh).
//   * The tables are the wrapper's cached, 16-byte-aligned rows (ops/
//     traverse.py node_rows, tri_rows and inst_rows, built once a scene):
//     node rows of 16 floats (lo0 hi0 lo1 hi1, the child codes, two zero
//     words), triangle rows of 12 (p0 e1 e2, tri_test.cuh) and instance
//     rows of 16 (the object-from-world 3x3 row-major, its translation,
//     the visibility mask and root code as int bits, two zero words), read
//     through the read-only path (__ldg) as float4 and never staged: a
//     Cornell box's tables are 2.2 KB and stay in each SM's L1.
//   * The walk is a while-while loop (Aila & Laine, HPG 2009): node steps
//     of both levels run until the ray holds a leaf, an instance or
//     RESTORE; then that one step runs.  Each ray's own sequence of steps,
//     pushes, pops and overflow is the one above.
//   * Box tests take min and max from the hardware's NaN-propagating
//     max.NaN / min.NaN: they agree with jnp.maximum / jnp.minimum except
//     for the sign of a zero, which only ever meets comparisons.
//   * A triangle test is tri_test.cuh's: a divide-free pre-test, then the
//     full test for the pairs it cannot reject.  Its rules bound U, V, T
//     against det, all of which scale with the direction, and assume
//     nothing of the direction's length: they hold for the object-space
//     rays of scaled instances, whose directions are not unit.
//   * The stack is a per-thread int[64] (local memory, cached in L1)
//     indexed below stack_size; the world-space ray stays in registers
//     beside the current one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "live_lanes.cuh"
#include "tri_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 1 << 27;   // a leaf code's first << 4 | count
constexpr int kMaxStack = 64;       // MAX_STACK_SIZE
constexpr int kMaxLeaf = 15;        // LEAF_COUNT_MASK
constexpr int kNode4 = 4;           // float4 a node row
constexpr int kTri4 = 3;            // float4 a triangle row
constexpr int kInst4 = 4;           // float4 an instance row
constexpr int32_t kEmpty = INT32_MIN;
constexpr int32_t kRestore = -0x7ffffffe;
constexpr int32_t kInstLeafFlag = 1 << 28;

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

__device__ __forceinline__ int32_t pop(const int32_t* stack, int& sp,
                                       int stack_size) {
  int32_t next = kEmpty;
  while (next == kEmpty && sp > 0) {
    const int top = sp - 1;
    next = top < stack_size ? stack[top] : kEmpty;
    sp = top;
  }
  return next;
}

// The walk of the active ray r; writes its hit record.
template <bool kAnyHit>
__device__ __forceinline__ void trace_ray(
    int64_t r, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, const float4* __restrict__ insts,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const int32_t* __restrict__ ray_mask, float* __restrict__ out_t,
    int32_t* __restrict__ out_prim, float* __restrict__ out_u,
    float* __restrict__ out_v, bool* __restrict__ out_bf,
    int32_t* __restrict__ out_inst, int max_leaf, int stack_size) {
  const float wox = ro[3 * r], woy = ro[3 * r + 1], woz = ro[3 * r + 2];
  const float wdx = rd[3 * r], wdy = rd[3 * r + 1], wdz = rd[3 * r + 2];
  const float wix = safe_inv(wdx), wiy = safe_inv(wdy), wiz = safe_inv(wdz);
  const float tmn = t_min[r], tmx = t_max[r];
  const bool tmn_nonneg = tmn >= 0.0f;
  const int32_t rmask = ray_mask ? ray_mask[r] : 0x7fffffff;
  float ox = wox, oy = woy, oz = woz;
  float dx = wdx, dy = wdy, dz = wdz;
  float ix = wix, iy = wiy, iz = wiz;
  float t_best = tmx;
  int32_t prim = -1, inst = -1, cur_inst = 0;
  float u_b = 0.0f, v_b = 0.0f;
  bool bf = false;
  int32_t stack[kMaxStack];
  int sp = 0;
  int32_t cur = 0;  // the TLAS root
  while (true) {
    // ---- node steps of either level, until the ray holds something else
    while (cur >= 0) {
      const float4* n = nodes + kNode4 * cur;
      const float4 q0 = __ldg(&n[0]), q1 = __ldg(&n[1]);
      const float4 q2 = __ldg(&n[2]), q3 = __ldg(&n[3]);
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
      if (next == kEmpty) next = pop(stack, sp, stack_size);
      cur = next;
    }
    if (cur == kEmpty) break;

    // ---- one RESTORE, instance or triangle-leaf step ----
    int32_t next = kEmpty;
    if (cur == kRestore) {
      ox = wox; oy = woy; oz = woz;
      dx = wdx; dy = wdy; dz = wdz;
      ix = wix; iy = wiy; iz = wiz;
    } else {
      const int32_t v = -cur - 1;
      if (v & kInstLeafFlag) {
        const int32_t ii = v & (kInstLeafFlag - 1);
        const float4* row = insts + kInst4 * ii;
        const float4 q3 = __ldg(&row[3]);  // visibility, root code
        if ((__float_as_int(q3.x) & rmask) != 0) {
          if (sp < stack_size) stack[sp] = kRestore;
          ++sp;
          const float4 q0 = __ldg(&row[0]), q1 = __ldg(&row[1]);
          const float4 q2 = __ldg(&row[2]);
          const float m0 = q0.x, m1 = q0.y, m2 = q0.z, m3 = q0.w;
          const float m4 = q1.x, m5 = q1.y, m6 = q1.z, m7 = q1.w;
          const float m8 = q2.x;
          ox = m0 * wox + m1 * woy + m2 * woz + q2.y;
          oy = m3 * wox + m4 * woy + m5 * woz + q2.z;
          oz = m6 * wox + m7 * woy + m8 * woz + q2.w;
          dx = m0 * wdx + m1 * wdy + m2 * wdz;
          dy = m3 * wdx + m4 * wdy + m5 * wdz;
          dz = m6 * wdx + m7 * wdy + m8 * wdz;
          ix = safe_inv(dx);
          iy = safe_inv(dy);
          iz = safe_inv(dz);
          cur_inst = ii;
          next = __float_as_int(q3.y);
        }
      } else {
        const int first = v >> 4;
        const int count = v & 15;
        for (int k = 0; k < max_leaf && k < count; ++k) {
          const float4* p = tris + kTri4 * (first + k);
          const float4 r0 = __ldg(&p[0]), r1 = __ldg(&p[1]);
          const float4 r2 = __ldg(&p[2]);
          const float upper = kAnyHit ? tmx : t_best;
          if (tri_test::hit(r0, r1, r2, ox, oy, oz, dx, dy, dz, tmn,
                            tmn_nonneg, upper, t_best, u_b, v_b, bf)) {
            prim = first + k;
            inst = cur_inst;
          }
        }
        if (kAnyHit && prim >= 0) sp = 0;
      }
    }
    if (next == kEmpty) next = pop(stack, sp, stack_size);
    cur = next;
  }
  out_t[r] = t_best;
  out_prim[r] = prim;
  out_u[r] = u_b;
  out_v[r] = v_b;
  out_bf[r] = bf;
  out_inst[r] = inst;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) trace_tlas_bin_kernel(
    const float4* __restrict__ nodes,  // (N, 16): lo0 hi0 lo1 hi1 c0 c1 0 0
    const float4* __restrict__ tris,   // (T, 12): p0 e1 e2 0 0 0
    const float4* __restrict__ insts,  // (I, 16): inv 3x3, invt, vis, root
    const float* __restrict__ ro,      // (R, 3)
    const float* __restrict__ rd,      // (R, 3)
    const float* __restrict__ t_min,
    const float* __restrict__ t_max,
    const bool* __restrict__ active,
    const int32_t* __restrict__ ray_mask,  // (R,) or null: 0x7fffffff
    int64_t n_rays,
    float* __restrict__ out_t,
    int32_t* __restrict__ out_prim,
    float* __restrict__ out_u,
    float* __restrict__ out_v,
    bool* __restrict__ out_bf,
    int32_t* __restrict__ out_inst,
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
    out_inst[own] = -1;
  }
  const int n_live = live_lanes::pack_live<kThreads>(live, s_list, s_count);
  if (static_cast<int>(threadIdx.x) < n_live) {
    trace_ray<kAnyHit>(base + s_list[threadIdx.x], nodes, tris, insts, ro, rd,
                       t_min, t_max, ray_mask, out_t, out_prim, out_u, out_v,
                       out_bf, out_inst, max_leaf, stack_size);
  }
}

}  // namespace

// Plain C entry point for ctypes.  ``nodes``: the (n_nodes, 16), ``tris``
// the (n_tris, 12) and ``insts`` the (n_inst, 16) cached rows, each
// 16-byte aligned; ``ray_mask`` (n_rays,) i32 or null (every ray type).
// Launches on ``stream`` and returns the launch's cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int trace_tlas_bin_launch(
    const void* nodes, int n_nodes, const void* tris, int n_tris,
    const void* insts, int n_inst, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* active,
    const void* ray_mask, int64_t n_rays, void* out_t, void* out_prim,
    void* out_u, void* out_v, void* out_bf, void* out_inst, int max_leaf,
    int stack_size, int any_hit, void* stream) {
  if (n_nodes < 1 || n_nodes >= kMaxRows || n_tris < 1 ||
      n_tris >= kMaxRows || n_inst < 1 || n_inst >= kInstLeafFlag ||
      max_leaf < 1 || max_leaf > kMaxLeaf || stack_size < 1 ||
      stack_size > kMaxStack || n_rays <= 0 ||
      reinterpret_cast<uintptr_t>(nodes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(tris) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(insts) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* nd = static_cast<const float4*>(nodes);
  const float4* tr = static_cast<const float4*>(tris);
  const float4* in = static_cast<const float4*>(insts);
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
  int32_t* oi = static_cast<int32_t*>(out_inst);
  if (any_hit) {
    trace_tlas_bin_kernel<true>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            nd, tr, in, o, d, tn, tx, a, m, n_rays, ot, op, ou, ov, ob, oi,
            max_leaf, stack_size);
  } else {
    trace_tlas_bin_kernel<false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            nd, tr, in, o, d, tn, tx, a, m, n_rays, ot, op, ou, ov, ob, oi,
            max_leaf, stack_size);
  }
  return static_cast<int>(cudaGetLastError());
}
