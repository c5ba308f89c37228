// Two-level (TLAS over instances, BLAS per mesh) 8-wide ray trace over the
// unified row table ``wrows_tlas`` of ray_tpu_torch/scene/wbvh.py
// build_wtlas: each ray walks the instance tree with its own stack, enters
// the mesh tree of every instance it reaches, and tests up to max_leaf
// triangles per leaf row (Möller–Trumbore).
//
// Replaces the TPU kernel ray_tpu/ops/traverse_pallas.py:_tlas_kernel
// (pl.pallas_call in _trace_tlas_call, entry trace_tlas_pallas), which
// ray_tpu's trace_closest_tlas / trace_occlusion_tlas route every two-level
// scene to on a TPU.
//
// Semantics (identical to ray_tpu's XLA walk _traverse_wide_tlas, and
// bit-equal to the plain PyTorch version trace_tlas_plain in
// ray_tpu_torch/ops/traverse.py).  The current code ``cur`` says how the
// row it names is read:
//   * cur >= 0: wide node at row cur >> 8, children still to visit
//     cur & 0xFF.  Each child c in the mask with a code != EMPTY is tested
//     with the slab test (safe_inv directions, min/max that propagate NaN,
//     _aabb_c's operand order, hit when tn <= tf * 1.00000024f) against
//     [t_min, t_best].  The walk descends into the child with the least
//     entry distance (strict <, the first minimum wins: jnp.argmin over
//     the children, misses counted as +inf) and pushes
//     (node << 8) | (the other hit children) when that set is not empty;
//   * cur < 0, v = -cur - 1 with INST_ROW_BIT set: instance row v & ~BIT
//     (the object-from-world 3x4 transform in columns 0..11, the
//     visibility mask in 12 and the mesh's root code in 13, both int
//     bits).  When (visibility & ray_mask) != 0 the walk pushes RESTORE,
//     moves the ray into object space without renormalising (so t stays
//     world-metric), recomputes safe_inv and descends into the root;
//   * any other negative code: triangle leaf row v, slot-SoA columns p0x
//     .. p2z (9 x max_leaf) then prim (max_leaf, int bits; < 0 pads).  The
//     leaf's best hit comes by strict <, and replaces the ray's hit when it
//     is nearer than t_best;
//   * RESTORE brings back the world-space ray; EMPTY means nothing to do.
// Triangles are tested against t_best (closest hit) or t_max (any hit);
// any hit ends the walk once a triangle is taken.  A push at sp >=
// stack_size is dropped but sp still counts it, the pop of such a slot
// yields EMPTY, and the ray pops on until it finds an entry or its stack is
// empty.  A miss or an inactive lane returns t = t_max, prim = -1, u = v =
// 0, backface = false and instance row -1; the wrapper rebases the
// instance row by winst_base.  Bit-equality needs IEEE float32 with no
// contraction: build with -fmad=false -prec-div=true, never
// --use_fast_math.
//
// Bound (chip_smoke.py kernel_timings).  Operations: 13 float ops per child
// box and 8 boxes a node step, 36 per instance entry (the 3x4 transform of
// origin and direction plus three reciprocals), 46 per triangle test,
// counted from the plain version's walk at each launch's own inputs.
// Bytes: every lane reads t_max and active (5 B) and writes t, u, v, prim,
// backface and the instance row (21 B), 4 B more with a ray mask; an
// active lane also reads ro, rd, t_min (28 B); the table is read once.  A
// colonnade launch is bound by its operations by this count, but the walk
// itself is bound by latency: every step is a dependent read of one
// 224-byte row that lands anywhere in a table of several hundred KB.
//
// Design: one thread runs one ray from start to finish, branching on the
// row type (where XLA computes all three readings and selects).  The table
// does not fit in shared memory (779 KB for the colonnade against 227 KB a
// block), so rows are read from global memory through the read-only path
// (__ldg); the 50 MB L2 holds the whole table after the first touches.
// The stack is a per-thread int[64] indexed below stack_size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;                   // MAX_STACK_SIZE
constexpr int kMaxLeaf = 15;                    // LEAF_COUNT_MASK
constexpr int32_t kEmpty = INT32_MIN;
constexpr int32_t kRestore = -0x7ffffffe;
constexpr int32_t kInstRowBit = 1 << 28;

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

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ int32_t ldi(const float* p) {
  return __float_as_int(__ldg(p));
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) trace_tlas_kernel(
    const float* __restrict__ rows,  // (N, W) wrows_tlas
    int width,
    const float* __restrict__ ro,    // (R, 3)
    const float* __restrict__ rd,    // (R, 3)
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
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  const float tmx = t_max[r];
  float t_best = tmx;
  int32_t prim = -1;
  float u_b = 0.0f, v_b = 0.0f;
  bool bf = false;
  int32_t inst = -1;

  if (active[r]) {
    const float wox = ro[3 * r], woy = ro[3 * r + 1], woz = ro[3 * r + 2];
    const float wdx = rd[3 * r], wdy = rd[3 * r + 1], wdz = rd[3 * r + 2];
    const float wix = safe_inv(wdx), wiy = safe_inv(wdy), wiz = safe_inv(wdz);
    const float tmn = t_min[r];
    const int32_t rmask = ray_mask ? ray_mask[r] : 0x7fffffff;
    const int L = max_leaf;
    float ox = wox, oy = woy, oz = woz;
    float dx = wdx, dy = wdy, dz = wdz;
    float ix = wix, iy = wiy, iz = wiz;
    int32_t cur_inst = 0;
    int32_t stack[kMaxStack];
    int sp = 0;
    int32_t cur = 0xFF;  // the TLAS root row, every child
    while (cur != kEmpty) {
      int32_t next = kEmpty;
      if (cur == kRestore) {
        ox = wox; oy = woy; oz = woz;
        dx = wdx; dy = wdy; dz = wdz;
        ix = wix; iy = wiy; iz = wiz;
      } else if (cur >= 0) {
        const int32_t node = cur >> 8;
        const int32_t mask = cur & 0xFF;
        const float* row = rows + static_cast<int64_t>(node) * width;
        int best = 0;
        float best_t = 0.0f;
        int32_t ok_bits = 0;
        for (int c = 0; c < 8; ++c) {
          const float lox = ld(row + c), loy = ld(row + 8 + c);
          const float loz = ld(row + 16 + c), hix = ld(row + 24 + c);
          const float hiy = ld(row + 32 + c), hiz = ld(row + 40 + c);
          const int32_t code = ldi(row + 48 + c);
          const float tx0 = (lox - ox) * ix;
          const float tx1 = (hix - ox) * ix;
          const float ty0 = (loy - oy) * iy;
          const float ty1 = (hiy - oy) * iy;
          const float tz0 = (loz - oz) * iz;
          const float tz1 = (hiz - oz) * iz;
          const float tn = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                                   max_nan(min_nan(tz0, tz1), tmn));
          const float tf = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                                   min_nan(max_nan(tz0, tz1), t_best));
          const bool ok = (tn <= tf * 1.00000024f) && ((mask >> c) & 1) &&
                          code != kEmpty;
          const float tm = ok ? tn : __int_as_float(0x7f800000);
          if (c == 0 || tm < best_t) {
            best_t = tm;
            best = c;
          }
          ok_bits |= static_cast<int32_t>(ok) << c;
        }
        if (ok_bits != 0) {
          const int32_t rem = ok_bits & ~(1 << best);
          if (rem != 0) {
            if (sp < stack_size) stack[sp] = (node << 8) | rem;
            ++sp;
          }
          next = ldi(row + 48 + best);
        }
      } else {
        const int32_t v = -cur - 1;
        if (v & kInstRowBit) {
          const int32_t ir = v & (kInstRowBit - 1);
          const float* row = rows + static_cast<int64_t>(ir) * width;
          if ((ldi(row + 12) & rmask) != 0) {
            if (sp < stack_size) stack[sp] = kRestore;
            ++sp;
            const float m0 = ld(row), m1 = ld(row + 1), m2 = ld(row + 2);
            const float m3 = ld(row + 3), m4 = ld(row + 4), m5 = ld(row + 5);
            const float m6 = ld(row + 6), m7 = ld(row + 7), m8 = ld(row + 8);
            ox = m0 * wox + m1 * woy + m2 * woz + ld(row + 9);
            oy = m3 * wox + m4 * woy + m5 * woz + ld(row + 10);
            oz = m6 * wox + m7 * woy + m8 * woz + ld(row + 11);
            dx = m0 * wdx + m1 * wdy + m2 * wdz;
            dy = m3 * wdx + m4 * wdy + m5 * wdz;
            dz = m6 * wdx + m7 * wdy + m8 * wdz;
            ix = safe_inv(dx);
            iy = safe_inv(dy);
            iz = safe_inv(dz);
            cur_inst = ir;
            next = ldi(row + 13);
          }
        } else {
          const float* row = rows + static_cast<int64_t>(v) * width;
          const float upper = kAnyHit ? tmx : t_best;
          float lt = __int_as_float(0x7f800000);
          int32_t lprim = -1;
          float lu = 0.0f, lv = 0.0f;
          bool lbf = false;
          for (int k = 0; k < L; ++k) {
            const int32_t pk = ldi(row + 9 * L + k);
            if (pk < 0) continue;  // padding slot: never a hit
            const float p0x = ld(row + k), p0y = ld(row + L + k);
            const float p0z = ld(row + 2 * L + k);
            const float e1x = ld(row + 3 * L + k) - p0x;
            const float e1y = ld(row + 4 * L + k) - p0y;
            const float e1z = ld(row + 5 * L + k) - p0z;
            const float e2x = ld(row + 6 * L + k) - p0x;
            const float e2y = ld(row + 7 * L + k) - p0y;
            const float e2z = ld(row + 8 * L + k) - p0z;
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
            const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
            const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
            if (valid_det && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f &&
                t > tmn && t < upper && t < lt) {
              lt = t;
              lprim = pk;
              lu = u;
              lv = vv;
              lbf = det < 0.0f;
            }
          }
          if (lprim >= 0 && lt < t_best) {
            t_best = lt;
            prim = lprim;
            u_b = lu;
            v_b = lv;
            bf = lbf;
            inst = cur_inst;
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
  }
  out_t[r] = t_best;
  out_prim[r] = prim;
  out_u[r] = u_b;
  out_v[r] = v_b;
  out_bf[r] = bf;
  out_inst[r] = inst;
}

}  // namespace

// Plain C entry point for ctypes.  ``ray_mask`` may be null (every ray
// sees every instance).  Launches on ``stream`` and returns the launch's
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int trace_tlas_launch(
    const void* rows, int n_rows, int width, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* active,
    const void* ray_mask, int64_t n_rays, void* out_t, void* out_prim,
    void* out_u, void* out_v, void* out_bf, void* out_inst, int max_leaf,
    int stack_size, int any_hit, void* stream) {
  if (n_rows < 1 || n_rows >= (1 << 23) || max_leaf < 1 ||
      max_leaf > kMaxLeaf || width < 56 || width < 11 * max_leaf ||
      stack_size < 1 || stack_size > kMaxStack || n_rays <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rw = static_cast<const float*>(rows);
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
    trace_tlas_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        rw, width, o, d, tn, tx, a, m, n_rays, ot, op, ou, ov, ob, oi,
        max_leaf, stack_size);
  } else {
    trace_tlas_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        rw, width, o, d, tn, tx, a, m, n_rays, ot, op, ou, ov, ob, oi,
        max_leaf, stack_size);
  }
  return static_cast<int>(cudaGetLastError());
}
