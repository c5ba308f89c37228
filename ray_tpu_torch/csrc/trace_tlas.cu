// Two-level (TLAS over instances, BLAS per mesh) 8-wide ray trace over the
// unified row table ``wrows_tlas`` of ray_tpu_torch/scene/wbvh.py
// build_wtlas: each ray walks the instance tree with its own stack, enters
// the mesh tree of every instance it reaches, and tests up to max_leaf
// triangles per leaf row (Möller–Trumbore).
//
// Replaces the TPU kernel ray_tpu/ops/traverse_pallas.py:_tlas_kernel
// (pl.pallas_call in _trace_tlas_call, entry trace_tlas_pallas), which
// ray_tpu's trace_closest_tlas / trace_occlusion_tlas route every two-level
// scene with a wrows_tlas table to on a TPU.  It also serves the flatten
// 8-wide walk _traverse_wide (a table without instance rows), and its
// masked instantiation (kVis) that walk's per-triangle visibility test
// (has_vis, ray_tpu/ops/traverse.py:326-331).
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
//     .. p2z (9 x max_leaf), prim (max_leaf, int bits; < 0 pads) and the
//     visibility masks (max_leaf, int bits).  A slot counts when its prim
//     is >= 0 and, in the masked instantiation, its mask meets ray_mask.
//     The leaf's best hit comes by strict <, and replaces the ray's hit
//     when it is nearer than t_best;
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
// Bound (chip_smoke.py launch_bound).  Operations: 13 float ops per child
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
// Design.  One thread runs one ray from start to finish; the table does
// not fit in shared memory (779 KB for the colonnade against 227 KB a
// block), so rows are read from global memory through the read-only path
// (__ldg) and the 50 MB L2 holds the whole table after the first touches.
//   * Rows are read as 16-byte loads (float4): 14 for a node row, 4 for an
//     instance row, 10 a group of four slots of a leaf row (11 masked).
//     The wrapper hands over a table whose width is a multiple of 4 floats
//     and whose base is 16-byte aligned — for a max_leaf whose width
//     max(56, 11 max_leaf) is not, a cached copy padded with zero columns
//     (ops/traverse.py check_tlas_rows) — and the kernel steps rows by
//     that width; a leaf row whose max_leaf is not a multiple of 4 is read
//     slot by slot.
//   * Leaf visibility is a compile-time flag, so the unmasked walk is the
//     kernel it was.
//   * The walk is a while-while loop (Aila & Laine, "Understanding the
//     efficiency of ray traversal on GPUs", HPG 2009): an inner loop runs
//     node steps until the ray holds a leaf, an instance entry or RESTORE,
//     then that one step runs, so a warp's lanes step through node rows
//     together instead of serialising over three kinds of row.  Each
//     ray's sequence of steps is the one above.
//   * One thread a ray over a grid of all rays: persistent warps (the
//     grid filling the card once, each warp taking its next 32 rays from
//     a global counter) measured 1-4% slower over the colonnade tiles,
//     whose compacted launches fit in one wave (tools/kernel_variants.py).
//   * Min and max of the box tests are the hardware's NaN-propagating
//     max.NaN / min.NaN: they agree with jnp.maximum / jnp.minimum except
//     for the sign of a zero, which only ever meets comparisons.
//   * The stack is a per-thread int[64] (local memory, cached in L1)
//     indexed below stack_size: a shared-memory stack (32 KB a block)
//     measured 2-4% slower (tools/kernel_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;                   // MAX_STACK_SIZE
constexpr int kMaxLeaf = 15;                    // LEAF_COUNT_MASK
constexpr int32_t kEmpty = INT32_MIN;
constexpr int32_t kRestore = -0x7ffffffe;
constexpr int32_t kInstRowBit = 1 << 28;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

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

__device__ __forceinline__ float comp(const float4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

// The ray's hit record and the current-space ray.
struct Walk {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float t_best;
  int32_t prim;
  float u, v;
  bool bf;
  int32_t inst;
};

// One slot's Möller–Trumbore; ``lt`` etc. the leaf's best so far (strict <)
__device__ __forceinline__ void tri_slot(
    const Walk& w, float p0x, float p0y, float p0z, float p1x, float p1y,
    float p1z, float p2x, float p2y, float p2z, int32_t pk, float tmn,
    float upper, float& lt, int32_t& lprim, float& lu, float& lv, bool& lbf) {
  if (pk < 0) return;  // padding slot: never a hit
  const float e1x = p1x - p0x, e1y = p1y - p0y, e1z = p1z - p0z;
  const float e2x = p2x - p0x, e2y = p2y - p0y, e2z = p2z - p0z;
  const float pvx = w.dy * e2z - w.dz * e2y;
  const float pvy = w.dz * e2x - w.dx * e2z;
  const float pvz = w.dx * e2y - w.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool valid_det = det != 0.0f;
  const float inv_det = 1.0f / (valid_det ? det : 1.0f);
  const float tvx = w.ox - p0x, tvy = w.oy - p0y, tvz = w.oz - p0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = (w.dx * qvx + w.dy * qvy + w.dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  if (valid_det && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f && t > tmn &&
      t < upper && t < lt) {
    lt = t;
    lprim = pk;
    lu = u;
    lv = vv;
    lbf = det < 0.0f;
  }
}

template <bool kAnyHit, bool kVis>
__device__ __forceinline__ void trace_ray(
    int r, const float4* __restrict__ rows, int w4,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const bool* __restrict__ active, const int32_t* __restrict__ ray_mask,
    float* __restrict__ out_t, int32_t* __restrict__ out_prim,
    float* __restrict__ out_u, float* __restrict__ out_v,
    bool* __restrict__ out_bf, int32_t* __restrict__ out_inst, int max_leaf,
    int stack_size) {
  const float tmx = t_max[r];
  Walk w;
  w.t_best = tmx;
  w.prim = -1;
  w.u = 0.0f;
  w.v = 0.0f;
  w.bf = false;
  w.inst = -1;

  if (active[r]) {
    const float wox = ro[3 * r], woy = ro[3 * r + 1], woz = ro[3 * r + 2];
    const float wdx = rd[3 * r], wdy = rd[3 * r + 1], wdz = rd[3 * r + 2];
    const float wix = safe_inv(wdx), wiy = safe_inv(wdy), wiz = safe_inv(wdz);
    const float tmn = t_min[r];
    const int32_t rmask = ray_mask ? ray_mask[r] : 0x7fffffff;
    const int L = max_leaf;
    w.ox = wox; w.oy = woy; w.oz = woz;
    w.dx = wdx; w.dy = wdy; w.dz = wdz;
    w.ix = wix; w.iy = wiy; w.iz = wiz;
    int32_t cur_inst = 0;
    int32_t stack[kMaxStack];
    int sp = 0;
    int32_t cur = 0xFF;  // the TLAS root row, every child
    while (true) {
      // ---- node steps, until the ray holds something else ----
      while (cur >= 0) {
        const int32_t node = cur >> 8;
        const int32_t mask = cur & 0xFF;
        const float4* row = rows + static_cast<int64_t>(node) * w4;
        float4 q[14];
#pragma unroll
        for (int i = 0; i < 14; ++i) q[i] = __ldg(row + i);
        int best = 0;
        float best_t = 0.0f;
        int32_t best_code = kEmpty;
        int32_t ok_bits = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int h = c >> 2, j = c & 3;
          const float lox = comp(q[0 + h], j), loy = comp(q[2 + h], j);
          const float loz = comp(q[4 + h], j), hix = comp(q[6 + h], j);
          const float hiy = comp(q[8 + h], j), hiz = comp(q[10 + h], j);
          const int32_t code = __float_as_int(comp(q[12 + h], j));
          const float tx0 = (lox - w.ox) * w.ix;
          const float tx1 = (hix - w.ox) * w.ix;
          const float ty0 = (loy - w.oy) * w.iy;
          const float ty1 = (hiy - w.oy) * w.iy;
          const float tz0 = (loz - w.oz) * w.iz;
          const float tz1 = (hiz - w.oz) * w.iz;
          const float tn = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                                   max_nan(min_nan(tz0, tz1), tmn));
          const float tf = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                                   min_nan(max_nan(tz0, tz1), w.t_best));
          const bool ok = (tn <= tf * 1.00000024f) && ((mask >> c) & 1) &&
                          code != kEmpty;
          const float tm = ok ? tn : inf();
          if (c == 0 || tm < best_t) {
            best_t = tm;
            best = c;
            best_code = code;
          }
          ok_bits |= static_cast<int32_t>(ok) << c;
        }
        int32_t next = kEmpty;
        if (ok_bits != 0) {
          const int32_t rem = ok_bits & ~(1 << best);
          if (rem != 0) {
            if (sp < stack_size) stack[sp] = (node << 8) | rem;
            ++sp;
          }
          next = best_code;
        }
        while (next == kEmpty && sp > 0) {
          const int top = sp - 1;
          next = top < stack_size ? stack[top] : kEmpty;
          sp = top;
        }
        cur = next;
      }
      if (cur == kEmpty) break;

      // ---- one RESTORE, instance or leaf step ----
      int32_t next = kEmpty;
      if (cur == kRestore) {
        w.ox = wox; w.oy = woy; w.oz = woz;
        w.dx = wdx; w.dy = wdy; w.dz = wdz;
        w.ix = wix; w.iy = wiy; w.iz = wiz;
      } else {
        const int32_t v = -cur - 1;
        if (v & kInstRowBit) {
          const int32_t ir = v & (kInstRowBit - 1);
          const float4* row = rows + static_cast<int64_t>(ir) * w4;
          const float4 q3 = __ldg(row + 3);  // visibility, root code
          if ((__float_as_int(q3.x) & rmask) != 0) {
            if (sp < stack_size) stack[sp] = kRestore;
            ++sp;
            const float4 q0 = __ldg(row), q1 = __ldg(row + 1);
            const float4 q2 = __ldg(row + 2);
            const float m0 = q0.x, m1 = q0.y, m2 = q0.z, m3 = q0.w;
            const float m4 = q1.x, m5 = q1.y, m6 = q1.z, m7 = q1.w;
            const float m8 = q2.x;
            w.ox = m0 * wox + m1 * woy + m2 * woz + q2.y;
            w.oy = m3 * wox + m4 * woy + m5 * woz + q2.z;
            w.oz = m6 * wox + m7 * woy + m8 * woz + q2.w;
            w.dx = m0 * wdx + m1 * wdy + m2 * wdz;
            w.dy = m3 * wdx + m4 * wdy + m5 * wdz;
            w.dz = m6 * wdx + m7 * wdy + m8 * wdz;
            w.ix = safe_inv(w.dx);
            w.iy = safe_inv(w.dy);
            w.iz = safe_inv(w.dz);
            cur_inst = ir;
            next = __float_as_int(q3.y);
          }
        } else {
          const float4* row = rows + static_cast<int64_t>(v) * w4;
          const float upper = kAnyHit ? tmx : w.t_best;
          float lt = inf();
          int32_t lprim = -1;
          float lu = 0.0f, lv = 0.0f;
          bool lbf = false;
          if ((L & 3) == 0) {
            // slot-SoA columns of L floats: column c, slots 4g..4g+3 are
            // float4 c * (L / 4) + g
            const int l4 = L >> 2;
            for (int g = 0; g < l4; ++g) {
              constexpr int kCols = kVis ? 11 : 10;
              float4 p[kCols];
#pragma unroll
              for (int c = 0; c < kCols; ++c) p[c] = __ldg(row + c * l4 + g);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                int32_t pk = __float_as_int(comp(p[9], j));
                // a slot the ray's type may not see counts as padding
                if (kVis && (__float_as_int(comp(p[kCols - 1], j)) & rmask) ==
                                0) {
                  pk = -1;
                }
                tri_slot(w, comp(p[0], j), comp(p[1], j), comp(p[2], j),
                         comp(p[3], j), comp(p[4], j), comp(p[5], j),
                         comp(p[6], j), comp(p[7], j), comp(p[8], j), pk,
                         tmn, upper, lt, lprim, lu, lv, lbf);
              }
            }
          } else {
            const float* f = reinterpret_cast<const float*>(row);
            for (int k = 0; k < L; ++k) {
              int32_t pk = __float_as_int(__ldg(f + 9 * L + k));
              if (kVis && (__float_as_int(__ldg(f + 10 * L + k)) & rmask) ==
                              0) {
                pk = -1;
              }
              tri_slot(w, __ldg(f + k), __ldg(f + L + k), __ldg(f + 2 * L + k),
                       __ldg(f + 3 * L + k), __ldg(f + 4 * L + k),
                       __ldg(f + 5 * L + k), __ldg(f + 6 * L + k),
                       __ldg(f + 7 * L + k), __ldg(f + 8 * L + k), pk, tmn,
                       upper, lt, lprim, lu, lv, lbf);
            }
          }
          if (lprim >= 0 && lt < w.t_best) {
            w.t_best = lt;
            w.prim = lprim;
            w.u = lu;
            w.v = lv;
            w.bf = lbf;
            w.inst = cur_inst;
          }
        }
      }
      if (kAnyHit && w.prim >= 0) {
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
  out_t[r] = w.t_best;
  out_prim[r] = w.prim;
  out_u[r] = w.u;
  out_v[r] = w.v;
  out_bf[r] = w.bf;
  out_inst[r] = w.inst;
}

template <bool kAnyHit, bool kVis>
__global__ void __launch_bounds__(kThreads) trace_tlas_kernel(
    const float4* __restrict__ rows,  // (N, W) wrows_tlas, W = 4 * w4
    int w4,
    const float* __restrict__ ro,    // (R, 3)
    const float* __restrict__ rd,    // (R, 3)
    const float* __restrict__ t_min,
    const float* __restrict__ t_max,
    const bool* __restrict__ active,
    const int32_t* __restrict__ ray_mask,  // (R,) or null: 0x7fffffff
    int n_rays,
    float* __restrict__ out_t,
    int32_t* __restrict__ out_prim,
    float* __restrict__ out_u,
    float* __restrict__ out_v,
    bool* __restrict__ out_bf,
    int32_t* __restrict__ out_inst,
    int max_leaf,
    int stack_size) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n_rays) {
    trace_ray<kAnyHit, kVis>(r, rows, w4, ro, rd, t_min, t_max, active,
                             ray_mask,
                       out_t, out_prim, out_u, out_v, out_bf, out_inst,
                       max_leaf, stack_size);
  }
}

template <bool kVis>
int launch(
    const void* rows, int n_rows, int width, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* active,
    const void* ray_mask, int64_t n_rays, void* out_t, void* out_prim,
    void* out_u, void* out_v, void* out_bf, void* out_inst, int max_leaf,
    int stack_size, int any_hit, void* stream) {
  if (n_rows < 1 || n_rows >= (1 << 23) || max_leaf < 1 ||
      max_leaf > kMaxLeaf || width < 56 || width < 11 * max_leaf ||
      width % 4 != 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      stack_size < 1 || stack_size > kMaxStack || n_rays <= 0 ||
      n_rays >= (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>((n_rays + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* rw = static_cast<const float4*>(rows);
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
  const int R = static_cast<int>(n_rays);
  if (any_hit) {
    trace_tlas_kernel<true, kVis><<<blocks, kThreads, 0, s>>>(
        rw, width / 4, o, d, tn, tx, a, m, R, ot, op, ou, ov, ob, oi,
        max_leaf, stack_size);
  } else {
    trace_tlas_kernel<false, kVis><<<blocks, kThreads, 0, s>>>(
        rw, width / 4, o, d, tn, tx, a, m, R, ot, op, ou, ov, ob, oi,
        max_leaf, stack_size);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  ``rows``: the (n_rows, width) table,
// width a multiple of 4 floats, 16-byte aligned.  ``ray_mask`` may be null
// (every ray type).  Launch on ``stream`` and return the launch's
// cudaGetLastError() (0 on success); never synchronise.
extern "C" int trace_tlas_launch(
    const void* rows, int n_rows, int width, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* active,
    const void* ray_mask, int64_t n_rays, void* out_t, void* out_prim,
    void* out_u, void* out_v, void* out_bf, void* out_inst, int max_leaf,
    int stack_size, int any_hit, void* stream) {
  return launch<false>(rows, n_rows, width, ro, rd, t_min, t_max, active,
                       ray_mask, n_rays, out_t, out_prim, out_u, out_v,
                       out_bf, out_inst, max_leaf, stack_size, any_hit,
                       stream);
}

// The masked flatten walk: a leaf slot counts only when its visibility
// column (10 max_leaf + k) meets the ray's ray_mask.
extern "C" int trace_tlas_vis_launch(
    const void* rows, int n_rows, int width, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* active,
    const void* ray_mask, int64_t n_rays, void* out_t, void* out_prim,
    void* out_u, void* out_v, void* out_bf, void* out_inst, int max_leaf,
    int stack_size, int any_hit, void* stream) {
  return launch<true>(rows, n_rows, width, ro, rd, t_min, t_max, active,
                      ray_mask, n_rays, out_t, out_prim, out_u, out_v, out_bf,
                      out_inst, max_leaf, stack_size, any_hit, stream);
}
