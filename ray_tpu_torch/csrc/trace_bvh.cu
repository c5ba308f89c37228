// BVH2 ray trace for scenes of up to 512 node and triangle rows: each ray
// walks the tree with its own stack, testing two child boxes per node and
// up to max_leaf triangles per leaf (Möller–Trumbore).
//
// Replaces the TPU kernel ray_tpu/ops/traverse_pallas.py:_bvh_kernel
// (pl.pallas_call in _trace_bvh_call, entry trace_bvh_pallas), which
// ray_tpu's _pallas_mode routes every scene of 41 to 512 rows to.
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
//     and tests triangles k < max_leaf && k < count;
//   * a triangle counts when det != 0, u >= 0, v >= 0, u + v <= 1,
//     t > t_min and t < t_best (closest hit) or t < t_max (any hit);
//   * any hit: a later passing triangle of the same leaf overwrites an
//     earlier one, and the walk ends after the leaf that hit.
// A miss or an inactive lane returns t = t_max, prim = -1, u = v = 0,
// backface = false.  Child codes ride in the packed f32 node row as int
// bits.  Bit-equality needs IEEE float32 with no contraction: build with
// -fmad=false -prec-div=true, never --use_fast_math.
//
// Design: one thread runs one ray from start to finish.  The (N, 14) node
// rows and (T, 9) triangle rows are staged in dynamic shared memory once
// per block (at most 512 x 23 floats = 47.1 KB, under the 48 KB default),
// and the stack is a per-thread int[64] indexed below stack_size.
//
// Bound (chip_smoke.py kernel_timings).  Bytes: every lane reads t_max and
// active (5 B) and writes t, u, v, prim, backface (17 B); an active lane
// also reads ro, rd, t_min (28 B).  Operations: 13 float ops per box (6
// subtract, 6 multiply, 1 slack multiply), two boxes per node step, and 46
// per triangle test, counted from the plain version's walk at each
// launch's own inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 512;   // ray_tpu's T_MAX_BVH
constexpr int kMaxStack = 64;   // MAX_STACK_SIZE
constexpr int kMaxLeaf = 15;    // LEAF_COUNT_MASK
constexpr int kNodeCols = 14;
constexpr int kTriCols = 9;
constexpr int32_t kEmpty = INT32_MIN;

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

// _aabb_c: returns hit, writes the entry distance tn
__device__ __forceinline__ bool slab(const float* b, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float t_min, float t_max, float* tn_out) {
  const float tx0 = (b[0] - ox) * ix;
  const float tx1 = (b[3] - ox) * ix;
  const float ty0 = (b[1] - oy) * iy;
  const float ty1 = (b[4] - oy) * iy;
  const float tz0 = (b[2] - oz) * iz;
  const float tz1 = (b[5] - oz) * iz;
  const float tn = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                           max_nan(min_nan(tz0, tz1), t_min));
  const float tf = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                           min_nan(max_nan(tz0, tz1), t_max));
  *tn_out = tn;
  return tn <= tf * 1.00000024f;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) trace_bvh_kernel(
    const float* __restrict__ nodes,  // (N, 14): lo0 hi0 lo1 hi1 code0 code1
    int n_nodes,
    const float* __restrict__ tris,   // (T, 9): p0xyz p1xyz p2xyz per row
    int n_tris,
    const float* __restrict__ ro,     // (R, 3)
    const float* __restrict__ rd,     // (R, 3)
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
  extern __shared__ float s_rows[];
  float* s_node = s_rows;
  float* s_tri = s_rows + n_nodes * kNodeCols;
  for (int i = threadIdx.x; i < n_nodes * kNodeCols; i += blockDim.x) {
    s_node[i] = nodes[i];
  }
  for (int i = threadIdx.x; i < n_tris * kTriCols; i += blockDim.x) {
    s_tri[i] = tris[i];
  }
  __syncthreads();

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
    int32_t stack[kMaxStack];
    int sp = 0;
    int32_t cur = 0;  // the root slot
    while (cur != kEmpty) {
      int32_t next = kEmpty;
      if (cur >= 0) {
        const float* n = s_node + kNodeCols * cur;
        float t0, t1;
        const bool h0 = slab(n, ox, oy, oz, ix, iy, iz, tmn, t_best, &t0);
        const bool h1 = slab(n + 6, ox, oy, oz, ix, iy, iz, tmn, t_best, &t1);
        const int32_t c0 = __float_as_int(n[12]);
        const int32_t c1 = __float_as_int(n[13]);
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
          const float* p = s_tri + kTriCols * (first + k);
          const float e1x = p[3] - p[0], e1y = p[4] - p[1], e1z = p[5] - p[2];
          const float e2x = p[6] - p[0], e2y = p[7] - p[1], e2z = p[8] - p[2];
          const float pvx = dy * e2z - dz * e2y;
          const float pvy = dz * e2x - dx * e2z;
          const float pvz = dx * e2y - dy * e2x;
          const float det = e1x * pvx + e1y * pvy + e1z * pvz;
          const bool valid_det = det != 0.0f;
          const float inv_det = 1.0f / (valid_det ? det : 1.0f);
          const float tvx = ox - p[0], tvy = oy - p[1], tvz = oz - p[2];
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
            prim = first + k;
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
  }
  out_t[r] = t_best;
  out_prim[r] = prim;
  out_u[r] = u_b;
  out_v[r] = v_b;
  out_bf[r] = bf;
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream`` and returns the
// launch's cudaGetLastError() (0 on success); never synchronises.
extern "C" int trace_bvh_launch(
    const void* nodes, int n_nodes, const void* tris, int n_tris,
    const void* ro, const void* rd, const void* t_min, const void* t_max,
    const void* active, int64_t n_rays, void* out_t, void* out_prim,
    void* out_u, void* out_v, void* out_bf, int max_leaf, int stack_size,
    int any_hit, void* stream) {
  if (n_nodes < 1 || n_nodes > kMaxRows || n_tris < 1 || n_tris > kMaxRows ||
      max_leaf < 1 || max_leaf > kMaxLeaf || stack_size < 1 ||
      stack_size > kMaxStack || n_rays <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_nodes) * kNodeCols +
                       static_cast<size_t>(n_tris) * kTriCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* nd = static_cast<const float*>(nodes);
  const float* tr = static_cast<const float*>(tris);
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
    trace_bvh_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        nd, n_nodes, tr, n_tris, o, d, tn, tx, a, n_rays, ot, op, ou, ov, ob,
        max_leaf, stack_size);
  } else {
    trace_bvh_kernel<false><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        nd, n_nodes, tr, n_tris, o, d, tn, tx, a, n_rays, ot, op, ou, ov, ob,
        max_leaf, stack_size);
  }
  return static_cast<int>(cudaGetLastError());
}
