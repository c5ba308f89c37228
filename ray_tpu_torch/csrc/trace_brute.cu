// Brute-force ray/triangle trace for small scenes: every active ray is
// tested against every triangle with Möller–Trumbore.
//
// Replaces the TPU kernel ray_tpu/ops/traverse_pallas.py:_brute_kernel
// (pl.pallas_call in _trace_brute_call, entry trace_brute_pallas), which
// ray_tpu's _pallas_mode routes every scene of <= 40 triangles to — the
// flagship Cornell frame's 6 closest-hit and 6 shadow traces.
//
// Semantics (identical to _brute_kernel, and bit-equal to the plain
// PyTorch version trace_brute_plain in ray_tpu_torch/ops/traverse.py):
//   * a triangle counts when det != 0, u >= 0, v >= 0, u + v <= 1,
//     t > t_min and t < t_best (closest hit) or t < t_max (any hit);
//   * inv_det = 1 / (det != 0 ? det : 1), then u, v, t are multiplied by it;
//   * three-term sums run left to right (x*x' + y*y' + z*z');
//   * the strict < keeps the lowest triangle index on equal t;
//   * a miss or an inactive lane returns t = t_max, prim = -1, u = v = 0,
//     backface = false.
// Any-hit stops at the first triangle that passes: callers consume only
// prim >= 0 (ray_tpu/ops/traverse.py:707), and the plain version takes the
// first passing triangle too, so all five outputs stay bit-equal.
// (_brute_kernel keeps the last passing one; the occlusion verdicts are
// the same — ROADMAP Queue 3.)
// Bit-equality needs IEEE float32 with no contraction: build with
// -fmad=false -prec-div=true, never --use_fast_math.
//
// Bound on an H100 SXM at the flagship shape (R = 2,073,600 lanes, T = 24).
// Bytes: every lane reads t_max and active (5 B) and writes t, u, v, prim
// and backface (17 B); only an active lane reads ro, rd and t_min (28 B
// more).  So a launch moves 22 B x R + 28 B x active lanes + 36 B x T:
// 46 MB (14 us at 3.35 TB/s) with no lane active, 104 MB (31 us) with all.
// Operations: 46 float multiply/add/subtract/divide per ray-triangle test
// (the edges are per triangle and the 6 compares are not FLOPs), so a
// fully active closest-hit launch does 24 x 46 = 1104 per lane, 2.3 GFLOP,
// 34 us at 67 TFLOP/s float32; any-hit counts only the tests run before
// the first hit.  The bound is the larger of the two, per launch, from that
// launch's own active lanes and tests (chip_smoke.py kernel_timings).  67
// TFLOP/s is the FMA rate: with contraction off a multiply-add is two
// instructions, so no design of this kernel issues them faster than half
// that.
//
// Design.  One thread runs one ray, its ray in registers; each ray byte
// crosses HBM once.
//   * Inactive lanes write the miss record and load no ray, and a block
//     of 256 packs its active lanes onto its first threads
//     (live_lanes.cuh), so a warp runs 32 active rays, not the few active
//     ones among 32 lanes of a late bounce.
//   * The triangles come as the wrapper's cached (T, 12) rows p0, e1, e2
//     (tri_test.cuh), staged in shared memory once a block (at most 40 x
//     48 B) and read as three 16-byte broadcasts a test, so no test
//     recomputes an edge.
//   * A test rejects a pair without dividing where tri_test.cuh's
//     divide-free pre-test proves the full test fails: most pairs stop
//     after U (one cross and two dot products, 31 SASS instructions against
//     the earlier design's 93 a test), and only pairs that pass every rule
//     pay the IEEE divide.  A warp's lanes share their instruction stream,
//     so the rest of a test runs whenever one lane of the 32 needs it: the
//     coherent primary rays gain most, the diffuse bounces' incoherent ones
//     least.  Two passes (the pre-test on every triangle keeping a bit for
//     each survivor, then the full test on the survivors) measured slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include "live_lanes.cuh"
#include "tri_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 40;  // ray_tpu's brute-force dispatch threshold
constexpr int kRow4 = 3;      // float4 a cached triangle row

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) trace_brute_kernel(
    const float4* __restrict__ tris,  // (T, 12) rows p0 e1 e2, 3 zero words
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
    bool* __restrict__ out_bf) {
  __shared__ float4 s_tri[kMaxTris * kRow4];
  __shared__ int s_list[kThreads];
  __shared__ int s_count[kThreads / 32];
  for (int i = threadIdx.x; i < n_tris * kRow4; i += blockDim.x) {
    s_tri[i] = tris[i];
  }
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
  // (its barriers also end the staging)
  const int n_live = live_lanes::pack_live<kThreads>(live, s_list, s_count);
  if (static_cast<int>(threadIdx.x) >= n_live) return;

  const int64_t r = base + s_list[threadIdx.x];
  const float tmx = t_max[r];
  float t_best = tmx;
  int32_t prim = -1;
  float u_b = 0.0f, v_b = 0.0f;
  bool bf = false;
  const float ox = ro[3 * r], oy = ro[3 * r + 1], oz = ro[3 * r + 2];
  const float dx = rd[3 * r], dy = rd[3 * r + 1], dz = rd[3 * r + 2];
  const float tmn = t_min[r];
  const bool tmn_nonneg = tmn >= 0.0f;
  for (int k = 0; k < n_tris; ++k) {
    const float4* p = s_tri + kRow4 * k;
    const float upper = kAnyHit ? tmx : t_best;
    if (tri_test::hit(p[0], p[1], p[2], ox, oy, oz, dx, dy, dz, tmn,
                      tmn_nonneg, upper, t_best, u_b, v_b, bf)) {
      prim = k;
      if (kAnyHit) break;
    }
  }
  out_t[r] = t_best;
  out_prim[r] = prim;
  out_u[r] = u_b;
  out_v[r] = v_b;
  out_bf[r] = bf;
}

}  // namespace

// Plain C entry point for ctypes.  ``tris``: the (n_tris, 12) cached rows,
// 16-byte aligned.  Launches on ``stream`` and returns the launch's
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int trace_brute_launch(
    const void* tris, int n_tris, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* active, int64_t n_rays,
    void* out_t, void* out_prim, void* out_u, void* out_v, void* out_bf,
    int any_hit, void* stream) {
  if (n_tris < 0 || n_tris > kMaxTris || n_rays <= 0 ||
      reinterpret_cast<uintptr_t>(tris) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* tr = static_cast<const float4*>(tris);
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
    trace_brute_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        tr, n_tris, o, d, tn, tx, a, n_rays, ot, op, ou, ov, ob);
  } else {
    trace_brute_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        tr, n_tris, o, d, tn, tx, a, n_rays, ot, op, ou, ov, ob);
  }
  return static_cast<int>(cudaGetLastError());
}
