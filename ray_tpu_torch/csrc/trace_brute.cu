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
// launch's own active lanes and tests (chip_smoke.py kernel_timings).
// The design keeps the T x 9 triangle floats in shared memory (loaded once
// per block, read as broadcasts), one thread per ray with its ray in
// registers, so each ray byte crosses HBM once and inactive lanes neither
// load their ray nor enter the loop.  With FMA contraction off every
// multiply-add is two instructions and each test recomputes the edges and
// does an IEEE divide, so the kernel issues well above 46 instructions a
// test and cannot reach the operation bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 40;  // ray_tpu's brute-force dispatch threshold

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) trace_brute_kernel(
    const float* __restrict__ tris,  // (T, 9): p0xyz p1xyz p2xyz per row
    int n_tris,
    const float* __restrict__ ro,    // (R, 3)
    const float* __restrict__ rd,    // (R, 3)
    const float* __restrict__ t_min,
    const float* __restrict__ t_max,
    const bool* __restrict__ active,
    int64_t n_rays,
    float* __restrict__ out_t,
    int32_t* __restrict__ out_prim,
    float* __restrict__ out_u,
    float* __restrict__ out_v,
    bool* __restrict__ out_bf) {
  __shared__ float s_tri[kMaxTris * 9];
  for (int i = threadIdx.x; i < n_tris * 9; i += blockDim.x) {
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
    const float rox = ro[3 * r], roy = ro[3 * r + 1], roz = ro[3 * r + 2];
    const float rdx = rd[3 * r], rdy = rd[3 * r + 1], rdz = rd[3 * r + 2];
    const float tmn = t_min[r];
    for (int k = 0; k < n_tris; ++k) {
      const float* p = s_tri + 9 * k;
      const float e1x = p[3] - p[0], e1y = p[4] - p[1], e1z = p[5] - p[2];
      const float e2x = p[6] - p[0], e2y = p[7] - p[1], e2z = p[8] - p[2];
      const float pvx = rdy * e2z - rdz * e2y;
      const float pvy = rdz * e2x - rdx * e2z;
      const float pvz = rdx * e2y - rdy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool valid_det = det != 0.0f;
      const float inv_det = 1.0f / (valid_det ? det : 1.0f);
      const float tvx = rox - p[0], tvy = roy - p[1], tvz = roz - p[2];
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      const float upper = kAnyHit ? tmx : t_best;
      const bool hit = valid_det && u >= 0.0f && v >= 0.0f &&
                       u + v <= 1.0f && t > tmn && t < upper;
      if (hit) {
        t_best = t;
        prim = k;
        u_b = u;
        v_b = v;
        bf = det < 0.0f;
        if (kAnyHit) break;
      }
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
extern "C" int trace_brute_launch(
    const void* tris, int n_tris, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* active, int64_t n_rays,
    void* out_t, void* out_prim, void* out_u, void* out_v, void* out_bf,
    int any_hit, void* stream) {
  if (n_tris < 0 || n_tris > kMaxTris || n_rays <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
    trace_brute_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        tr, n_tris, o, d, tn, tx, a, n_rays, ot, op, ou, ov, ob);
  } else {
    trace_brute_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        tr, n_tris, o, d, tn, tx, a, n_rays, ot, op, ou, ov, ob);
  }
  return static_cast<int>(cudaGetLastError());
}
