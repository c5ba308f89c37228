// Möller–Trumbore on a cached triangle row, with a divide-free pre-test:
// the ray-triangle test of trace_brute.cu and trace_bvh.cu.
//
// The row is 12 floats, read as three float4: p0 (3), e1 = p1 - p0 (3),
// e2 = p2 - p0 (3) and three zero words.  The wrapper builds the rows once
// a triangle table (ray_tpu_torch/ops/traverse.py tri_rows) with the same
// float32 subtractions the plain versions make, so the edges have the
// plain versions' bits.
//
// The full test (ray_tpu's _brute_kernel / _tri_c, in their expression
// order) is
//   pv = rd x e2, det = e1 . pv, tv = ro - p0, U = tv . pv,
//   qv = tv x e1, V = rd . qv, T = e2 . qv (each sum left to right),
//   inv = 1 / (det != 0 ? det : 1), u = U inv, v = V inv, t = T inv,
//   hit = det != 0 && u >= 0 && v >= 0 && u + v <= 1 && t > t_min &&
//         t < upper.
// Its IEEE divide is the dearest instruction sequence of a test, and most
// pairs fail on u or v.  So U, V and T are computed first, and a pair is
// rejected without dividing where the signs and sizes of U, V, T and det
// show that the full test fails.  Survivors run the full test unchanged,
// so a result is the full test's bit for bit.
//
// The argument.  Write a = |det|, and Us, Vs, Ts for U, V, T with their
// sign flipped where det's sign bit is set (so Us / a = U / det exactly,
// and u = RN(Us |inv|): inv carries det's sign).  RN is float32
// round-to-nearest (no flush to zero: the port builds without fast math).
// Take det finite and non-zero (det == 0 fails the full test anyway; a NaN
// or infinite a makes every bound below NaN or +inf, so no rule fires).
// Then inv != 0, since |1 / det| >= 1 / FLT_MAX > 2^-150 rounds to a
// non-zero float; inv = +-inf when a <= 2^-128; otherwise |inv| is within
// a relative 2^-22 of 1 / a (2^-24 where 1 / a is normal, 2^-150 absolute
// where it is subnormal, i.e. a > 2^126).
//
//   (R1) Us < -(a 2^-60)  =>  u < 0.  u's sign is Us's, so it is negative
//        unless u rounds to -0, i.e. |U inv| <= 2^-150.  If inv = +-inf, u
//        = -inf (U != 0).  If a >= 2^-66, a 2^-60 is exact and |U| /
//        a > 2^-60, so |U inv| > 2^-60 (1 - 2^-22).  If a < 2^-66, |inv| >=
//        2^66 and |U| >= 2^-149 (U != 0), so |U inv| >= 2^-83.  u < 0 fails
//        u >= 0; a product that would round to -0 (and pass u >= 0) never
//        meets the rule.  A NaN U meets no rule.
//   (R2) the same for Vs and v.
//   (R3) RN(Us + Vs) > RN(a c), c = 1 + 2^-10  =>  the full test fails.
//        If it passes, u >= 0 and v >= 0; with inv = +-inf that means u =
//        +inf (U != 0, else NaN), so u + v = +inf > 1.  Otherwise RN(a c)
//        >= 2^-128 carries a relative error of at most 2^-22, and so does
//        RN(Us + Vs) above it, so Us / a + Vs / a > c (1 - 2^-22)^2 > 1 +
//        2^-11.  u >= 0 bounds U / det below by -2^-149 (a smaller value
//        rounds to a negative u), and the same for V; with |inv| within
//        2^-22 and the two products' rounding, u + v >= (U + V) / det
//        (1 - 2^-21) - 2^-148 > 1 + 2^-12, and RN keeps it above 1: u + v
//        <= 1 fails.  An overflowing u or v is +inf: the same.
//   (R4) t_min >= 0 and Ts < -(a 2^-60)  =>  t < 0 <= t_min (as R1): t >
//        t_min fails.  A t_min below 0 (or NaN) never meets the rule.
//   (R5) Ts > max(RN(RN(upper a) c), 0)  =>  t >= upper: t < upper fails.
//        t = RN(Ts |inv|) >= upper whenever Ts |inv| >= upper, as upper
//        is a float and RN is monotone.  inv = +-inf gives t = +inf.
//        upper <= 0: Ts > 0, so t >= 0 >= upper.  upper > 0: with F =
//        RN(upper a) and G = RN(F c), either F >= 2^-138, and then G >=
//        upper a (1 + 2^-13), so Ts |inv| > upper (1 + 2^-13)(1 - 2^-22);
//        or F < 2^-138, where Ts > G >= F puts Ts at least one subnormal
//        step 2^-149 above F >= upper a - 2^-150, and Ts |inv| >= (upper
//        a + 2^-150)(1 - 2^-22) / a > upper.  upper = +inf makes G = +inf
//        (no rule); a NaN upper fails the full test anyway.
// A NaN or infinite ray reaches every rule only through NaN or infinite
// U, V, T, det: a NaN comparison is false (no rule fires), and an
// infinite value is covered above.  tests/test_torch_tri_pretest.py holds
// the same predicate (ops/traverse.py tri_pretest_plain) against the full
// test on adversarial float32 inputs.

#pragma once

namespace tri_test {

constexpr float kTiny = 0x1p-60f;           // R1, R2, R4
constexpr float kSlack = 1.0f + 0x1p-10f;   // R3, R5

// x with its sign flipped where s's sign bit is set
__device__ __forceinline__ float flip_sign(float x, float s) {
  return __int_as_float(__float_as_int(x) ^
                        (__float_as_int(s) & static_cast<int>(0x80000000u)));
}

// One ray against the triangle row (r0, r1, r2).  Returns the full test's
// verdict and, on a hit, writes t, u, v and backface.  ``tmn_nonneg`` is
// t_min >= 0 for this ray.
__device__ __forceinline__ bool hit(
    const float4 r0, const float4 r1, const float4 r2, float ox, float oy,
    float oz, float dx, float dy, float dz, float tmn, bool tmn_nonneg,
    float upper, float& t_out, float& u_out, float& v_out, bool& bf_out) {
  const float p0x = r0.x, p0y = r0.y, p0z = r0.z;
  const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
  const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  const float U = tvx * pvx + tvy * pvy + tvz * pvz;
  const float a = fabsf(det);
  const float tiny = a * kTiny;
  const float Us = flip_sign(U, det);
  if (Us < -tiny) return false;                               // R1
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float V = dx * qvx + dy * qvy + dz * qvz;
  const float Vs = flip_sign(V, det);
  if (Vs < -tiny || Us + Vs > a * kSlack) return false;       // R2, R3
  const float T = e2x * qvx + e2y * qvy + e2z * qvz;
  const float Ts = flip_sign(T, det);
  if ((tmn_nonneg && Ts < -tiny) ||                           // R4
      Ts > fmaxf(upper * a * kSlack, 0.0f)) {                 // R5
    return false;
  }
  // the full test, in _brute_kernel's order
  const bool valid_det = det != 0.0f;
  const float inv_det = 1.0f / (valid_det ? det : 1.0f);
  const float u = U * inv_det;
  const float v = V * inv_det;
  const float t = T * inv_det;
  if (valid_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmn &&
      t < upper) {
    t_out = t;
    u_out = u;
    v_out = v;
    bf_out = det < 0.0f;
    return true;
  }
  return false;
}

}  // namespace tri_test
