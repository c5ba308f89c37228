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
//   * a round picks the lexicographic-min (t_enter, sid) over the subtree
//     boxes s that are hit (the slab test: safe_inv directions, min/max
//     that propagate NaN, _aabb_c's operand order, the exit capped by
//     t_best before the 1.00000024f slack), lie after the frontier (tn >
//     f_t, or tn == f_t and s > f_sid) and beat the best so far (tn < bt,
//     or tn == bt and s < bs; the best starts at 3.4e38f, INT32_MAX) — the
//     scan of _next_subtree, whose answer is unique;
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
// The pick: a search of the subtree tree (scene/binned.py subtree_tree), a
// binary tree over sid ranges (split by surface area) in depth-first
// preorder whose leaves are the S subtree boxes bit for bit and whose inner
// boxes hold their members' boxes.  The slab test's arithmetic is monotone
// in the box, so a member that is hit means its node is hit, with
// tn(node) <= tn(member) and tf(node) >= tf(member) — whenever the node's
// test is not NaN, which holds for every ray that is not itself NaN unless
// a direction is infinite or the origin is (nan_misses below).  A search,
// nearer child first, collects the kList lexicographically smallest
// candidates (t_enter, sid) after the frontier, pruning a node only when
// (i) it is missed, (ii) once the list is full, tn > the last entry's, or
// equal with a smallest sid past it (the list is then marked spilled), or
// (iii) tf * slack < f_t: no pruned node holds a candidate the list would
// take.  Leaves are tested with the scan's own test and compares.  A round
// takes the list's first entry that the scan's test still passes under the
// current t_best; it is the scan's answer, because t_best only falls (a
// box hit under a smaller cap is hit under a larger one) and the frontier
// only advances, so every candidate of the round was a candidate of the
// search, and the list holds the smallest of those.  A new search, from
// the last entry taken, runs only when the list is spent and spilled.
// The sort key searches the same tree for its one smallest candidate with
// its own arithmetic (below), which is monotone in the same way.
//
// Slabs: the kernel reads the row-major copy of the slabs
// (ops/traverse.py binned_rows): a 64-byte record a node entry (child
// boxes lo0 hi0 lo1 hi1, then the two child codes as int bits) and a
// 48-byte record a triangle entry (p0 p1 p2, then the global prim), each
// read as 16-byte loads; entry idx of subtree s is record s * 512 + idx.
//
// Sort key (trace_flat_binned's pre-pass, binned_sort_key_plain): each
// ray's first subtree in trace_flat_binned's own arithmetic (the entry is
// the max over the axes of the slab minima, the exit the max of the maxima
// times the slack, then capped by t_max; the first box with the smallest
// entry below 3.4e38f wins), S when none is hit or the lane is inactive.
// It decides only the order of the rays, never a result.
//
// Bound (chip_smoke.py launch_bound).  Operations: 13 float ops per
// subtree walked (its box), 26 per node step, 46 per triangle test,
// counted from the plain version's walk at each launch's own inputs.
// Bytes: every lane reads t_max and active (5 B) and writes t, u, v, prim,
// backface (17 B); an active lane also reads ro, rd, t_min (28 B); the
// slabs are read once.  The sort key: 5 B a lane, 32 B more an active
// lane, the boxes once.
//
// Design: one thread runs one ray from start to finish; a block's warps
// take rays 32 at a time from a global counter (persistent warps: the grid
// fills the card once, and a warp whose rays end early takes more).  The
// subtree tree (32 B a node, 2S - 1 nodes: 30 KB at S = 469) is staged in
// shared memory once per block; the search stack holds PICK_STACK entries
// and the candidate list kList, in registers.  A slab walk runs node steps
// in an inner loop until the ray holds a leaf (while-while), so a warp's
// lanes step through node records together.  Min and max of the box tests
// are the hardware's NaN-propagating max.NaN / min.NaN: they agree with
// jnp.maximum / jnp.minimum except for the sign of a zero, which only ever
// meets comparisons.  The slab records are read through the read-only path
// (__ldg); the copy of a scene of S = 469 takes 27 MB, which the 50 MB L2
// holds.  The walk's stack is a per-thread int[64] indexed below
// stack_size.  The sort key runs one thread a ray and reads the tree
// through the read-only path: most rays test only its root.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 64 threads a block: at the 6 blocks an SM that the staged tree allows,
// fewer warps share an SM and a long ray's warp ends sooner (measured with
// tools/kernel_variants.py against 128)
constexpr int kThreads = 64;
constexpr int kMaxSub = 512;                 // ray_tpu's binned limit
constexpr int kMaxTree = 2 * kMaxSub - 1;    // nodes of the subtree tree
constexpr int kPickStack = 16;               // scene/binned.py PICK_STACK
constexpr int kList = 8;                     // candidates a search keeps
constexpr int kMaxStack = 64;                // MAX_STACK_SIZE
constexpr int kMaxLeaf = 15;                 // LEAF_COUNT_MASK
constexpr int kRows = 512;                   // entries of a slab (SUB_ROWS)
constexpr int32_t kEmpty = INT32_MIN;
constexpr float kSlack = 1.00000024f;

// jnp.float32(3.4e38): "no subtree yet" in the pick and the sort key
__device__ __forceinline__ float big() { return __int_as_float(0x7f7fc99e); }

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

struct Ray {
  float ox, oy, oz, ix, iy, iz, t_min;
  // a node's NaN test means every member misses (see the header)
  bool nan_misses;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float ix, float iy, float iz,
                                        float t_min) {
  const bool nan_ray = isnan(ox) || isnan(oy) || isnan(oz) || isnan(ix) ||
                       isnan(iy) || isnan(iz);
  const bool tame = ix != 0.0f && iy != 0.0f && iz != 0.0f && isfinite(ox) &&
                    isfinite(oy) && isfinite(oz);
  return Ray{ox, oy, oz, ix, iy, iz, t_min, nan_ray || tame};
}

// _aabb_c / aabb_t: writes the entry tn and the slacked exit tf * 1.00000024f
__device__ __forceinline__ void slab_test(
    float lox, float loy, float loz, float hix, float hiy, float hiz,
    const Ray& r, float t_cap, float& tn, float& tfs) {
  const float tx0 = (lox - r.ox) * r.ix;
  const float tx1 = (hix - r.ox) * r.ix;
  const float ty0 = (loy - r.oy) * r.iy;
  const float ty1 = (hiy - r.oy) * r.iy;
  const float tz0 = (loz - r.oz) * r.iz;
  const float tz1 = (hiz - r.oz) * r.iz;
  tn = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
               max_nan(min_nan(tz0, tz1), r.t_min));
  const float tf = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                           min_nan(max_nan(tz0, tz1), t_cap));
  tfs = tf * kSlack;
}

// the sort key's test (trace_flat_binned's pre-pass): the entry max(max of
// the slab minima, t_min), the exit min(max of the slab maxima * slack, t_max)
__device__ __forceinline__ void key_test(
    float lox, float loy, float loz, float hix, float hiy, float hiz,
    const Ray& r, float t_max, float& tn, float& tf) {
  const float x0 = (lox - r.ox) * r.ix, x1 = (hix - r.ox) * r.ix;
  const float y0 = (loy - r.oy) * r.iy, y1 = (hiy - r.oy) * r.iy;
  const float z0 = (loz - r.oz) * r.iz, z1 = (hiz - r.oz) * r.iz;
  const float lo_max = max_nan(max_nan(min_nan(x0, x1), min_nan(y0, y1)),
                               min_nan(z0, z1));
  const float hi_max = max_nan(max_nan(max_nan(x0, x1), max_nan(y0, y1)),
                               max_nan(z0, z1));
  tn = max_nan(lo_max, r.t_min);
  tf = min_nan(hi_max * kSlack, t_max);
}

// One tree node's entry and the exit its hit test compares with.
template <bool kKey>
__device__ __forceinline__ void node_test(const float4* tree, int k,
                                          const Ray& r, float cap, float& tn,
                                          float& tx) {
  const float4 p = tree[2 * k], q = tree[2 * k + 1];
  if (kKey) {
    key_test(p.x, p.y, p.z, p.w, q.x, q.y, r, cap, tn, tx);
  } else {
    slab_test(p.x, p.y, p.z, p.w, q.x, q.y, r, cap, tn, tx);
  }
}

// Candidates of a search in (t_enter, key) order, key = leaf node | sid <<
// 10 (so keys order as sids), (inf, INT32_MAX) marking empty slots: the K
// lexicographically smallest, and whether one beyond them may exist.
template <int K>
struct Cands {
  float t[K];
  int c[K];
  int n;
  bool spilled;
};

__device__ __forceinline__ bool lex_less(float t1, int c1, float t2, int c2) {
  return t1 < t2 || (t1 == t2 && c1 < c2);
}

// Insert (t, c) keeping the K smallest, sorted; a full list drops its last.
template <int K>
__device__ __forceinline__ void insert(Cands<K>& L, float t, int c) {
  if (L.n == K) L.spilled = true;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const int p = j > 0 ? j - 1 : 0;
    const bool before_prev = j > 0 && lex_less(t, c, L.t[p], L.c[p]);
    const bool before_here = lex_less(t, c, L.t[j], L.c[j]);
    L.t[j] = before_prev ? L.t[p] : (before_here ? t : L.t[j]);
    L.c[j] = before_prev ? L.c[p] : (before_here ? c : L.c[j]);
  }
  L.n = L.n < K ? L.n + 1 : K;
}

// The search: a depth-first walk of the subtree tree (the header), nearer
// child first, that collects into L the K lexicographically smallest
// candidates (t_enter, sid) of the S boxes.  The trace (kKey false):
// candidates are hit (tn <= tf * slack, the exit capped by cap = t_best),
// after the frontier (f_t, f_sid) and no worse than the scan's start
// (3.4e38f, INT32_MAX).  The sort key (kKey true): candidates are hit (tn
// <= tf, the exit capped by cap = t_max) with tn < 3.4e38f.  A node is
// pruned when missed, when wholly before the frontier (trace), when its
// entry is at or past 3.4e38f (key), or when it cannot beat the list's last
// entry once the list is full (which marks the list spilled).
template <bool kKey, int K>
__device__ void collect(const float4* tree, int n_sub, const Ray& r,
                        float cap, float f_t, int f_sid, Cands<K>& L) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    L.t[j] = __int_as_float(0x7f800000);
    L.c[j] = INT32_MAX;
  }
  L.n = 0;
  L.spilled = false;
  // whether an inner node over [a, b) with entry tn and exit tx may hold a
  // candidate that the list would take
  auto admit = [&](int a, float tn, float tx) {
    const bool miss = !(tn <= tx) && (r.nan_misses || (tn == tn && tx == tx));
    const bool passed = kKey ? tn >= big() : tx < f_t;
    const bool full = L.n == K;
    const bool beaten =
        full ? (tn > L.t[K - 1] || (tn == L.t[K - 1] && (a << 10) > L.c[K - 1]))
             : tn > big();
    if (beaten && full && !(miss || passed)) L.spilled = true;
    return !(miss || passed || beaten);
  };
  // a leaf (one sid): the scan's own test and compares
  auto offer = [&](int k, int s, float tn, float tx) {
    const bool cand = kKey ? (tn <= tx && tn < big())
                           : (tn <= tx && tn <= big() &&
                              (tn > f_t || (tn == f_t && s > f_sid)));
    if (cand) insert<K>(L, tn, k | (s << 10));
  };
  // (node, a, b) packed as node | a << 10 | b << 20 (node < 1023, b <= 512)
  int st_code[kPickStack];
  float st_tn[kPickStack];
  int sp = 0;
  int node = 0, a = 0, b = n_sub;
  {
    float tn, tx;
    node_test<kKey>(tree, 0, r, cap, tn, tx);
    if (!admit(0, tn, tx)) return;
  }
  while (true) {
    const int m = __float_as_int(tree[2 * node + 1].z);  // the split
    const int kl = node + 1, kr = node + 2 * (m - a);
    float tl, xl, tr, xr;
    node_test<kKey>(tree, kl, r, cap, tl, xl);
    node_test<kKey>(tree, kr, r, cap, tr, xr);
    const bool leafl = m - a == 1, leafr = b - m == 1;
    if (leafl) offer(kl, a, tl, xl);
    if (leafr) offer(kr, m, tr, xr);
    const bool ol = !leafl && admit(a, tl, xl);
    const bool orr = !leafr && admit(m, tr, xr);
    if (ol && orr) {
      // nearer first; a tie goes to the smaller sids
      const bool right = tr < tl;
      st_code[sp] = right ? (kl | (a << 10) | (m << 20))
                          : (kr | (m << 10) | (b << 20));
      st_tn[sp++] = right ? tl : tr;
      node = right ? kr : kl;
      a = right ? m : a;
      b = right ? b : m;
      continue;
    }
    if (ol || orr) {
      node = ol ? kl : kr;
      a = ol ? a : m;
      b = ol ? m : b;
      continue;
    }
    // pop the next node that the list, if full, has not beaten since
    bool found = false;
    while (sp > 0) {
      --sp;
      const int c = st_code[sp];
      const int ca = (c >> 10) & 1023;
      const float t = st_tn[sp];
      if (L.n == K &&
          (t > L.t[K - 1] || (t == L.t[K - 1] && (ca << 10) > L.c[K - 1]))) {
        L.spilled = true;
        continue;
      }
      node = c & 1023;
      a = ca;
      b = c >> 20;
      found = true;
      break;
    }
    if (!found) break;
  }
}

__device__ __forceinline__ void stage_tree(const float4* __restrict__ tree,
                                           int n_sub, float4* s_tree) {
  for (int i = threadIdx.x; i < 2 * (2 * n_sub - 1); i += blockDim.x) {
    s_tree[i] = tree[i];
  }
  __syncthreads();
}

template <bool kAnyHit>
__device__ __forceinline__ void trace_ray(
    int64_t r, const float4* __restrict__ node_rows,
    const float4* __restrict__ tri_rows, const float4* s_tree, int n_sub,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const bool* __restrict__ active, float* __restrict__ out_t,
    int32_t* __restrict__ out_prim, float* __restrict__ out_u,
    float* __restrict__ out_v, bool* __restrict__ out_bf, int max_leaf,
    int stack_size) {
  const float tmx = t_max[r];
  float t_best = tmx;
  int32_t prim = -1;
  float u_b = 0.0f, v_b = 0.0f;
  bool bf = false;

  if (active[r]) {
    const float ox = ro[3 * r], oy = ro[3 * r + 1], oz = ro[3 * r + 2];
    const float dx = rd[3 * r], dy = rd[3 * r + 1], dz = rd[3 * r + 2];
    const float tmn = t_min[r];
    const Ray ray = make_ray(ox, oy, oz, safe_inv(dx), safe_inv(dy),
                             safe_inv(dz), tmn);
    // the search frontier: the last candidate taken from the list
    float f_t = -big();
    int f_sid = -1;
    Cands<kList> L;
    L.n = 0;
    L.spilled = true;  // nothing searched yet
    int32_t stack[kMaxStack];
    while (!(kAnyHit && prim >= 0)) {
      // ---- the next subtree: lexicographic-min (t_enter, sid) ----
      // the first candidate of the list still hit under the current
      // t_best; a new search when the list is spent and may have dropped
      // candidates (see the header)
      int bs = -1;
      while (true) {
        if (L.n == 0) {
          if (!L.spilled) break;
          collect<false, kList>(s_tree, n_sub, ray, t_best, f_t, f_sid, L);
          if (L.n == 0) break;
        }
        const float t0 = L.t[0];
        const int c0 = L.c[0];
#pragma unroll
        for (int j = 0; j + 1 < kList; ++j) {
          L.t[j] = L.t[j + 1];
          L.c[j] = L.c[j + 1];
        }
        L.t[kList - 1] = __int_as_float(0x7f800000);
        L.c[kList - 1] = INT32_MAX;
        --L.n;
        f_t = t0;
        f_sid = c0 >> 10;
        float tn, tfs;
        node_test<false>(s_tree, c0 & 1023, ray, t_best, tn, tfs);
        if (tn <= tfs) {
          bs = f_sid;
          break;
        }
      }
      if (bs < 0) break;

      // ---- walk its slab from the root: node steps together, then a leaf
      const float4* N = node_rows + static_cast<int64_t>(bs) * kRows * 4;
      const float4* T = tri_rows + static_cast<int64_t>(bs) * kRows * 3;
      int sp = 0;
      int32_t cur = 0;
      while (true) {
        while (cur >= 0) {
          const float4 q0 = __ldg(N + 4 * cur), q1 = __ldg(N + 4 * cur + 1);
          const float4 q2 = __ldg(N + 4 * cur + 2), q3 = __ldg(N + 4 * cur + 3);
          float t0, t1, f0, f1;
          slab_test(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ray, t_best, t0, f0);
          slab_test(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, ray, t_best, t1, f1);
          const bool h0 = t0 <= f0, h1 = t1 <= f1;
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
        const int32_t leaf = -cur - 1;
        const int first = leaf >> 4;
        const int count = leaf & 15;
        for (int k = 0; k < max_leaf && k < count; ++k) {
          const float4* w = T + 3 * (first + k);
          const float4 w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
          const float p0x = w0.x, p0y = w0.y, p0z = w0.z;
          const float e1x = w0.w - p0x;
          const float e1y = w1.x - p0y;
          const float e1z = w1.y - p0z;
          const float e2x = w1.z - p0x;
          const float e2y = w1.w - p0y;
          const float e2z = w2.x - p0z;
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
            prim = __float_as_int(w2.y);
            u_b = u;
            v_b = v;
            bf = det < 0.0f;
          }
        }
        int32_t next = kEmpty;
        if (kAnyHit && prim >= 0) sp = 0;
        while (next == kEmpty && sp > 0) {
          const int top = sp - 1;
          next = top < stack_size ? stack[top] : kEmpty;
          sp = top;
        }
        cur = next;
      }
    }
  }
  out_t[r] = t_best;
  out_prim[r] = prim;
  out_u[r] = u_b;
  out_v[r] = v_b;
  out_bf[r] = bf;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) trace_binned_kernel(
    const float4* __restrict__ node_rows,  // (S * 512, 16) as float4
    const float4* __restrict__ tri_rows,   // (S * 512, 12) as float4
    const float4* __restrict__ tree,       // (2S - 1, 8) as float4
    int n_sub,
    const float* __restrict__ ro,          // (R, 3)
    const float* __restrict__ rd,          // (R, 3)
    const float* __restrict__ t_min,
    const float* __restrict__ t_max,
    const bool* __restrict__ active,
    int n_rays,
    float* __restrict__ out_t,
    int32_t* __restrict__ out_prim,
    float* __restrict__ out_u,
    float* __restrict__ out_v,
    bool* __restrict__ out_bf,
    int max_leaf,
    int stack_size,
    int* __restrict__ counter) {
  __shared__ float4 s_tree[2 * kMaxTree];
  stage_tree(tree, n_sub, s_tree);

  const int lane = threadIdx.x & 31;
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n_rays) break;
    const int r = base + lane;
    if (r < n_rays) {
      trace_ray<kAnyHit>(r, node_rows, tri_rows, s_tree, n_sub, ro, rd,
                         t_min, t_max, active, out_t, out_prim, out_u, out_v,
                         out_bf, max_leaf, stack_size);
    }
  }
}

__global__ void __launch_bounds__(kThreads) binned_sort_key_kernel(
    const float4* __restrict__ tree, int n_sub, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ t_min,
    const float* __restrict__ t_max, const bool* __restrict__ active,
    int n_rays, int32_t* __restrict__ key) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  int best_s = n_sub;
  if (active[r]) {
    const Ray ray = make_ray(ro[3 * r], ro[3 * r + 1], ro[3 * r + 2],
                             safe_inv(rd[3 * r]), safe_inv(rd[3 * r + 1]),
                             safe_inv(rd[3 * r + 2]), t_min[r]);
    Cands<1> L;
    collect<true, 1>(tree, n_sub, ray, __ldg(t_max + r), 0.0f, 0, L);
    if (L.n) best_s = L.c[0] >> 10;
  }
  key[r] = best_s;
}

bool bad_launch(int n_sub, int64_t n_rays) {
  // the ray counter and the ray index are 32-bit
  return n_sub < 2 || n_sub > kMaxSub || n_rays <= 0 || n_rays >= (1 << 30);
}

int persistent_blocks(const void* kernel, int64_t n_rays, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t need = (n_rays + kThreads - 1) / kThreads;
  const int64_t fill = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(need < fill ? need : fill);
  return 0;
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on ``stream`` and returns
// the launch's cudaGetLastError() (0 on success); never synchronises.
// ``counter``: one int32 that is 0 at the launch (the wrapper zeroes it).
extern "C" int trace_binned_launch(
    const void* node_rows, const void* tri_rows, const void* tree, int n_sub,
    const void* ro, const void* rd, const void* t_min, const void* t_max,
    const void* active, int64_t n_rays, void* out_t, void* out_prim,
    void* out_u, void* out_v, void* out_bf, int max_leaf, int stack_size,
    void* counter, int any_hit, void* stream) {
  if (bad_launch(n_sub, n_rays) || max_leaf < 1 || max_leaf > kMaxLeaf ||
      stack_size < 1 || stack_size > kMaxStack || counter == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = any_hit
      ? reinterpret_cast<const void*>(&trace_binned_kernel<true>)
      : reinterpret_cast<const void*>(&trace_binned_kernel<false>);
  int blocks = 0;
  const int err = persistent_blocks(kernel, n_rays, &blocks);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* nr = static_cast<const float4*>(node_rows);
  const float4* tr = static_cast<const float4*>(tri_rows);
  const float4* tt = static_cast<const float4*>(tree);
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
  int* c = static_cast<int*>(counter);
  const int R = static_cast<int>(n_rays);
  if (any_hit) {
    trace_binned_kernel<true><<<blocks, kThreads, 0, s>>>(
        nr, tr, tt, n_sub, o, d, tn, tx, a, R, ot, op, ou, ov, ob, max_leaf,
        stack_size, c);
  } else {
    trace_binned_kernel<false><<<blocks, kThreads, 0, s>>>(
        nr, tr, tt, n_sub, o, d, tn, tx, a, R, ot, op, ou, ov, ob, max_leaf,
        stack_size, c);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int binned_sort_key_launch(
    const void* tree, int n_sub, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* active, int64_t n_rays,
    void* key, void* stream) {
  if (bad_launch(n_sub, n_rays)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n_rays + kThreads - 1) / kThreads);
  binned_sort_key_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tree), n_sub, static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const float*>(t_min),
      static_cast<const float*>(t_max), static_cast<const bool*>(active),
      static_cast<int>(n_rays), static_cast<int32_t*>(key));
  return static_cast<int>(cudaGetLastError());
}
