// Native binned-SAH BVH2 and SBVH builders.
//
// A copy of ray_tpu/scene/native/bvh_builder.cpp (the code is unchanged;
// only this header differs), so that ray_tpu_torch builds the same nodes
// as ray_tpu for scenes of NATIVE_BUILDER_THRESHOLD primitives and more.
// BVH construction is irregular, pointer-chasing work that numpy does
// poorly at scale.  This builder emits the array layouts of the numpy
// builder in ../bvh.py (child-bounds-in-parent slots, packed leaf codes);
// scene/native/__init__.py compiles it on first use with g++, raises with
// g++'s message when that fails, and binds both ray_tpu_build_bvh2 and the
// SBVH entry point ray_tpu_build_sbvh.
//
// Build: g++ -O3 -march=native -shared -fPIC bvh_builder.cpp -o libbvh.so

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumBins = 16;
constexpr int kLeafCountBits = 4;  // must match scene/bvh.py LEAF_COUNT_BITS

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float axis_of(const Vec3 &v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}
inline float half_area(const Vec3 &lo, const Vec3 &hi) {
  const float ex = std::max(hi.x - lo.x, 0.f);
  const float ey = std::max(hi.y - lo.y, 0.f);
  const float ez = std::max(hi.z - lo.z, 0.f);
  return ex * ey + ey * ez + ez * ex;
}

struct Builder {
  const Vec3 *lo;
  const Vec3 *hi;
  std::vector<Vec3> centroid;
  std::vector<int32_t> order;
  int max_leaf;
  // stop splitting once a node fits max_leaf prims (TPU per-visit leaf cost
  // model — a wide-BVH leaf visit costs one gather regardless of count)
  bool fat_leaves;

  // output slots
  std::vector<float> child_lo;   // n_slots * 2 * 3
  std::vector<float> child_hi;
  std::vector<int32_t> child;    // n_slots * 2
  std::vector<int32_t> counts;   // n_slots * 2

  int make_slot() {
    const int s = static_cast<int>(child.size() / 2);
    child_lo.resize(child_lo.size() + 6, 0.f);
    child_hi.resize(child_hi.size() + 6, 0.f);
    child.resize(child.size() + 2, 0);
    counts.resize(counts.size() + 2, 0);
    return s;
  }

  void subset_bounds(int start, int end, Vec3 &blo, Vec3 &bhi) const {
    blo = {FLT_MAX, FLT_MAX, FLT_MAX};
    bhi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = start; i < end; ++i) {
      blo = vmin(blo, lo[order[i]]);
      bhi = vmax(bhi, hi[order[i]]);
    }
  }

  static int32_t leaf_code(int first, int count) {
    return -(((first << kLeafCountBits) | count) + 1);
  }

  // Returns split mid, or -1 for "make a leaf".
  int split(int start, int end) {
    const int count = end - start;
    Vec3 clo = {FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 chi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = start; i < end; ++i) {
      clo = vmin(clo, centroid[order[i]]);
      chi = vmax(chi, centroid[order[i]]);
    }

    Vec3 plo, phi;
    subset_bounds(start, end, plo, phi);
    const float parent_area = std::max(2.f * half_area(plo, phi), 1e-30f);
    const float leaf_cost = static_cast<float>(count);

    float best_cost = FLT_MAX;
    int best_axis = -1, best_bin = -1;
    float best_lo_a = 0.f, best_scale = 0.f;

    for (int axis = 0; axis < 3; ++axis) {
      const float ext = axis_of(chi, axis) - axis_of(clo, axis);
      if (ext < 1e-12f) continue;
      const float scale = kNumBins * (1.f - 1e-6f) / ext;
      const float lo_a = axis_of(clo, axis);

      int bcount[kNumBins] = {};
      Vec3 blo[kNumBins], bhi[kNumBins];
      for (int b = 0; b < kNumBins; ++b) {
        blo[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
        bhi[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      }
      for (int i = start; i < end; ++i) {
        const int p = order[i];
        int b = static_cast<int>((axis_of(centroid[p], axis) - lo_a) * scale);
        b = std::min(b, kNumBins - 1);
        ++bcount[b];
        blo[b] = vmin(blo[b], lo[p]);
        bhi[b] = vmax(bhi[b], hi[p]);
      }

      // sweep
      int lcount[kNumBins - 1];
      float larea[kNumBins - 1];
      {
        int c = 0;
        Vec3 alo = {FLT_MAX, FLT_MAX, FLT_MAX};
        Vec3 ahi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        for (int b = 0; b < kNumBins - 1; ++b) {
          c += bcount[b];
          alo = vmin(alo, blo[b]);
          ahi = vmax(ahi, bhi[b]);
          lcount[b] = c;
          larea[b] = c > 0 ? 2.f * half_area(alo, ahi) : 0.f;
        }
      }
      {
        int c = 0;
        Vec3 alo = {FLT_MAX, FLT_MAX, FLT_MAX};
        Vec3 ahi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        for (int b = kNumBins - 1; b >= 1; --b) {
          c += bcount[b];
          alo = vmin(alo, blo[b]);
          ahi = vmax(ahi, bhi[b]);
          const int rcount = c;
          const float rarea = c > 0 ? 2.f * half_area(alo, ahi) : 0.f;
          const int k = b - 1;
          if (lcount[k] > 0 && rcount > 0) {
            const float cost =
                1.f + (larea[k] * lcount[k] + rarea * rcount) / parent_area;
            if (cost < best_cost) {
              best_cost = cost;
              best_axis = axis;
              best_bin = k;
              best_lo_a = lo_a;
              best_scale = scale;
            }
          }
        }
      }
    }

    if (best_axis >= 0 &&
        (count > max_leaf || (!fat_leaves && best_cost < leaf_cost))) {
      auto pred = [&](int32_t p) {
        int b = static_cast<int>(
            (axis_of(centroid[p], best_axis) - best_lo_a) * best_scale);
        b = std::min(b, kNumBins - 1);
        return b <= best_bin;
      };
      int32_t *first = order.data() + start;
      int32_t *last = order.data() + end;
      int32_t *mid = std::partition(first, last, pred);
      const int nleft = static_cast<int>(mid - first);
      if (nleft > 0 && nleft < count) return start + nleft;
    }

    if (count <= max_leaf) return -1;
    // median fallback
    const int axis =
        (axis_of(chi, 0) - axis_of(clo, 0) > axis_of(chi, 1) - axis_of(clo, 1))
            ? ((axis_of(chi, 0) - axis_of(clo, 0) >
                axis_of(chi, 2) - axis_of(clo, 2))
                   ? 0
                   : 2)
            : ((axis_of(chi, 1) - axis_of(clo, 1) >
                axis_of(chi, 2) - axis_of(clo, 2))
                   ? 1
                   : 2);
    std::nth_element(order.begin() + start, order.begin() + start + count / 2,
                     order.begin() + end, [&](int32_t a, int32_t b) {
                       return axis_of(centroid[a], axis) <
                              axis_of(centroid[b], axis);
                     });
    return start + count / 2;
  }

  void build(int n) {
    struct Item {
      int slot, side, start, end;
    };
    std::vector<Item> stack;
    make_slot();
    const int mid = split(0, n);
    if (mid < 0) {
      Vec3 blo, bhi;
      subset_bounds(0, n, blo, bhi);
      std::memcpy(&child_lo[0], &blo, 12);
      std::memcpy(&child_hi[0], &bhi, 12);
      child[0] = leaf_code(0, n);
      counts[0] = n;
      const Vec3 inf = {FLT_MAX, FLT_MAX, FLT_MAX};
      const Vec3 ninf = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      std::memcpy(&child_lo[3], &inf, 12);
      std::memcpy(&child_hi[3], &ninf, 12);
      child[1] = leaf_code(0, 0);
      counts[1] = 0;
      return;
    }
    stack.push_back({0, 0, 0, mid});
    stack.push_back({0, 1, mid, n});

    while (!stack.empty()) {
      const Item it = stack.back();
      stack.pop_back();
      Vec3 blo, bhi;
      subset_bounds(it.start, it.end, blo, bhi);
      std::memcpy(&child_lo[(it.slot * 2 + it.side) * 3], &blo, 12);
      std::memcpy(&child_hi[(it.slot * 2 + it.side) * 3], &bhi, 12);
      const int m = split(it.start, it.end);
      if (m < 0) {
        child[it.slot * 2 + it.side] = leaf_code(it.start, it.end - it.start);
        counts[it.slot * 2 + it.side] = it.end - it.start;
      } else {
        const int s = make_slot();
        child[it.slot * 2 + it.side] = s;
        stack.push_back({s, 0, it.start, m});
        stack.push_back({s, 1, m, it.end});
      }
    }
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// SBVH builder with spatial reference splits (the reference's
// internal/BVHSplit.cpp SplitPrimitives_SAH clip_axis path).  Mirrors the
// numpy _build_sbvh in ../bvh.py: binned object SAH, plus — when the object
// split's children overlap more than kSpatialAlpha of the root area — a
// spatial-split candidate binned with EXACT triangle-slab clipping;
// straddling references are clipped into both children.  Same output
// layout; prim_indices may contain duplicates.
// ---------------------------------------------------------------------------

namespace {

constexpr float kSpatialAlpha = 1e-5f;

inline Vec3 lerp3(const Vec3 &a, const Vec3 &b, float t) {
  return {a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
          a.z + (b.z - a.z) * t};
}

// Sutherland–Hodgman clip of a convex polygon against one axis halfspace.
inline int clip_poly(const Vec3 *in, int n_in, int axis, float plane,
                     bool below, Vec3 *out) {
  int n_out = 0;
  for (int i = 0; i < n_in; ++i) {
    const Vec3 &a = in[i];
    const Vec3 &b = in[(i + 1) % n_in];
    float da = axis_of(a, axis) - plane;
    float db = axis_of(b, axis) - plane;
    if (!below) {
      da = -da;
      db = -db;
    }
    const bool ina = da <= 0.f, inb = db <= 0.f;
    if (ina) {
      out[n_out++] = a;
      if (!inb) out[n_out++] = lerp3(a, b, da / (da - db));
    } else if (inb) {
      out[n_out++] = lerp3(a, b, da / (da - db));
    }
  }
  return n_out;
}

// AABB of a triangle clipped to the axis slab [a, b]; false if empty.
inline bool tri_slab_aabb(const float *tri9, int axis, float a, float b,
                          Vec3 &olo, Vec3 &ohi) {
  Vec3 buf0[8], buf1[8];
  buf0[0] = {tri9[0], tri9[1], tri9[2]};
  buf0[1] = {tri9[3], tri9[4], tri9[5]};
  buf0[2] = {tri9[6], tri9[7], tri9[8]};
  int n = 3;
  if (b < FLT_MAX) n = clip_poly(buf0, n, axis, b, true, buf1);
  else std::memcpy(buf1, buf0, sizeof(Vec3) * 3);
  if (n == 0) return false;
  if (a > -FLT_MAX) n = clip_poly(buf1, n, axis, a, false, buf0);
  else std::memcpy(buf0, buf1, sizeof(Vec3) * n);
  if (n == 0) return false;
  olo = {FLT_MAX, FLT_MAX, FLT_MAX};
  ohi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i = 0; i < n; ++i) {
    olo = vmin(olo, buf0[i]);
    ohi = vmax(ohi, buf0[i]);
  }
  return true;
}

struct Ref {
  int32_t id;
  Vec3 lo, hi;
};

struct SBuilder {
  const float *verts;  // n * 9, nullable (AABB-clip fallback)
  int max_leaf;
  bool fat_leaves;
  float root_area;
  int max_refs;
  int total_refs;

  std::vector<float> child_lo, child_hi;
  std::vector<int32_t> child, counts;
  std::vector<int32_t> ref_out;

  int make_slot() {
    const int s = static_cast<int>(child.size() / 2);
    child_lo.resize(child_lo.size() + 6, 0.f);
    child_hi.resize(child_hi.size() + 6, 0.f);
    child.resize(child.size() + 2, 0);
    counts.resize(counts.size() + 2, 0);
    return s;
  }

  static int32_t leaf_code(int first, int count) {
    return -(((first << kLeafCountBits) | count) + 1);
  }

  int32_t emit_leaf(const std::vector<Ref> &refs) {
    const int first = static_cast<int>(ref_out.size());
    for (const Ref &r : refs) ref_out.push_back(r.id);
    return leaf_code(first, static_cast<int>(refs.size()));
  }

  // false → make a leaf; true → l/r filled.
  bool split(const std::vector<Ref> &refs, std::vector<Ref> &l,
             std::vector<Ref> &r) {
    const int count = static_cast<int>(refs.size());
    Vec3 clo = {FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 chi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    Vec3 plo = {FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 phi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (const Ref &rf : refs) {
      const Vec3 c = {0.5f * (rf.lo.x + rf.hi.x), 0.5f * (rf.lo.y + rf.hi.y),
                      0.5f * (rf.lo.z + rf.hi.z)};
      clo = vmin(clo, c);
      chi = vmax(chi, c);
      plo = vmin(plo, rf.lo);
      phi = vmax(phi, rf.hi);
    }
    const float parent_area = std::max(2.f * half_area(plo, phi), 1e-30f);
    const float leaf_cost = static_cast<float>(count);

    // ---- object split (binned SAH over ref centroids) ----
    float best_obj = FLT_MAX, best_overlap = 0.f;
    int obj_axis = -1, obj_bin = -1;
    float obj_lo_a = 0.f, obj_scale = 0.f;
    for (int axis = 0; axis < 3; ++axis) {
      const float ext = axis_of(chi, axis) - axis_of(clo, axis);
      if (ext < 1e-12f) continue;
      const float scale = kNumBins * (1.f - 1e-6f) / ext;
      const float lo_a = axis_of(clo, axis);
      int bcount[kNumBins] = {};
      Vec3 blo[kNumBins], bhi[kNumBins];
      for (int b = 0; b < kNumBins; ++b) {
        blo[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
        bhi[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      }
      for (const Ref &rf : refs) {
        const float c = 0.5f * (axis_of(rf.lo, axis) + axis_of(rf.hi, axis));
        int b = static_cast<int>((c - lo_a) * scale);
        b = std::min(std::max(b, 0), kNumBins - 1);
        ++bcount[b];
        blo[b] = vmin(blo[b], rf.lo);
        bhi[b] = vmax(bhi[b], rf.hi);
      }
      int lcount[kNumBins - 1];
      Vec3 llo[kNumBins - 1], lhi[kNumBins - 1];
      {
        int c = 0;
        Vec3 alo = {FLT_MAX, FLT_MAX, FLT_MAX};
        Vec3 ahi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        for (int b = 0; b < kNumBins - 1; ++b) {
          c += bcount[b];
          alo = vmin(alo, blo[b]);
          ahi = vmax(ahi, bhi[b]);
          lcount[b] = c;
          llo[b] = alo;
          lhi[b] = ahi;
        }
      }
      {
        int c = 0;
        Vec3 alo = {FLT_MAX, FLT_MAX, FLT_MAX};
        Vec3 ahi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        for (int b = kNumBins - 1; b >= 1; --b) {
          c += bcount[b];
          alo = vmin(alo, blo[b]);
          ahi = vmax(ahi, bhi[b]);
          const int k = b - 1;
          if (lcount[k] > 0 && c > 0) {
            const float cost =
                1.f + (2.f * half_area(llo[k], lhi[k]) * lcount[k] +
                       2.f * half_area(alo, ahi) * c) /
                          parent_area;
            if (cost < best_obj) {
              best_obj = cost;
              obj_axis = axis;
              obj_bin = k;
              obj_lo_a = lo_a;
              obj_scale = scale;
              const Vec3 ov_lo = vmax(llo[k], alo);
              const Vec3 ov_hi = vmin(lhi[k], ahi);
              best_overlap = 2.f * half_area(ov_lo, ov_hi);
            }
          }
        }
      }
    }

    // ---- spatial-split candidate (exact chopped binning) ----
    float best_sp = FLT_MAX;
    int sp_axis = -1;
    float sp_plane = 0.f;
    const bool try_spatial = obj_axis >= 0 &&
                             best_overlap / root_area > kSpatialAlpha &&
                             total_refs < max_refs && count > 1;
    if (try_spatial) {
      for (int axis = 0; axis < 3; ++axis) {
        const float p_lo = axis_of(plo, axis);
        const float width = axis_of(phi, axis) - p_lo;
        if (width < 1e-12f) continue;
        const float bw = width / kNumBins;
        int entries[kNumBins] = {}, exits[kNumBins] = {};
        Vec3 blo[kNumBins], bhi[kNumBins];
        for (int b = 0; b < kNumBins; ++b) {
          blo[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
          bhi[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        }
        for (const Ref &rf : refs) {
          int b0 = static_cast<int>((axis_of(rf.lo, axis) - p_lo) / bw);
          int b1 = static_cast<int>((axis_of(rf.hi, axis) - p_lo) / bw);
          b0 = std::min(std::max(b0, 0), kNumBins - 1);
          b1 = std::min(std::max(b1, b0), kNumBins - 1);
          ++entries[b0];
          ++exits[b1];
          if (b0 == b1) {
            blo[b0] = vmin(blo[b0], rf.lo);
            bhi[b0] = vmax(bhi[b0], rf.hi);
            continue;
          }
          for (int b = b0; b <= b1; ++b) {
            const float sa = p_lo + b * bw;
            const float sb = p_lo + (b + 1) * bw;
            Vec3 qlo, qhi;
            if (verts != nullptr) {
              if (!tri_slab_aabb(verts + rf.id * 9, axis, sa, sb, qlo, qhi))
                continue;
              qlo = vmax(qlo, rf.lo);
              qhi = vmin(qhi, rf.hi);
              if (qlo.x > qhi.x || qlo.y > qhi.y || qlo.z > qhi.z) continue;
            } else {
              qlo = rf.lo;
              qhi = rf.hi;
              if (axis == 0) { qlo.x = std::max(qlo.x, sa); qhi.x = std::min(qhi.x, sb); }
              else if (axis == 1) { qlo.y = std::max(qlo.y, sa); qhi.y = std::min(qhi.y, sb); }
              else { qlo.z = std::max(qlo.z, sa); qhi.z = std::min(qhi.z, sb); }
            }
            blo[b] = vmin(blo[b], qlo);
            bhi[b] = vmax(bhi[b], qhi);
          }
        }
        int lcount[kNumBins - 1];
        Vec3 llo[kNumBins - 1], lhi[kNumBins - 1];
        {
          int c = 0;
          Vec3 alo = {FLT_MAX, FLT_MAX, FLT_MAX};
          Vec3 ahi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
          for (int b = 0; b < kNumBins - 1; ++b) {
            c += entries[b];
            alo = vmin(alo, blo[b]);
            ahi = vmax(ahi, bhi[b]);
            lcount[b] = c;
            llo[b] = alo;
            lhi[b] = ahi;
          }
        }
        {
          int c = 0;
          Vec3 alo = {FLT_MAX, FLT_MAX, FLT_MAX};
          Vec3 ahi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
          for (int b = kNumBins - 1; b >= 1; --b) {
            c += exits[b];
            alo = vmin(alo, blo[b]);
            ahi = vmax(ahi, bhi[b]);
            const int k = b - 1;
            if (lcount[k] > 0 && c > 0) {
              const float cost =
                  1.f + (2.f * half_area(llo[k], lhi[k]) * lcount[k] +
                         2.f * half_area(alo, ahi) * c) /
                            parent_area;
              if (cost < best_sp) {
                best_sp = cost;
                sp_axis = axis;
                sp_plane = p_lo + (k + 1) * bw;
              }
            }
          }
        }
      }
    }

    const bool use_spatial = sp_axis >= 0 && best_sp < best_obj;
    const float best_cost = use_spatial
                                ? best_sp
                                : (obj_axis >= 0 ? best_obj : FLT_MAX);
    if (count <= max_leaf &&
        (fat_leaves || best_cost == FLT_MAX || best_cost >= leaf_cost))
      return false;

    l.clear();
    r.clear();
    if (use_spatial) {
      int n_str = 0;
      for (const Ref &rf : refs)
        if (axis_of(rf.lo, sp_axis) < sp_plane &&
            axis_of(rf.hi, sp_axis) > sp_plane)
          ++n_str;
      if (n_str > 0 && total_refs + n_str <= max_refs) {
        for (const Ref &rf : refs) {
          const float a = axis_of(rf.lo, sp_axis);
          const float b = axis_of(rf.hi, sp_axis);
          if (b <= sp_plane) {
            l.push_back(rf);
          } else if (a >= sp_plane) {
            r.push_back(rf);
          } else {
            Ref lr = rf, rr = rf;
            if (sp_axis == 0) { lr.hi.x = sp_plane; rr.lo.x = sp_plane; }
            else if (sp_axis == 1) { lr.hi.y = sp_plane; rr.lo.y = sp_plane; }
            else { lr.hi.z = sp_plane; rr.lo.z = sp_plane; }
            bool lok = true, rok = true;
            if (verts != nullptr) {
              Vec3 qlo, qhi;
              if (tri_slab_aabb(verts + rf.id * 9, sp_axis, -FLT_MAX,
                                sp_plane, qlo, qhi)) {
                lr.lo = vmax(lr.lo, qlo);
                lr.hi = vmin(lr.hi, qhi);
                lok = lr.lo.x <= lr.hi.x && lr.lo.y <= lr.hi.y &&
                      lr.lo.z <= lr.hi.z;
              } else {
                lok = false;
              }
              if (tri_slab_aabb(verts + rf.id * 9, sp_axis, sp_plane,
                                FLT_MAX, qlo, qhi)) {
                rr.lo = vmax(rr.lo, qlo);
                rr.hi = vmin(rr.hi, qhi);
                rok = rr.lo.x <= rr.hi.x && rr.lo.y <= rr.hi.y &&
                      rr.lo.z <= rr.hi.z;
              } else {
                rok = false;
              }
            }
            if (lok) l.push_back(lr);
            if (rok) r.push_back(rr);
          }
        }
        if (!l.empty() && !r.empty()) {
          total_refs +=
              static_cast<int>(l.size() + r.size()) - count;
          return true;
        }
        l.clear();
        r.clear();
      }
      // fall through to the object split
    }

    if (obj_axis >= 0) {
      for (const Ref &rf : refs) {
        const float c =
            0.5f * (axis_of(rf.lo, obj_axis) + axis_of(rf.hi, obj_axis));
        int b = static_cast<int>((c - obj_lo_a) * obj_scale);
        b = std::min(std::max(b, 0), kNumBins - 1);
        (b <= obj_bin ? l : r).push_back(rf);
      }
      if (!l.empty() && !r.empty()) return true;
      l.clear();
      r.clear();
    }

    if (count <= max_leaf) return false;
    // median fallback on the widest centroid axis
    const float ex = axis_of(chi, 0) - axis_of(clo, 0);
    const float ey = axis_of(chi, 1) - axis_of(clo, 1);
    const float ez = axis_of(chi, 2) - axis_of(clo, 2);
    const int axis = ex > ey ? (ex > ez ? 0 : 2) : (ey > ez ? 1 : 2);
    std::vector<Ref> sorted = refs;
    std::sort(sorted.begin(), sorted.end(), [axis](const Ref &a,
                                                   const Ref &b) {
      return axis_of(a.lo, axis) + axis_of(a.hi, axis) <
             axis_of(b.lo, axis) + axis_of(b.hi, axis);
    });
    const int mid = count / 2;
    l.assign(sorted.begin(), sorted.begin() + mid);
    r.assign(sorted.begin() + mid, sorted.end());
    return true;
  }

  void build(std::vector<Ref> &&root_refs) {
    struct Item {
      int slot, side;
      std::vector<Ref> refs;
    };
    std::vector<Item> stack;
    make_slot();
    std::vector<Ref> l, r;
    if (!split(root_refs, l, r)) {
      Vec3 blo = {FLT_MAX, FLT_MAX, FLT_MAX};
      Vec3 bhi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      for (const Ref &rf : root_refs) {
        blo = vmin(blo, rf.lo);
        bhi = vmax(bhi, rf.hi);
      }
      std::memcpy(&child_lo[0], &blo, 12);
      std::memcpy(&child_hi[0], &bhi, 12);
      child[0] = emit_leaf(root_refs);
      counts[0] = static_cast<int>(root_refs.size());
      const Vec3 inf = {FLT_MAX, FLT_MAX, FLT_MAX};
      const Vec3 ninf = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      std::memcpy(&child_lo[3], &inf, 12);
      std::memcpy(&child_hi[3], &ninf, 12);
      child[1] = leaf_code(0, 0);
      counts[1] = 0;
      return;
    }
    stack.push_back({0, 0, std::move(l)});
    stack.push_back({0, 1, std::move(r)});

    while (!stack.empty()) {
      Item it = std::move(stack.back());
      stack.pop_back();
      Vec3 blo = {FLT_MAX, FLT_MAX, FLT_MAX};
      Vec3 bhi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      for (const Ref &rf : it.refs) {
        blo = vmin(blo, rf.lo);
        bhi = vmax(bhi, rf.hi);
      }
      std::memcpy(&child_lo[(it.slot * 2 + it.side) * 3], &blo, 12);
      std::memcpy(&child_hi[(it.slot * 2 + it.side) * 3], &bhi, 12);
      std::vector<Ref> cl, cr;
      if (!split(it.refs, cl, cr)) {
        child[it.slot * 2 + it.side] = emit_leaf(it.refs);
        counts[it.slot * 2 + it.side] = static_cast<int>(it.refs.size());
      } else {
        const int s = make_slot();
        child[it.slot * 2 + it.side] = s;
        stack.push_back({s, 0, std::move(cl)});
        stack.push_back({s, 1, std::move(cr)});
      }
    }
  }
};

}  // namespace

extern "C" {

// SBVH with spatial reference splits.  tri_verts may be null (AABB-clip
// fallback).  Returns the number of node slots, or -1 if node or ref
// capacity is exceeded; *out_n_refs receives the leaf-order ref count.
int ray_tpu_build_sbvh(const float *tri_lo, const float *tri_hi,
                       const float *tri_verts, int n, int max_leaf,
                       int fat_leaves, float *out_child_lo,
                       float *out_child_hi, int32_t *out_child,
                       int32_t *out_counts, int32_t *out_prim_indices,
                       float *out_root_lo, float *out_root_hi,
                       int node_capacity, int ref_capacity,
                       int32_t *out_n_refs) {
  const Vec3 *lo = reinterpret_cast<const Vec3 *>(tri_lo);
  const Vec3 *hi = reinterpret_cast<const Vec3 *>(tri_hi);
  SBuilder b;
  b.verts = tri_verts;
  b.max_leaf = max_leaf;
  b.fat_leaves = fat_leaves != 0;
  b.max_refs = ref_capacity;
  b.total_refs = n;

  std::vector<Ref> root(n);
  Vec3 rlo = {FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 rhi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i = 0; i < n; ++i) {
    root[i] = {i, lo[i], hi[i]};
    rlo = vmin(rlo, lo[i]);
    rhi = vmax(rhi, hi[i]);
  }
  b.root_area = std::max(2.f * half_area(rlo, rhi), 1e-30f);
  b.build(std::move(root));

  const int n_slots = static_cast<int>(b.child.size() / 2);
  const int n_refs = static_cast<int>(b.ref_out.size());
  if (n_slots > node_capacity || n_refs > ref_capacity) return -1;
  std::memcpy(out_child_lo, b.child_lo.data(), b.child_lo.size() * 4);
  std::memcpy(out_child_hi, b.child_hi.data(), b.child_hi.size() * 4);
  std::memcpy(out_child, b.child.data(), b.child.size() * 4);
  std::memcpy(out_counts, b.counts.data(), b.counts.size() * 4);
  std::memcpy(out_prim_indices, b.ref_out.data(), n_refs * 4);
  *out_n_refs = n_refs;

  Vec3 xlo = vmin(*reinterpret_cast<Vec3 *>(&b.child_lo[0]),
                  *reinterpret_cast<Vec3 *>(&b.child_lo[3]));
  Vec3 xhi = vmax(*reinterpret_cast<Vec3 *>(&b.child_hi[0]),
                  *reinterpret_cast<Vec3 *>(&b.child_hi[3]));
  if (b.counts[1] == 0 && b.child[1] < 0) {
    xlo = *reinterpret_cast<Vec3 *>(&b.child_lo[0]);
    xhi = *reinterpret_cast<Vec3 *>(&b.child_hi[0]);
  }
  std::memcpy(out_root_lo, &xlo, 12);
  std::memcpy(out_root_hi, &xhi, 12);
  return n_slots;
}

// Returns the number of node slots written, or -1 if capacity is too small.
// Capacity arrays must hold at least n prim slots (a binary BVH over n prims
// has at most n internal slots in this representation).
int ray_tpu_build_bvh2(const float *tri_lo, const float *tri_hi, int n,
                       int max_leaf, float *out_child_lo, float *out_child_hi,
                       int32_t *out_child, int32_t *out_counts,
                       int32_t *out_prim_indices, float *out_root_lo,
                       float *out_root_hi, int capacity, int fat_leaves) {
  Builder b;
  b.lo = reinterpret_cast<const Vec3 *>(tri_lo);
  b.hi = reinterpret_cast<const Vec3 *>(tri_hi);
  b.max_leaf = max_leaf;
  b.fat_leaves = fat_leaves != 0;
  b.centroid.resize(n);
  b.order.resize(n);
  for (int i = 0; i < n; ++i) {
    b.centroid[i] = {0.5f * (b.lo[i].x + b.hi[i].x),
                     0.5f * (b.lo[i].y + b.hi[i].y),
                     0.5f * (b.lo[i].z + b.hi[i].z)};
    b.order[i] = i;
  }
  b.build(n);

  const int n_slots = static_cast<int>(b.child.size() / 2);
  if (n_slots > capacity) return -1;
  std::memcpy(out_child_lo, b.child_lo.data(), b.child_lo.size() * 4);
  std::memcpy(out_child_hi, b.child_hi.data(), b.child_hi.size() * 4);
  std::memcpy(out_child, b.child.data(), b.child.size() * 4);
  std::memcpy(out_counts, b.counts.data(), b.counts.size() * 4);
  std::memcpy(out_prim_indices, b.order.data(), n * 4);

  Vec3 rlo = vmin(*reinterpret_cast<Vec3 *>(&b.child_lo[0]),
                  *reinterpret_cast<Vec3 *>(&b.child_lo[3]));
  Vec3 rhi = vmax(*reinterpret_cast<Vec3 *>(&b.child_hi[0]),
                  *reinterpret_cast<Vec3 *>(&b.child_hi[3]));
  if (b.counts[1] == 0 && b.child[1] < 0) {  // single-leaf scene
    rlo = *reinterpret_cast<Vec3 *>(&b.child_lo[0]);
    rhi = *reinterpret_cast<Vec3 *>(&b.child_hi[0]);
  }
  std::memcpy(out_root_lo, &rlo, 12);
  std::memcpy(out_root_hi, &rhi, 12);
  return n_slots;
}

}  // extern "C"
