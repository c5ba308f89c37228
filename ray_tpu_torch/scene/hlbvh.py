"""HLBVH / Morton fast builder (``finalize(fast_build=True)``).

A copy of ``ray_tpu.scene.hlbvh``: the counterpart of the reference's
``PreprocessPrims_HLBVH`` (internal/Core.cpp:330-574: 30-bit Morton codes,
a radix sort, ``EmitLBVH`` treelets) as the vectorized Karras radix tree
(Karras 2012, "Maximally Parallel Construction of BVHs ..."): every
internal node's range and split come from common-prefix binary searches
over the sorted Morton codes in numpy array ops, subtrees of at most
``max_leaf`` prims collapse into leaves, and node boxes come from
sparse-table range min/max over the Morton-ordered prim bounds.  It emits
the SAH builder's :class:`ray_tpu_torch.scene.bvh.BVH2`, so packing,
the 8-wide rows, the binned slabs and every trace kernel take it as they
take a SAH tree; the tables are ``ray_tpu``'s byte for byte.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.scene.bvh import BVH2, LEAF_COUNT_MASK, _leaf_code


def morton30(centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in [lo, hi] (10 bits/axis —
    reference Core.cpp:330 uses the same resolution)."""
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / ext * 1024.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (
        (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    ).astype(np.int64)


def _delta_fast(codes, i, j, n):
    """Vector δ without np.vectorize: log2 via float exponent trick."""
    j = np.asarray(j, np.int64)
    i = np.asarray(i, np.int64)
    ok = (j >= 0) & (j < n)
    js = np.clip(j, 0, n - 1)
    x = codes[i] ^ codes[js]
    same = x == 0
    tie = np.where(same, i ^ js, 0)
    x = np.where(same, tie, x)
    # number of leading zeros: 63 - floor(log2(x)); x ≤ 2^60 here so the
    # f64 mantissa holds it exactly
    hb = np.zeros_like(x)
    nz = x > 0
    hb[nz] = np.floor(np.log2(x[nz].astype(np.float64))).astype(np.int64)
    lz = np.where(x > 0, 63 - hb, 64)
    return np.where(ok, np.where(same, 64 + lz, lz), -1)


def _karras_ranges(codes: np.ndarray):
    """For each internal node i ∈ [0, n-2]: (range_other_end, split γ) —
    vectorized binary searches (Karras 2012 §4)."""
    n = codes.shape[0]
    i = np.arange(n - 1, dtype=np.int64)
    d = np.sign(
        _delta_fast(codes, i, i + 1, n) - _delta_fast(codes, i, i - 1, n)
    ).astype(np.int64)
    d[d == 0] = 1
    delta_min = _delta_fast(codes, i, i - d, n)

    # find upper bound on range length
    lmax = np.full(n - 1, 2, np.int64)
    while True:
        probe = _delta_fast(codes, i, i + lmax * d, n)
        grow = probe > delta_min
        if not grow.any():
            break
        lmax[grow] *= 2
        if lmax.max() > 4 * n:
            break

    # binary search the exact other end
    l = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while t.max() >= 1:
        probe = _delta_fast(codes, i, i + (l + t) * d, n)
        take = (t >= 1) & (probe > delta_min)
        l[take] += t[take]
        t = t // 2
    j = i + l * d

    # binary search the split point γ
    delta_node = _delta_fast(codes, i, j, n)
    s = np.zeros(n - 1, np.int64)
    t = np.int64(1)
    div = 2
    while True:
        t = (l + div - 1) // div
        probe = _delta_fast(codes, i, i + (s + t) * d, n)
        take = (t >= 1) & (probe > delta_node)
        s[take] += t[take]
        if (t <= 1).all():
            break
        div *= 2
    gamma = i + s * d + np.minimum(d, 0)
    return d, j, gamma


def _range_minmax_tables(lo, hi):
    """Sparse tables for O(1) AABB of any contiguous prim range."""
    n = lo.shape[0]
    levels = max(int(np.floor(np.log2(n))) + 1, 1)
    lo_t = [lo]
    hi_t = [hi]
    for k in range(1, levels):
        h = 1 << (k - 1)
        prev_lo, prev_hi = lo_t[-1], hi_t[-1]
        m = n - (1 << k) + 1
        if m <= 0:
            break
        lo_t.append(np.minimum(prev_lo[:m], prev_lo[h:h + m]))
        hi_t.append(np.maximum(prev_hi[:m], prev_hi[h:h + m]))
    return lo_t, hi_t


def _range_aabb(lo_t, hi_t, a, b):
    """AABB over sorted-prim ranges [a, b] inclusive (vectorized)."""
    ln = b - a + 1
    k = np.zeros_like(ln)
    nz = ln > 0
    k[nz] = np.floor(np.log2(ln[nz].astype(np.float64))).astype(ln.dtype)
    k = np.clip(k, 0, len(lo_t) - 1)
    lo = np.empty((a.shape[0], 3), np.float32)
    hi = np.empty((a.shape[0], 3), np.float32)
    for kk in np.unique(k):
        m = k == kk
        h = 1 << int(kk)
        a2 = a[m]
        b2 = np.maximum(b[m] - h + 1, a2)
        lo[m] = np.minimum(lo_t[int(kk)][a2], lo_t[int(kk)][b2])
        hi[m] = np.maximum(hi_t[int(kk)][a2], hi_t[int(kk)][b2])
    return lo, hi


def build_hlbvh(tri_lo: np.ndarray, tri_hi: np.ndarray,
                max_leaf: int = 4) -> BVH2:
    """Morton/LBVH fast build → :class:`BVH2` (same flat format as the SAH
    builder, interchangeable everywhere)."""
    tri_lo = np.asarray(tri_lo, np.float32)
    tri_hi = np.asarray(tri_hi, np.float32)
    n = tri_lo.shape[0]
    assert 1 <= max_leaf <= LEAF_COUNT_MASK
    root_lo = tri_lo.min(axis=0)
    root_hi = tri_hi.max(axis=0)

    cent = 0.5 * (tri_lo + tri_hi)
    codes = morton30(cent, root_lo, root_hi)
    order = np.argsort(codes, kind="stable").astype(np.int32)
    codes = codes[order]
    s_lo = tri_lo[order]
    s_hi = tri_hi[order]

    if n <= max_leaf:
        # whole scene in one leaf: child0 = leaf, child1 = empty leaf with
        # inverted AABB (same convention as build_bvh2's single-leaf case)
        child_lo = np.stack([root_lo, np.full(3, np.inf, np.float32)])[None]
        child_hi = np.stack([root_hi, np.full(3, -np.inf, np.float32)])[None]
        return BVH2(
            child_lo=child_lo.astype(np.float32),
            child_hi=child_hi.astype(np.float32),
            child=np.array([[_leaf_code(0, n), _leaf_code(0, 0)]], np.int32),
            counts=np.array([[n, 0]], np.int32),
            prim_indices=order, root_lo=root_lo, root_hi=root_hi,
            max_leaf=max_leaf,
        )

    d, j, gamma = _karras_ranges(codes)
    rng_lo = np.minimum(np.arange(n - 1), j)
    rng_hi = np.maximum(np.arange(n - 1), j)
    sizes = rng_hi - rng_lo + 1

    lo_t, hi_t = _range_minmax_tables(s_lo, s_hi)

    # a Karras internal node is *kept* iff its range holds > max_leaf prims;
    # a kept node's child collapses to a leaf when the child range fits
    kept = sizes > max_leaf
    assert kept[0], "n > max_leaf implies the root is internal"

    kept_ids = np.nonzero(kept)[0]
    slot_of = np.full(n - 1, -1, np.int64)
    slot_of[kept_ids] = np.arange(kept_ids.shape[0])
    num_nodes = kept_ids.shape[0]

    # children of kept node i (Karras): left spans [lo, γ], right [γ+1, hi]
    g = gamma[kept_ids]
    lo_i = rng_lo[kept_ids]
    hi_i = rng_hi[kept_ids]

    child = np.empty((num_nodes, 2), np.int32)
    counts = np.zeros((num_nodes, 2), np.int32)
    child_lo = np.empty((num_nodes, 2, 3), np.float32)
    child_hi = np.empty((num_nodes, 2, 3), np.float32)

    for side, (a, b) in enumerate(((lo_i, g), (g + 1, hi_i))):
        size = b - a + 1
        is_leaf = size <= max_leaf
        lo_a, hi_a = _range_aabb(lo_t, hi_t, a, b)
        child_lo[:, side] = lo_a
        child_hi[:, side] = hi_a
        # leaf code: -(first << 4 | count) - 1 (bvh.py _leaf_code)
        leaf_code = -(((a.astype(np.int64) << 4) | size) + 1)
        # internal child: the Karras node that owns the subrange.  Karras:
        # left child id = γ (when leaf) else γ; right child id = γ+1; the
        # internal child node id equals γ (left) / γ+1 (right).
        internal_id = g if side == 0 else g + 1
        child[:, side] = np.where(
            is_leaf, leaf_code, slot_of[np.clip(internal_id, 0, n - 2)]
        ).astype(np.int32)
        counts[:, side] = np.where(is_leaf, size, 0).astype(np.int32)

    return BVH2(
        child_lo=child_lo, child_hi=child_hi, child=child, counts=counts,
        prim_indices=order, root_lo=root_lo, root_hi=root_hi,
        max_leaf=max_leaf,
    )
