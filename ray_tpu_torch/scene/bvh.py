"""Host-side SAH BVH builder (numpy).

A copy of ``ray_tpu.scene.bvh``: the numpy binned-SAH builder, which
``ray_tpu`` uses below ``NATIVE_BUILDER_THRESHOLD`` primitives, and at that
size and above the native C++ builder (:mod:`ray_tpu_torch.scene.native`,
compiled with g++ at first use), as ``ray_tpu``'s ``use_native="auto"``
does, so a scene gets the same nodes and leaf order here.  Also
``partition_subtrees``, which cuts a BVH2 into the subtree slabs of the
binned trace (:mod:`ray_tpu_torch.scene.binned`).  ``spatial_splits=True``
builds an SBVH (``_build_sbvh``, or the native builder's SBVH entry point
at the same size), whose leaves may reference a triangle more than once.

Child code convention (int32) — self-contained so the traversal stack needs
no side lookups:
  >= 0 : index of an internal node slot
  <  0 : leaf; with ``v = -code - 1``: ``first = v >> 4``, ``count = v & 15``
         (so ``max_leaf`` ≤ 15 and up to 2^27 primitives).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_STACK_SIZE = 64  # ≥ reference MAX_STACK_SIZE 48 (internal/Constants.inl:4)
NUM_SAH_BINS = 16
TRAVERSAL_COST = 1.0
INTERSECTION_COST = 1.0


@dataclasses.dataclass
class BVH2:
    """Flattened BVH arrays (numpy, host-side)."""

    child_lo: np.ndarray      # (n_nodes, 2, 3) f32 — children AABB mins
    child_hi: np.ndarray      # (n_nodes, 2, 3) f32 — children AABB maxs
    child: np.ndarray         # (n_nodes, 2) i32 — child codes (see module doc)
    counts: np.ndarray        # (n_nodes, 2) i32 — leaf prim counts (0 if internal)
    prim_indices: np.ndarray  # (n_prims,) i32 — permutation into the tri array
    root_lo: np.ndarray       # (3,) f32
    root_hi: np.ndarray       # (3,) f32
    max_leaf: int

    @property
    def num_nodes(self) -> int:
        return int(self.child.shape[0])


LEAF_COUNT_BITS = 4
LEAF_COUNT_MASK = (1 << LEAF_COUNT_BITS) - 1


def _leaf_code(first: int, count: int) -> int:
    assert 0 <= count <= LEAF_COUNT_MASK
    return -(((first << LEAF_COUNT_BITS) | count) + 1)


NATIVE_BUILDER_THRESHOLD = 8192  # prims; below this numpy is fast enough


def build_bvh2(
    tri_lo: np.ndarray, tri_hi: np.ndarray, max_leaf: int = 4,
    use_native: str = "auto", fat_leaves: bool = False,
    spatial_splits: bool = False, tri_verts: np.ndarray = None,
) -> BVH2:
    """Build a binary SAH BVH over primitives with AABBs [tri_lo, tri_hi].

    ``use_native``: 'auto' takes the C++ builder from
    ``NATIVE_BUILDER_THRESHOLD`` primitives on, 'never' forces numpy,
    'always' forces native (``ray_tpu``'s switch; the port raises where the
    C++ builder cannot be built instead of falling back).  ``fat_leaves``:
    stop splitting as soon as a node fits ``max_leaf`` primitives (see
    ``ray_tpu.scene.bvh.build_bvh2``).

    ``spatial_splits``: SBVH reference splitting (Stich et al. 2009, the
    reference's ``SplitPrimitives_SAH`` spatial path): where the best
    object split's children overlap, a primitive straddling the best
    spatial plane is clipped and referenced from both sides, so
    ``prim_indices`` holds duplicates.  ``tri_verts`` (T, 3, 3) clips the
    triangle polygons exactly; without it the reference box is clipped.
    The native SBVH runs where the native BVH2 would; with ``"auto"`` a
    :class:`~ray_tpu_torch.scene.native.NativeCapacityError` (more
    references than its buffers hold) falls back to numpy, with
    ``"always"`` it is raised.
    """
    tri_lo = np.asarray(tri_lo, np.float32)
    tri_hi = np.asarray(tri_hi, np.float32)
    n = tri_lo.shape[0]
    if n == 0:
        raise ValueError("empty BVH")
    if not 1 <= max_leaf <= LEAF_COUNT_MASK:
        raise ValueError(f"max_leaf {max_leaf} outside [1, {LEAF_COUNT_MASK}]")
    if use_native not in ("auto", "never", "always"):
        raise ValueError(f"use_native {use_native!r} is not auto, never or "
                         f"always")
    native_size = use_native == "always" or (
        use_native == "auto" and n >= NATIVE_BUILDER_THRESHOLD)
    if spatial_splits:
        if native_size:
            from ray_tpu_torch.scene import native

            try:
                out = native.build_sbvh_native(
                    tri_lo, tri_hi, None if tri_verts is None
                    else np.asarray(tri_verts, np.float32), max_leaf,
                    fat_leaves=fat_leaves)
            except native.NativeCapacityError:
                if use_native == "always":
                    raise
            else:
                c_lo, c_hi, child, counts, prim, root_lo, root_hi = out
                return BVH2(child_lo=c_lo, child_hi=c_hi, child=child,
                            counts=counts, prim_indices=prim, root_lo=root_lo,
                            root_hi=root_hi, max_leaf=max_leaf)
        # the numpy builder clips in float64 from the vertices as given
        return _build_sbvh(tri_lo, tri_hi, max_leaf,
                           tri_verts=None if tri_verts is None
                           else np.asarray(tri_verts),
                           fat_leaves=fat_leaves)
    if native_size:
        from ray_tpu_torch.scene import native

        c_lo, c_hi, child, counts, prim, root_lo, root_hi = (
            native.build_bvh2_native(tri_lo, tri_hi, max_leaf, fat_leaves))
        return BVH2(child_lo=c_lo, child_hi=c_hi, child=child, counts=counts,
                    prim_indices=prim, root_lo=root_lo, root_hi=root_hi,
                    max_leaf=max_leaf)
    centroids = 0.5 * (tri_lo + tri_hi)

    order = np.arange(n, dtype=np.int32)

    # Node storage grown dynamically.  Each entry describes one *internal*
    # slot: child codes, counts, and children's bounds.
    child_lo, child_hi, child, counts = [], [], [], []

    def subset_bounds(idx):
        return tri_lo[idx].min(axis=0), tri_hi[idx].max(axis=0)

    def make_slot():
        child_lo.append(np.zeros((2, 3), np.float32))
        child_hi.append(np.zeros((2, 3), np.float32))
        child.append(np.zeros(2, np.int64))
        counts.append(np.zeros(2, np.int64))
        return len(child) - 1

    def split(start, end):
        """Choose a partition of order[start:end]; returns mid or None (leaf)."""
        idx = order[start:end]
        count = end - start
        cent = centroids[idx]
        c_lo = cent.min(axis=0)
        c_hi = cent.max(axis=0)
        ext = c_hi - c_lo

        best = None  # (cost, axis, bin_split)
        parent_lo, parent_hi = subset_bounds(idx)
        parent_ext = parent_hi - parent_lo
        parent_area = 2.0 * (
            parent_ext[0] * parent_ext[1]
            + parent_ext[1] * parent_ext[2]
            + parent_ext[2] * parent_ext[0]
        )
        leaf_cost = count * INTERSECTION_COST

        for axis in range(3):
            if ext[axis] < 1e-12:
                continue
            scale = NUM_SAH_BINS * (1.0 - 1e-6) / ext[axis]
            bins = np.minimum(
                ((cent[:, axis] - c_lo[axis]) * scale).astype(np.int32),
                NUM_SAH_BINS - 1,
            )
            # per-bin counts and bounds
            bcount = np.bincount(bins, minlength=NUM_SAH_BINS)
            blo = np.full((NUM_SAH_BINS, 3), np.inf, np.float64)
            bhi = np.full((NUM_SAH_BINS, 3), -np.inf, np.float64)
            np.minimum.at(blo, bins, tri_lo[idx])
            np.maximum.at(bhi, bins, tri_hi[idx])
            # sweep: left-to-right and right-to-left prefix bounds
            lcount = np.cumsum(bcount)[:-1]
            rcount = count - lcount
            llo = np.minimum.accumulate(blo, axis=0)[:-1]
            lhi = np.maximum.accumulate(bhi, axis=0)[:-1]
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1][1:]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1][1:]

            def area(lo, hi, cnt):
                e = np.maximum(hi - lo, 0.0)
                a = 2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0])
                return np.where(cnt > 0, a, 0.0)

            cost = TRAVERSAL_COST + (
                area(llo, lhi, lcount) * lcount + area(rlo, rhi, rcount) * rcount
            ) * INTERSECTION_COST / max(parent_area, 1e-30)
            valid = (lcount > 0) & (rcount > 0)
            if not valid.any():
                continue
            cost = np.where(valid, cost, np.inf)
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), axis, k, c_lo[axis], scale)

        if best is not None and (
            count > max_leaf or ((not fat_leaves) and best[0] < leaf_cost)
        ):
            _, axis, k, lo_a, scale = best
            bins = np.minimum(
                ((cent[:, axis] - lo_a) * scale).astype(np.int32), NUM_SAH_BINS - 1
            )
            left_mask = bins <= k
            nleft = int(left_mask.sum())
            if 0 < nleft < count:
                order[start:end] = np.concatenate([idx[left_mask], idx[~left_mask]])
                return start + nleft

        if count <= max_leaf:
            return None
        # median fallback (degenerate centroids / failed SAH on big node)
        axis = int(np.argmax(ext))
        perm = np.argsort(cent[:, axis], kind="stable")
        order[start:end] = idx[perm]
        return start + count // 2

    # Iterative build.  Work items: (slot, side, start, end).  The root gets a
    # synthetic parent slot 0; if the whole scene fits one leaf, slot 0 holds
    # it in child 0 and an empty leaf in child 1.
    root_slot = make_slot()
    stack = []
    mid = split(0, n)
    if mid is None:
        lo, hi = subset_bounds(order[0:n])
        child_lo[0][0], child_hi[0][0] = lo, hi
        child[0][0] = _leaf_code(0, n)
        counts[0][0] = n
        child_lo[0][1] = np.float32(np.inf)
        child_hi[0][1] = np.float32(-np.inf)
        child[0][1] = _leaf_code(0, 0)
        counts[0][1] = 0
    else:
        stack.append((root_slot, 0, 0, mid))
        stack.append((root_slot, 1, mid, n))

    while stack:
        slot, side, start, end = stack.pop()
        idx = order[start:end]
        lo, hi = subset_bounds(idx)
        child_lo[slot][side], child_hi[slot][side] = lo, hi
        mid = split(start, end)
        if mid is None:
            child[slot][side] = _leaf_code(start, end - start)
            counts[slot][side] = end - start
        else:
            s = make_slot()
            child[slot][side] = s
            stack.append((s, 0, start, mid))
            stack.append((s, 1, mid, end))

    root_lo = np.minimum(child_lo[0][0], child_lo[0][1]).astype(np.float32)
    root_hi = np.maximum(child_hi[0][0], child_hi[0][1]).astype(np.float32)
    if counts[0][1] == 0 and child[0][1] < 0:  # single-leaf scene
        root_lo, root_hi = child_lo[0][0], child_hi[0][0]

    return BVH2(
        child_lo=np.stack(child_lo).astype(np.float32),
        child_hi=np.stack(child_hi).astype(np.float32),
        child=np.stack(child).astype(np.int32),
        counts=np.stack(counts).astype(np.int32),
        prim_indices=order.copy(),
        root_lo=np.asarray(root_lo, np.float32),
        root_hi=np.asarray(root_hi, np.float32),
        max_leaf=max_leaf,
    )


def _surface_area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def _clip_tris_slab(tris, axis, a, b):
    """AABB of each triangle clipped to the axis slab ``a <= x[axis] <= b``,
    vectorized over (M, 3, 3) ``tris``.  The clipped polygon's vertices are
    exactly {original verts inside the slab} ∪ {edge–plane intersections},
    so the AABB is a masked min/max over those ≤9 candidate points.
    Returns (lo, hi) with lo > hi where the intersection is empty."""
    tris = np.asarray(tris, np.float64)
    x = tris[:, :, axis]                              # (M, 3)
    pts = [tris]                                      # (M, 3, 3) candidates
    masks = [(x >= a) & (x <= b)]                     # (M, 3)
    edges = [(0, 1), (1, 2), (2, 0)]
    for p in (a, b):
        if not np.isfinite(p):
            continue
        cand = np.empty_like(tris)
        ok = np.zeros(x.shape, bool)
        for e, (i, j) in enumerate(edges):
            vi, vj = tris[:, i], tris[:, j]
            den = vj[:, axis] - vi[:, axis]
            valid = den != 0.0
            t = np.where(valid, (p - vi[:, axis]) / np.where(valid, den, 1.0),
                         0.0)
            valid &= (t >= 0.0) & (t <= 1.0)
            cand[:, e] = vi + t[:, None] * (vj - vi)
            ok[:, e] = valid
        pts.append(cand)
        masks.append(ok)
    P = np.concatenate(pts, axis=1)                   # (M, K, 3)
    M = np.concatenate(masks, axis=1)[:, :, None]     # (M, K, 1)
    lo = np.where(M, P, np.inf).min(axis=1)
    hi = np.where(M, P, -np.inf).max(axis=1)
    # numerical safety: the slab axis never escapes the slab
    lo[:, axis] = np.clip(lo[:, axis], a, b)
    hi[:, axis] = np.clip(hi[:, axis], a, b)
    return lo, hi


def _build_sbvh(tri_lo, tri_hi, max_leaf, tri_verts=None, fat_leaves=False,
                spatial_alpha=1e-5, max_refs_factor=1.75):
    """SBVH builder (Stich et al. 2009): SAH object splits plus spatial
    reference splits when the object split's children overlap more than
    ``spatial_alpha`` of the root surface area.  Capability analogue of the
    reference's spatial-split path (internal/BVHSplit.cpp
    ``SplitPrimitives_SAH`` with clip_axis; settings Core.h:241).  Works on
    per-*reference* (id, clipped-AABB) triples so a primitive can live in
    several leaves; total references capped at ``max_refs_factor``·n."""
    n = tri_lo.shape[0]
    root_lo64 = tri_lo.min(axis=0).astype(np.float64)
    root_hi64 = tri_hi.max(axis=0).astype(np.float64)
    root_area = max(_surface_area(root_lo64, root_hi64), 1e-30)
    max_refs = int(n * max_refs_factor) + 64
    total_refs = [n]

    child_lo, child_hi, child, counts = [], [], [], []
    ref_ids_out = []           # leaf-order original prim ids (with dups)
    ref_total = [0]

    def make_slot():
        child_lo.append(np.zeros((2, 3), np.float32))
        child_hi.append(np.zeros((2, 3), np.float32))
        child.append(np.zeros(2, np.int64))
        counts.append(np.zeros(2, np.int64))
        return len(child) - 1

    def emit_leaf(ids):
        first = ref_total[0]
        ref_ids_out.append(np.asarray(ids, np.int32))
        ref_total[0] += len(ids)
        return _leaf_code(first, len(ids))

    NB = NUM_SAH_BINS

    def sweep_cost(blo, bhi, lcount, rcount, parent_area):
        llo = np.minimum.accumulate(blo, axis=0)[:-1]
        lhi = np.maximum.accumulate(bhi, axis=0)[:-1]
        rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1][1:]
        rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1][1:]

        def area(lo, hi, cnt):
            e = np.maximum(hi - lo, 0.0)
            a = 2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                       + e[:, 2] * e[:, 0])
            return np.where(cnt > 0, a, 0.0)

        cost = TRAVERSAL_COST + (
            area(llo, lhi, lcount) * lcount + area(rlo, rhi, rcount) * rcount
        ) * INTERSECTION_COST / parent_area
        valid = (lcount > 0) & (rcount > 0)
        return np.where(valid, cost, np.inf), llo, lhi, rlo, rhi

    def split(ids, rlo, rhi):
        """Returns None (make a leaf) or (lids, llo, lhi, rids, rlo, rhi)."""
        count = len(ids)
        cent = 0.5 * (rlo + rhi)
        c_lo, c_hi = cent.min(axis=0), cent.max(axis=0)
        ext = c_hi - c_lo
        p_lo = rlo.min(axis=0).astype(np.float64)
        p_hi = rhi.max(axis=0).astype(np.float64)
        parent_area = max(_surface_area(p_lo, p_hi), 1e-30)
        leaf_cost = count * INTERSECTION_COST

        best_obj = None  # (cost, axis, k, lo_a, scale, overlap_area)
        for axis in range(3):
            if ext[axis] < 1e-12:
                continue
            scale = NB * (1.0 - 1e-6) / ext[axis]
            bins = np.minimum(
                ((cent[:, axis] - c_lo[axis]) * scale).astype(np.int32),
                NB - 1,
            )
            bcount = np.bincount(bins, minlength=NB)
            blo = np.full((NB, 3), np.inf, np.float64)
            bhi = np.full((NB, 3), -np.inf, np.float64)
            np.minimum.at(blo, bins, rlo)
            np.maximum.at(bhi, bins, rhi)
            lcount = np.cumsum(bcount)[:-1]
            rcount = count - lcount
            cost, llo_s, lhi_s, rlo_s, rhi_s = sweep_cost(
                blo, bhi, lcount, rcount, parent_area
            )
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]) and (
                best_obj is None or cost[k] < best_obj[0]
            ):
                ov_lo = np.maximum(llo_s[k], rlo_s[k])
                ov_hi = np.minimum(lhi_s[k], rhi_s[k])
                best_obj = (float(cost[k]), axis, k, c_lo[axis], scale,
                            _surface_area(ov_lo, ov_hi))

        # ---- spatial-split candidate (SBVH): only when the object split's
        # children overlap a meaningful fraction of the root area ----
        best_sp = None  # (cost, axis, plane)
        try_spatial = (
            best_obj is not None
            and best_obj[5] / root_area > spatial_alpha
            and total_refs[0] < max_refs
            and count > 1
        )
        if try_spatial:
            for axis in range(3):
                width = float(p_hi[axis] - p_lo[axis])
                if width < 1e-12:
                    continue
                bw = width / NB
                b0 = np.minimum(
                    ((rlo[:, axis] - p_lo[axis]) / bw).astype(np.int32),
                    NB - 1,
                )
                b1 = np.minimum(
                    ((rhi[:, axis] - p_lo[axis]) / bw).astype(np.int32),
                    NB - 1,
                )
                b0 = np.maximum(b0, 0)
                b1 = np.maximum(b1, b0)
                entries = np.bincount(b0, minlength=NB)
                exits = np.bincount(b1, minlength=NB)
                blo = np.full((NB, 3), np.inf, np.float64)
                bhi = np.full((NB, 3), -np.inf, np.float64)
                for k in range(NB):
                    m = (b0 <= k) & (b1 >= k)
                    if not m.any():
                        continue
                    slab_lo = p_lo[axis] + k * bw
                    slab_hi = p_lo[axis] + (k + 1) * bw
                    if tri_verts is not None:
                        # exact chopped binning (SBVH §4.2): clip the
                        # triangle polygon to the bin slab, then intersect
                        # with the (possibly ancestor-clipped) ref box
                        clo, chi = _clip_tris_slab(
                            tri_verts[ids[m]], axis, slab_lo, slab_hi
                        )
                        clo = np.maximum(clo, rlo[m])
                        chi = np.minimum(chi, rhi[m])
                        ok = (clo <= chi).all(axis=1)
                        if not ok.any():
                            continue
                        clo, chi = clo[ok], chi[ok]
                    else:
                        clo = rlo[m].copy()
                        chi = rhi[m].copy()
                        clo[:, axis] = np.maximum(clo[:, axis], slab_lo)
                        chi[:, axis] = np.minimum(chi[:, axis], slab_hi)
                    blo[k] = np.minimum(blo[k], clo.min(axis=0))
                    bhi[k] = np.maximum(bhi[k], chi.max(axis=0))
                lcount = np.cumsum(entries)[:-1]
                rcount = count - np.cumsum(exits)[:-1]
                cost, _, _, _, _ = sweep_cost(
                    blo, bhi, lcount, rcount, parent_area
                )
                k = int(np.argmin(cost))
                if np.isfinite(cost[k]) and (
                    best_sp is None or cost[k] < best_sp[0]
                ):
                    best_sp = (float(cost[k]), axis,
                               float(p_lo[axis] + (k + 1) * bw))

        use_spatial = (
            best_sp is not None
            and (best_obj is None or best_sp[0] < best_obj[0])
        )
        best_cost = (best_sp[0] if use_spatial
                     else (best_obj[0] if best_obj else np.inf))
        if count <= max_leaf and (
            fat_leaves or not np.isfinite(best_cost) or best_cost >= leaf_cost
        ):
            return None

        if use_spatial:
            _, axis, plane = best_sp
            fully_l = rhi[:, axis] <= plane
            fully_r = rlo[:, axis] >= plane
            strad = ~(fully_l | fully_r)
            n_str = int(strad.sum())
            if n_str > 0 and total_refs[0] + n_str <= max_refs:
                sidx = np.nonzero(strad)[0]
                l_lo_s = rlo[sidx].copy()
                l_hi_s = rhi[sidx].copy()
                l_hi_s[:, axis] = np.minimum(l_hi_s[:, axis], plane)
                r_lo_s = rlo[sidx].copy()
                r_hi_s = rhi[sidx].copy()
                r_lo_s[:, axis] = np.maximum(r_lo_s[:, axis], plane)
                lok = np.ones(n_str, bool)
                rok = np.ones(n_str, bool)
                if tri_verts is not None:
                    stri = tri_verts[ids[sidx]]
                    cl_lo, cl_hi = _clip_tris_slab(stri, axis, -np.inf, plane)
                    l_lo_s = np.maximum(l_lo_s, cl_lo)
                    l_hi_s = np.minimum(l_hi_s, cl_hi)
                    cr_lo, cr_hi = _clip_tris_slab(stri, axis, plane, np.inf)
                    r_lo_s = np.maximum(r_lo_s, cr_lo)
                    r_hi_s = np.minimum(r_hi_s, cr_hi)
                    # a ref box clipped by an ancestor may sit entirely on
                    # one side of the plane even though its box straddles —
                    # drop the empty side instead of emitting a dead ref
                    lok = (l_lo_s <= l_hi_s).all(axis=1)
                    rok = (r_lo_s <= r_hi_s).all(axis=1)
                lids = np.concatenate([ids[fully_l], ids[sidx][lok]])
                llo = np.concatenate([rlo[fully_l], l_lo_s[lok]])
                lhi = np.concatenate([rhi[fully_l], l_hi_s[lok]])
                rids = np.concatenate([ids[fully_r], ids[sidx][rok]])
                rlo_n = np.concatenate([rlo[fully_r], r_lo_s[rok]])
                rhi_n = np.concatenate([rhi[fully_r], r_hi_s[rok]])
                # both sides non-empty → accept (termination is bounded by
                # the max_refs budget: degenerate all-straddle nodes stop
                # duplicating once the cap is hit and fall back to object/
                # median splits, whose recursion always terminates)
                if len(lids) > 0 and len(rids) > 0:
                    total_refs[0] += len(lids) + len(rids) - count
                    return lids, llo, lhi, rids, rlo_n, rhi_n
            if n_str == 0 and 0 < int(fully_l.sum()) < count:
                return (ids[fully_l], rlo[fully_l], rhi[fully_l],
                        ids[fully_r], rlo[fully_r], rhi[fully_r])
            # else fall through to the object split

        if best_obj is not None:
            _, axis, k, lo_a, scale, _ = best_obj
            bins = np.minimum(
                ((cent[:, axis] - lo_a) * scale).astype(np.int32), NB - 1
            )
            lm = bins <= k
            if 0 < int(lm.sum()) < count:
                return (ids[lm], rlo[lm], rhi[lm],
                        ids[~lm], rlo[~lm], rhi[~lm])

        if count <= max_leaf:
            return None
        axis = int(np.argmax(ext))
        perm = np.argsort(cent[:, axis], kind="stable")
        mid = count // 2
        lp, rp = perm[:mid], perm[mid:]
        return ids[lp], rlo[lp], rhi[lp], ids[rp], rlo[rp], rhi[rp]

    ids0 = np.arange(n, dtype=np.int32)
    root_slot = make_slot()
    first = split(ids0, tri_lo.astype(np.float64), tri_hi.astype(np.float64))
    stack = []
    if first is None:
        child_lo[0][0] = tri_lo.min(axis=0)
        child_hi[0][0] = tri_hi.max(axis=0)
        child[0][0] = emit_leaf(ids0)
        counts[0][0] = n
        child_lo[0][1] = np.float32(np.inf)
        child_hi[0][1] = np.float32(-np.inf)
        child[0][1] = _leaf_code(0, 0)
        counts[0][1] = 0
    else:
        lids, llo, lhi, rids, rlo, rhi = first
        stack.append((root_slot, 0, lids, llo, lhi))
        stack.append((root_slot, 1, rids, rlo, rhi))

    while stack:
        slot, side, ids, rlo, rhi = stack.pop()
        child_lo[slot][side] = rlo.min(axis=0).astype(np.float32)
        child_hi[slot][side] = rhi.max(axis=0).astype(np.float32)
        res = split(ids, rlo, rhi)
        if res is None:
            child[slot][side] = emit_leaf(ids)
            counts[slot][side] = len(ids)
        else:
            s = make_slot()
            child[slot][side] = s
            lids, llo, lhi, rids, rlo2, rhi2 = res
            stack.append((s, 0, lids, llo, lhi))
            stack.append((s, 1, rids, rlo2, rhi2))

    root_lo = np.minimum(child_lo[0][0], child_lo[0][1]).astype(np.float32)
    root_hi = np.maximum(child_hi[0][0], child_hi[0][1]).astype(np.float32)
    if counts[0][1] == 0 and child[0][1] < 0:
        root_lo, root_hi = child_lo[0][0], child_hi[0][0]

    return BVH2(
        child_lo=np.stack(child_lo).astype(np.float32),
        child_hi=np.stack(child_hi).astype(np.float32),
        child=np.stack(child).astype(np.int32),
        counts=np.stack(counts).astype(np.int32),
        prim_indices=np.concatenate(ref_ids_out)
        if ref_ids_out else np.zeros(0, np.int32),
        root_lo=root_lo,
        root_hi=root_hi,
        max_leaf=max_leaf,
    )


def pack_node_columns(child_lo: np.ndarray, child_hi: np.ndarray,
                      child: np.ndarray) -> dict:
    """Node records as 1-D columns plus one packed (N, 14) f32 row per node
    (child codes ride bitcast in the last two columns) — the layout
    ``ray_tpu`` keeps, so a finalized scene carries across unchanged."""
    out = {}
    for side in range(2):
        for axis, ax in enumerate("xyz"):
            out[f"lo{side}{ax}"] = np.ascontiguousarray(child_lo[:, side, axis])
            out[f"hi{side}{ax}"] = np.ascontiguousarray(child_hi[:, side, axis])
        out[f"code{side}"] = np.ascontiguousarray(child[:, side])
    codes_f = np.ascontiguousarray(child[:, :2].astype(np.int32)).view(np.float32)
    out["packed"] = np.concatenate([
        child_lo[:, 0].astype(np.float32), child_hi[:, 0].astype(np.float32),
        child_lo[:, 1].astype(np.float32), child_hi[:, 1].astype(np.float32),
        codes_f,
    ], axis=1)
    return out


def pack_bvh_soa(bvh: "BVH2") -> dict:
    return pack_node_columns(bvh.child_lo, bvh.child_hi, bvh.child)


def pack_tri_soa(vertices: np.ndarray, tri_vidx: np.ndarray) -> dict:
    """Leaf-order triangle soup as 9 1-D columns (p0..p2 × xyz) plus the
    packed (T, 9) row table — the table the brute-force trace kernel
    reads."""
    tris = vertices[tri_vidx]  # (T, 3, 3)
    out = {}
    for v in range(3):
        for axis, ax in enumerate("xyz"):
            out[f"p{v}{ax}"] = np.ascontiguousarray(tris[:, v, axis])
    out["packed"] = np.ascontiguousarray(
        tris.reshape(tris.shape[0], 9).astype(np.float32)
    )
    return out


def tri_bounds(vertices: np.ndarray, indices: np.ndarray):
    """AABBs of indexed triangles. vertices (V,3) f32, indices (T,3) i32."""
    tris = vertices[indices]  # (T, 3, 3)
    return tris.min(axis=1), tris.max(axis=1)


def bvh_depth(bvh: BVH2) -> int:
    """Max tree depth (slots), for stack-size assertions."""
    depth = np.zeros(bvh.num_nodes, np.int32)
    # nodes are created parent-before-child, so a forward pass works
    for i in range(bvh.num_nodes):
        for side in range(2):
            c = bvh.child[i, side]
            if c >= 0:
                depth[c] = depth[i] + 1
    return int(depth.max()) + 1 if bvh.num_nodes else 1


# ---------------------------------------------------------------------------
# Subtree partition for the binned trace (scene/binned.py): cut the BVH2
# into subtree slabs of at most 512 node and 512 triangle rows.
# ---------------------------------------------------------------------------


def _subtree_extents(bvh: BVH2):
    """Per-node DFS extents: node range [i, node_end[i]) and total leaf tri
    count of the subtree rooted at i.  Node layout must be
    parent-before-child and DFS-contiguous; leaf triangle indices need not
    be contiguous (the native builder's aren't) — subtrees carry an
    explicit local→global triangle map instead."""
    n = bvh.num_nodes
    node_end = np.zeros(n, np.int64)
    tcnt = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        ne = i + 1
        cnt = 0
        for side in range(2):
            c = int(bvh.child[i, side])
            if c >= 0:
                if c <= i:
                    raise ValueError("builder must lay children after parents")
                ne = max(ne, node_end[c])
                cnt += tcnt[c]
            else:
                cnt += (-c - 1) & LEAF_COUNT_MASK
        node_end[i] = ne
        tcnt[i] = cnt
    return node_end, tcnt


def partition_subtrees(bvh: BVH2, max_rows: int = 512):
    """Cut ``bvh`` into subtrees with ≤ ``max_rows`` nodes AND ≤ max_rows
    tris each, plus a top tree over the cut roots (``ray_tpu``'s
    ``partition_subtrees``).  A node too large to be a subtree whose child
    is a leaf cannot be cut: that raises ``ValueError``, where ``ray_tpu``
    fails its assertion on the same scenes.

    Returns a dict:
      top_child_lo/top_child_hi (Nt, 2, 3), top_code (Nt, 2) — internal
        child ≥ 0 indexes the top array; a subtree leaf is ``-(sid+1)``;
      sub_local: list of per-subtree BVH2s with LOCAL codes (child index −
        node_off; leaf firsts renumbered consecutively);
      sub_tri_ids: list of (n_s,) int32 local→global tri id maps;
      depth: max subtree depth (stack sizing).
    """
    node_end, tcnt = _subtree_extents(bvh)

    # the cut roots in depth-first order, child 0 before child 1
    cuts = []
    todo = [0]
    while todo:
        v = todo.pop()
        if (node_end[v] - v) <= max_rows and tcnt[v] <= max_rows:
            cuts.append(v)
            continue
        kids = []
        for side in range(2):
            c = int(bvh.child[v, side])
            if c < 0:
                raise ValueError(
                    f"leaf with {bvh.counts[v, side]} tris cannot be split "
                    f"below max_rows={max_rows}")
            kids.append(c)
        todo.extend(reversed(kids))
    sid_of = {v: i for i, v in enumerate(cuts)}

    # ---- top tree: the ancestors of the cut roots, renumbered in the same
    # depth-first order ----
    top_nodes = []
    todo = [0]
    while todo:
        v = todo.pop()
        if v in sid_of:
            continue
        top_nodes.append(v)
        todo.extend(int(bvh.child[v, side]) for side in (1, 0))
    if not top_nodes:
        # whole tree is one subtree: top tree = one pseudo-node whose
        # child 0 is subtree 0 and child 1 is empty
        top_child_lo = np.zeros((1, 2, 3), np.float32)
        top_child_hi = np.zeros((1, 2, 3), np.float32)
        top_child_lo[0, 0] = bvh.root_lo
        top_child_hi[0, 0] = bvh.root_hi
        top_child_lo[0, 1] = 1.0   # inverted box: never hits
        top_child_hi[0, 1] = 0.0
        top_code = np.array([[-1, -0x7FFFFFF0]], np.int32)
    else:
        remap = {v: i for i, v in enumerate(top_nodes)}
        nt = len(top_nodes)
        top_child_lo = np.zeros((nt, 2, 3), np.float32)
        top_child_hi = np.zeros((nt, 2, 3), np.float32)
        top_code = np.zeros((nt, 2), np.int32)
        for v in top_nodes:
            i = remap[v]
            top_child_lo[i] = bvh.child_lo[v]
            top_child_hi[i] = bvh.child_hi[v]
            for side in range(2):
                c = int(bvh.child[v, side])
                if c in sid_of:
                    top_code[i, side] = -(sid_of[c] + 1)
                else:
                    top_code[i, side] = remap[c]

    # ---- per-subtree local arrays: renumber leaf tris consecutively and
    # record the local→global id map ----
    sub_local = []
    sub_tri_ids = []
    depth = 1
    for v in cuts:
        ns, ne = v, int(node_end[v])
        child = bvh.child[ns:ne].astype(np.int64).copy()
        internal = child >= 0
        child[internal] -= ns
        ids = []
        flat = child.reshape(-1)
        for j in range(flat.shape[0]):
            c = int(flat[j])
            if c >= 0:
                continue
            code = -c - 1
            first = code >> LEAF_COUNT_BITS
            count = code & LEAF_COUNT_MASK
            local_first = len(ids)
            ids.extend(range(first, first + count))
            flat[j] = -(((local_first << LEAF_COUNT_BITS) | count) + 1)
        sub = BVH2(
            child_lo=bvh.child_lo[ns:ne], child_hi=bvh.child_hi[ns:ne],
            child=child, counts=bvh.counts[ns:ne],
            prim_indices=None, root_lo=None, root_hi=None,
            max_leaf=bvh.max_leaf,
        )
        depth = max(depth, bvh_depth(sub))
        sub_local.append(sub)
        sub_tri_ids.append(np.asarray(ids, np.int32))

    return {
        "top_child_lo": top_child_lo,
        "top_child_hi": top_child_hi,
        "top_code": top_code,
        "sub_local": sub_local,
        "sub_tri_ids": sub_tri_ids,
        "depth": depth,
    }
