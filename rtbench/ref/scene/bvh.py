"""Host-side SAH BVH builder (numpy).

A copy of ``ray_tpu.scene.bvh``'s numpy binned-SAH builder.  The port
builds large trees with a native C++ builder that gives the same nodes and
leaf order; the reference builds every tree here.

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


def build_bvh2(tri_lo: np.ndarray, tri_hi: np.ndarray, max_leaf: int = 4,
               fat_leaves: bool = False) -> BVH2:
    """Build a binary SAH BVH over primitives with AABBs [tri_lo, tri_hi].

    ``fat_leaves``: stop splitting as soon as a node fits ``max_leaf``
    primitives (see ``ray_tpu.scene.bvh.build_bvh2``).
    """
    tri_lo = np.asarray(tri_lo, np.float32)
    tri_hi = np.asarray(tri_hi, np.float32)
    n = tri_lo.shape[0]
    if n == 0:
        raise ValueError("empty BVH")
    if not 1 <= max_leaf <= LEAF_COUNT_MASK:
        raise ValueError(f"max_leaf {max_leaf} outside [1, {LEAF_COUNT_MASK}]")
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
