"""8-wide BVH row table (``wrows``) for flatten scenes past 256 triangles.

A numpy copy of ``ray_tpu.scene.wbvh.build_wbvh``: the BVH2 is collapsed
greedily into 8-wide nodes and padded leaf groups, all in ONE f32 row
table, nodes first.  ``ray_tpu``'s wide walk (``_traverse_wide``) reads it;
the port does not walk it yet (ROADMAP Queue 1 item 19) and builds it so
that a finalized ``SceneFlat`` carries ``ray_tpu``'s tables bit for bit.

Encodings:
- visit code ≥ 0: wide-node visit, ``row << 8 | child_mask``;
- visit code < 0 (≠ EMPTY): leaf group at absolute row ``-(code + 1)``;
- empty child slot: EMPTY = int32 min.

Row layout, width W = max(56, 11·max_leaf):
- node rows: child-SoA [lox(8) loy(8) loz(8) hix(8) hiy(8) hiz(8) codes(8)];
- leaf rows: slot-SoA [p0x(L) p0y(L) p0z(L) p1x(L) p1y(L) p1z(L) p2x(L)
  p2y(L) p2z(L) prim(L) vis(L)].
Padding slots carry NaN positions; padding children carry EMPTY codes and
inverted boxes.  The two-level table (``build_wtlas``) waits for the TLAS
slice (Queue 1 item 17).
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.scene.bvh import BVH2, LEAF_COUNT_BITS, LEAF_COUNT_MASK

WIDE = 8
EMPTY = np.int32(-0x80000000)
NODE_COLS = 56


def _area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def _collapse_wide(bvh: BVH2, make_leaf):
    """Greedy 8-wide collapse of a BVH2: expand the largest-area internal
    child until 8 slots fill.  ``make_leaf(code)`` maps a BVH2 leaf code to
    a leaf ordinal.  Returns a list of (codes[8] — wide-node ordinal or
    make_leaf() result —, is_leaf[8], lo[8, 3], hi[8, 3])."""
    child = bvh.child
    c_lo = bvh.child_lo
    c_hi = bvh.child_hi

    nodes = []
    todo = []

    def alloc_wide():
        nodes.append(None)
        return len(nodes) - 1

    root_w = alloc_wide()
    todo.append((root_w, 0))

    while todo:
        wid, slot = todo.pop()
        items = [
            (int(child[slot, s]), c_lo[slot, s], c_hi[slot, s])
            for s in range(2)
        ]
        while len(items) < WIDE:
            # expand the internal child with the largest surface area
            best = -1
            best_a = -1.0
            for k, (code, lo, hi) in enumerate(items):
                if code >= 0:
                    a = _area(lo, hi)
                    if a > best_a:
                        best_a = a
                        best = k
            if best < 0:
                break
            code, _, _ = items.pop(best)
            for s in range(2):
                items.append(
                    (int(child[code, s]), c_lo[code, s], c_hi[code, s])
                )

        codes = np.full(WIDE, EMPTY, np.int32)
        is_leaf = np.zeros(WIDE, np.bool_)
        lo8 = np.full((WIDE, 3), np.inf, np.float32)
        hi8 = np.full((WIDE, 3), -np.inf, np.float32)
        for k, (code, lo, hi) in enumerate(items):
            if code < 0:
                enc = -code - 1
                if (enc & LEAF_COUNT_MASK) == 0:
                    continue  # empty leaf slot
                codes[k] = make_leaf(code)
                is_leaf[k] = True
            else:
                w = alloc_wide()
                todo.append((w, code))
                codes[k] = w
            lo8[k] = lo
            hi8[k] = hi
        nodes[wid] = (codes, is_leaf, lo8, hi8)
    return nodes


def _node_rows(nodes, width, leaf_code_fn, node_base=0):
    """Wide-node rows.  ``leaf_code_fn(ordinal)`` gives the final int32
    code of a leaf child; internal child w becomes
    ``((w + node_base) << 8) | 0xFF``."""
    n = len(nodes)
    out = np.zeros((n, width), np.float32)
    for i, (codes, is_leaf, lo8, hi8) in enumerate(nodes):
        final = np.where(
            codes == EMPTY, EMPTY,
            np.where(is_leaf, leaf_code_fn(codes),
                     ((codes + node_base) << 8) | 0xFF),
        ).astype(np.int32)
        out[i, 0:8] = lo8[:, 0]
        out[i, 8:16] = lo8[:, 1]
        out[i, 16:24] = lo8[:, 2]
        out[i, 24:32] = hi8[:, 0]
        out[i, 32:40] = hi8[:, 1]
        out[i, 40:48] = hi8[:, 2]
        out[i, 48:56] = final.view(np.float32)
    return out


def _tri_leaf_rows(leaf_codes, tri_soa_packed, tri_vis, max_leaf, width):
    """Padded leaf-group rows for a list of BVH2 leaf codes (slot-SoA)."""
    rows = np.zeros((len(leaf_codes), width), np.float32)
    for g, code in enumerate(leaf_codes):
        enc = -code - 1
        first = enc >> LEAF_COUNT_BITS
        count = enc & LEAF_COUNT_MASK
        tri9 = np.full((max_leaf, 9), np.nan, np.float32)
        tri9[:count] = tri_soa_packed[first:first + count]
        prims = np.full(max_leaf, -1, np.int32)
        prims[:count] = np.arange(first, first + count, dtype=np.int32)
        vis = np.zeros(max_leaf, np.int32)
        vis[:count] = (
            0x7fffffff if tri_vis is None else tri_vis[first:first + count]
        )
        rows[g, :9 * max_leaf] = np.ascontiguousarray(tri9.T).reshape(-1)
        rows[g, 9 * max_leaf:10 * max_leaf] = prims.view(np.float32)
        rows[g, 10 * max_leaf:11 * max_leaf] = vis.view(np.float32)
    return rows


def build_wbvh(bvh: BVH2, tri_soa_packed: np.ndarray,
               tri_vis: np.ndarray | None = None) -> dict:
    """Collapse a BVH2 into 8-wide nodes + padded leaf groups in one table.

    ``tri_soa_packed``: (T, 9) leaf-order triangle rows.  Returns
    ``{"wrows": (N + G, W) f32}``, node rows first."""
    max_leaf = bvh.max_leaf
    width = max(NODE_COLS, 11 * max_leaf)

    leaf_codes = []

    def make_leaf(code):
        leaf_codes.append(code)
        return len(leaf_codes) - 1

    nodes = _collapse_wide(bvh, make_leaf)
    n = len(nodes)
    rows = np.concatenate([
        # leaf child g → absolute row -(n + g + 1)
        _node_rows(nodes, width, lambda g: -(n + g + 1)),
        _tri_leaf_rows(leaf_codes, tri_soa_packed, tri_vis, max_leaf, width),
    ]) if leaf_codes else _node_rows(nodes, width, lambda g: g)

    return {"wrows": rows}
