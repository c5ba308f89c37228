"""8-wide BVH row table ``wrows_tlas`` of two-level scenes past 256
unique triangles.

A numpy copy of ``ray_tpu.scene.wbvh``'s ``build_wtlas`` /
``finish_wtlas``: each BLAS is collapsed greedily into 8-wide nodes and
padded leaf groups, all in ONE f32 row table with the instance rows, so
that a finalized scene carries ``ray_tpu``'s table bit for bit.  The
port's ``build_wbvh`` for flattened scenes is left out: the reference's
flattened scenes take the brute-force test.

Encodings:
- visit code ≥ 0: wide-node visit, ``row << 8 | child_mask``;
- visit code < 0 (≠ EMPTY): leaf group at absolute row ``-(code + 1)``;
- empty child slot: EMPTY = int32 min.

Row layout, width W = max(56, 11·max_leaf):
- node rows: child-SoA [lox(8) loy(8) loz(8) hix(8) hiy(8) hiz(8) codes(8)];
- leaf rows: slot-SoA [p0x(L) p0y(L) p0z(L) p1x(L) p1y(L) p1z(L) p2x(L)
  p2y(L) p2z(L) prim(L) vis(L)].
Padding slots carry NaN positions; padding children carry EMPTY codes and
inverted boxes.
"""

from __future__ import annotations

import numpy as np

from rtbench.ref.scene.bvh import BVH2, LEAF_COUNT_BITS, LEAF_COUNT_MASK

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


# ---------------------------------------------------------------------------
# Two-level table: TLAS wide nodes, one instance row per instance and each
# mesh's wide BLAS rows, merged into ONE table so that a traversal step
# reads exactly one row.
#
# Code space (int32):
#   cur >= 0                    wide-node visit: (row << 8) | child_mask
#   cur < 0, v = -cur - 1:
#     v bit 28 set              instance row at v & 0x0FFFFFFF
#     else                      triangle leaf-group row at v
#   RESTORE / EMPTY             sentinels (ops/traverse.py)
# Row budget: row < 2^23 (visit codes shift by 8).
#
# Instance row layout (cols 0..13): inv00..inv22 (row-major 3x3 of the
# object-from-world transform), invtx invty invtz, vis (int bits),
# blas_root_visit_code (int bits).
# ---------------------------------------------------------------------------

INST_ROW_BIT = 1 << 28


def build_wtlas(tlas: BVH2, inst_of_leaf: np.ndarray, inv: np.ndarray,
                inst_vis: np.ndarray, blas_list, blas_mesh_ids,
                blas_tri_base, tri_soa_packed: np.ndarray, max_leaf: int):
    """Build the unified wide two-level table.

    tlas: BVH2 over instance AABBs (max_leaf=1); ``inst_of_leaf[first]`` =
      instance index of the TLAS leaf starting at ``first``.
    inv: (I, 3, 4) object-from-world transforms; inst_vis: (I,) i32.
    blas_list: per-used-mesh BVH2 (object space, leaf codes local to the
      mesh); blas_mesh_ids: mesh id per entry; blas_tri_base: global
      leaf-order triangle offset per mesh id.
    tri_soa_packed: (T, 9) global leaf-order triangle rows.
    Returns ({"wrows_tlas": rows}, {mesh id: root visit code}, inst_base).
    """
    width = max(NODE_COLS, 11 * max_leaf, 14)
    n_inst = inv.shape[0]

    # collapse every BLAS first to learn its node and leaf row counts
    mesh_tables = {}
    for bvh, mid in zip(blas_list, blas_mesh_ids):
        leaf_codes = []

        def make_leaf(code, _lc=leaf_codes):
            _lc.append(code)
            return len(_lc) - 1

        nodes = _collapse_wide(bvh, make_leaf)
        mesh_tables[mid] = (nodes, leaf_codes, bvh.max_leaf)

    # row layout: [TLAS nodes | instance rows | mesh m nodes + leaves ...]
    tlas_leaf_ids = []

    def tlas_leaf(code):
        enc = -code - 1
        first = enc >> LEAF_COUNT_BITS
        if (enc & LEAF_COUNT_MASK) != 1:
            raise ValueError("a TLAS leaf must hold exactly one instance")
        tlas_leaf_ids.append(int(inst_of_leaf[first]))
        return len(tlas_leaf_ids) - 1

    tlas_nodes = _collapse_wide(tlas, tlas_leaf)
    n_tlas = len(tlas_nodes)
    inst_base = n_tlas
    base = inst_base + n_inst
    mesh_base = {}
    for mid, (nodes, leaf_codes, _) in mesh_tables.items():
        mesh_base[mid] = base
        base += len(nodes) + len(leaf_codes)
    total_rows = base
    if total_rows >= (1 << 23):
        raise ValueError(f"{total_rows} rows: visit codes need < 2^23")

    parts = []
    # TLAS nodes: leaf ordinal g → instance tlas_leaf_ids[g]'s row;
    # leaf_code_fn sees the whole raw codes array, so clamp before indexing
    ids = np.asarray(tlas_leaf_ids, np.int32) if tlas_leaf_ids else \
        np.zeros(1, np.int32)

    def tlas_leaf_code(g):
        gi = ids[np.clip(g, 0, ids.shape[0] - 1)]
        return -(((inst_base + gi) | INST_ROW_BIT) + 1)

    parts.append(_node_rows(tlas_nodes, width, tlas_leaf_code))
    irows = np.zeros((n_inst, width), np.float32)
    irows[:, 0:9] = inv[:, :, :3].reshape(n_inst, 9)
    irows[:, 9:12] = inv[:, :, 3]
    irows[:, 12] = inst_vis.astype(np.int32).view(np.float32)
    parts.append(irows)
    for mid, (nodes, leaf_codes, blas_max_leaf) in mesh_tables.items():
        nb = mesh_base[mid]
        leaf_base = nb + len(nodes)
        parts.append(_node_rows(
            nodes, width, lambda g: -(leaf_base + g + 1), node_base=nb,
        ))
        # leaf codes are mesh-local; shift 'first' to the global tri order
        tb = blas_tri_base[mid]
        shifted = [
            -((((((-c - 1) >> LEAF_COUNT_BITS) + tb) << LEAF_COUNT_BITS)
               | ((-c - 1) & LEAF_COUNT_MASK)) + 1)
            for c in leaf_codes
        ]
        parts.append(_tri_leaf_rows(
            shifted, tri_soa_packed, None, blas_max_leaf, width,
        ))
    rows = np.concatenate(parts)

    root_code = np.array(
        [(mesh_base[mid] << 8) | 0xFF for mid in blas_mesh_ids], np.int32
    )
    mesh_root = {mid: rc for mid, rc in zip(blas_mesh_ids, root_code)}
    return {"wrows_tlas": rows}, mesh_root, inst_base


def finish_wtlas(table: dict, inst_mesh, mesh_root, inst_base):
    """Write each instance's BLAS-root visit code into its row (col 13)."""
    rows = table["wrows_tlas"]
    for i, mid in enumerate(inst_mesh):
        rows[inst_base + i, 13] = np.int32(mesh_root[mid]).view(np.float32)
    return table
