"""Subtree slabs of a big flatten scene, for the binned trace.

A copy of ``ray_tpu.ops.traverse_pallas``'s ``pack_binned_scene`` and its
layout constants.  The BVH2 is cut into S subtrees of at most 512 node and
512 triangle rows (:func:`ray_tpu_torch.scene.bvh.partition_subtrees`), and
each subtree becomes one slab of columns, 512 entries a column, stored as
four 128-lane segments:

- ``slab_f`` (S·CF, 128) f32: columns 0-11 the node rows' child boxes
  (lo0 xyz, hi0 xyz, lo1 xyz, hi1 xyz), 12-20 the triangles' vertices
  (p0 xyz, p1 xyz, p2 xyz), then padding to CF rows;
- ``slab_i`` (S·CI, 128) i32: columns 0-1 the local child codes, 2 the
  local→global triangle map;
- ``sub_lo`` / ``sub_hi`` (S, 3) f32: each subtree's box;
- ``stack_arr``: an int8 dummy whose length is the walk's stack size
  (partition depth + 2).

Entry ``idx`` of column ``c`` of subtree ``s`` is
``slab.reshape(-1)[(s·CF + c·SUB_SEGS)·128 + idx]`` (CI for ``slab_i``).
The tables equal ``ray_tpu``'s, so ``SceneFlat.from_numpy`` carries them.

:func:`subtree_tree` derives, from ``sub_lo`` / ``sub_hi`` alone, the small
tree over the subtree boxes that the binned kernel searches for each ray's
next subtree (``ray_tpu_torch/csrc/trace_binned.cu``); it is no table of
``ray_tpu``'s.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.scene.bvh import pack_bvh_soa, partition_subtrees

LANES = 128
SUB_SEGS = 4                    # 512 rows per subtree slab
SUB_ROWS = SUB_SEGS * LANES
_F_COLS = ("lo0x", "lo0y", "lo0z", "hi0x", "hi0y", "hi0z",
           "lo1x", "lo1y", "lo1z", "hi1x", "hi1y", "hi1z")
_EMPTY = np.int32(-0x80000000)


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# slab strides, padded to a multiple of 8 rows as ray_tpu's are
CF = _ceil_to((12 + 9) * SUB_SEGS, 8)   # f32 rows: node bounds + tri verts
CI = _ceil_to(3 * SUB_SEGS, 8)          # i32 rows: codes + tri id map
# the most subtrees a binned scene may have (ray_tpu's _maybe_pack_binned)
MAX_SUBTREES = 512
# the most levels below the root of a subtree tree: the binned kernel's
# search stack (csrc/trace_binned.cu kPickStack) holds one entry a level
PICK_STACK = 16


def pack_binned_scene(bvh, tri_soa, max_rows=SUB_ROWS):
    """Partition ``bvh`` and pack its slabs (``ray_tpu``'s
    ``pack_binned_scene``).  ``tri_soa``: the leaf-order triangle columns
    (``pack_tri_soa``).  Returns a dict of numpy arrays: ``slab_f``,
    ``slab_i``, ``sub_lo``, ``sub_hi``, ``stack_arr``."""
    part = partition_subtrees(bvh, max_rows=max_rows)
    S = len(part["sub_local"])
    slab_f = np.zeros((S * CF, LANES), np.float32)
    slab_i = np.full((S * CI, LANES), _EMPTY, np.int32)
    sub_lo = np.zeros((S, 3), np.float32)
    sub_hi = np.zeros((S, 3), np.float32)
    for s, sub in enumerate(part["sub_local"]):
        cols = pack_bvh_soa(sub)
        nn = sub.child.shape[0]
        for ci, k in enumerate(_F_COLS):
            seg = np.zeros((SUB_SEGS, LANES), np.float32)
            # unhit default for far bounds: lo=0, hi=-1 (inverted, misses)
            if k.startswith("hi"):
                seg -= 1.0
            flat = seg.reshape(-1)
            flat[:nn] = cols[k]
            slab_f[s * CF + ci * SUB_SEGS:s * CF + (ci + 1) * SUB_SEGS] = (
                flat.reshape(SUB_SEGS, LANES)
            )
        ids = part["sub_tri_ids"][s]
        tc = ids.shape[0]
        for vi, k in enumerate(
            ("p0x", "p0y", "p0z", "p1x", "p1y", "p1z", "p2x", "p2y", "p2z")
        ):
            flat = np.zeros(SUB_ROWS, np.float32)
            flat[:tc] = np.asarray(tri_soa[k])[ids]
            slab_f[s * CF + (12 + vi) * SUB_SEGS:
                   s * CF + (12 + vi + 1) * SUB_SEGS] = (
                flat.reshape(SUB_SEGS, LANES)
            )
        for ci, k in enumerate(("code0", "code1")):
            flat = np.full(SUB_ROWS, _EMPTY, np.int32)
            flat[:nn] = cols[k]
            slab_i[s * CI + ci * SUB_SEGS:s * CI + (ci + 1) * SUB_SEGS] = (
                flat.reshape(SUB_SEGS, LANES)
            )
        gmap = np.zeros(SUB_ROWS, np.int32)
        gmap[:tc] = ids
        slab_i[s * CI + 2 * SUB_SEGS:s * CI + 3 * SUB_SEGS] = (
            gmap.reshape(SUB_SEGS, LANES)
        )
        sub_lo[s] = np.minimum(sub.child_lo[0, 0], sub.child_lo[0, 1])
        sub_hi[s] = np.maximum(sub.child_hi[0, 0], sub.child_hi[0, 1])
        # single-leaf subtree guard: child 1 may be an inverted empty box
        if (sub.child_hi[0, 1] < sub.child_lo[0, 1]).any():
            sub_lo[s] = sub.child_lo[0, 0]
            sub_hi[s] = sub.child_hi[0, 0]
    return {
        "slab_f": slab_f,
        "slab_i": slab_i,
        "sub_lo": sub_lo,
        "sub_hi": sub_hi,
        "stack_arr": np.zeros(int(part["depth"]) + 2, np.int8),
    }


def _area(lo, hi):
    """Surface area of boxes (..., 3); an empty extent counts as 0, a NaN
    or infinite one as infinite."""
    d = np.maximum(hi.astype(np.float64) - lo.astype(np.float64), 0.0)
    sa = 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                + d[..., 2] * d[..., 0])
    return np.where(np.isfinite(sa), sa, np.inf)


def subtree_tree(sub_lo, sub_hi, max_depth=PICK_STACK):
    """The binary tree over the S subtree boxes that the binned kernel
    searches instead of scanning all S: node ``[a, b)`` holds the sids
    ``a .. b-1`` (the partition's cut roots in depth-first order, so a range
    is a run of neighbouring subtrees) and splits at the ``m`` that
    minimises the surface-area cost ``area([a, m)) (m - a) + area([m, b))
    (b - m)`` of its two halves' boxes, among the splits that keep every
    leaf within ``max_depth`` levels of the root.

    Returns ``(tree, depth)``: ``tree`` (2S-1, 8) f32 in depth-first
    preorder — node ``k`` over ``[a, b)`` has its children at ``k+1``
    (``[a, m)``) and ``k + 2(m-a)`` (``[m, b)``) — each row a box (lo xyz,
    hi xyz), then ``m`` as int bits (0 for a leaf) and a zero pad word;
    ``depth`` the edges from the root to the deepest leaf.  A leaf (one
    sid) is that subtree's box, bit for bit; an inner node's box is the
    componentwise ``min(min(lo, hi))`` / ``max(max(lo, hi))`` of its
    members (NaN-ignoring, exact in float32), so every member's slab
    interval lies inside the node's for any ray.  Raises ``ValueError`` when
    ``max_depth`` levels cannot hold S leaves."""
    sub_lo = np.asarray(sub_lo, np.float32).reshape(-1, 3)
    sub_hi = np.asarray(sub_hi, np.float32).reshape(-1, 3)
    S = sub_lo.shape[0]
    if S < 1 or sub_hi.shape != sub_lo.shape:
        raise ValueError(f"subtree boxes of shapes {sub_lo.shape} and "
                         f"{sub_hi.shape}")
    need = int(np.ceil(np.log2(S))) if S > 1 else 0
    if need > max_depth:
        raise ValueError(f"a tree over {S} subtree boxes is at least {need} "
                         f"deep; the binned kernel's search stack holds "
                         f"{max_depth}")
    lo = np.fmin(sub_lo, sub_hi)
    hi = np.fmax(sub_lo, sub_hi)
    tree = np.zeros((2 * S - 1, 8), np.float32)
    split = tree.view(np.int32)[:, 6]
    depth = 0
    todo = [(0, 0, S, 0)]
    while todo:
        k, a, b, d = todo.pop()
        depth = max(depth, d)
        if b - a == 1:
            tree[k, 0:3] = sub_lo[a]
            tree[k, 3:6] = sub_hi[a]
            continue
        tree[k, 0:3] = np.fmin.reduce(lo[a:b], axis=0)
        tree[k, 3:6] = np.fmax.reduce(hi[a:b], axis=0)
        # the boxes of [a, m) and [m, b) for every m in (a, b)
        left = (np.fmin.accumulate(lo[a:b - 1]), np.fmax.accumulate(hi[a:b - 1]))
        right = (np.fmin.accumulate(lo[b - 1:a:-1])[::-1],
                 np.fmax.accumulate(hi[b - 1:a:-1])[::-1])
        n_left = np.arange(1, b - a)
        cost = _area(*left) * n_left + _area(*right) * (b - a - n_left)
        # both halves must fit in the levels left below this node
        room = 1 << (max_depth - d - 1)
        fits = (n_left <= room) & (b - a - n_left <= room)
        best = np.flatnonzero(fits & (cost == cost[fits].min()))
        # among equal costs the split nearest the middle
        m = a + int(best[np.argmin(np.abs(2 * n_left[best] - (b - a)))]) + 1
        split[k] = m
        todo += [(k + 1, a, m, d + 1), (k + 2 * (m - a), m, b, d + 1)]
    return tree, depth
