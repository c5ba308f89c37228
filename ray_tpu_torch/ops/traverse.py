"""Ray traversal entry points and the trace kernels' wrappers.

The port of ``ray_tpu.ops.traverse``'s ``trace_closest_soa`` /
``trace_occlusion_soa``, routed as ``ray_tpu``'s ``_pallas_mode`` routes
on a TPU and in the dispatch order of ``_trace_closest_soa_jit``
(:func:`_trace_mode`):

* ≤ 40 triangles → :func:`trace_brute` (``trace_brute_pallas``);
* max(nodes, triangles) ≤ 512 → :func:`trace_bvh` (``trace_bvh_pallas``),
  a per-ray stack walk of the BVH2;
* a scene finalized with ``pallas_binned=True`` (``binned_*`` subtree
  slabs) → :func:`trace_binned` (``trace_flat_binned``), a near-to-far walk
  over the subtree slabs;
* any other scene with the 8-wide table ``wrows`` → :func:`trace_wide`
  (``_traverse_wide``), which is the two-level walk on a table without
  instance rows and runs as :func:`trace_tlas`;
* a larger scene without ``wrows`` → :func:`trace_bvh` (``_traverse``, the
  same BVH2 walk: the 512-row cap is a TPU's VMEM, not semantics).

A trace with per-triangle visibility (``tri_vis`` and the rays' type bits
``ray_mask``) routes as ``ray_tpu``'s ``mode=None`` does: the masked wide
walk when the scene has ``wrows``, else the masked BVH2 walk, whatever the
triangle count (the brute and binned kernels never see a mask).

Two-level scenes go through ``trace_closest_tlas`` /
``trace_occlusion_tlas``: one that carries the unified 8-wide table
``wrows_tlas`` to :func:`trace_tlas` (``trace_tlas_pallas``), one without
it (≤ 256 unique triangles) to :func:`trace_tlas_bin`, the binary
two-level walk ``_traverse_tlas`` over the BVH2 node and triangle tables
and the instance columns.

Each wrapper launches its hand-written kernel
(``ray_tpu_torch/csrc/trace_{brute,bvh,tlas,tlas_bin,binned}.cu``) on a
CUDA tensor, or raises; on a CPU tensor it runs its plain PyTorch version
(:func:`trace_brute_plain`, :func:`trace_bvh_plain`,
:func:`trace_tlas_plain`, :func:`trace_tlas_bin_plain`,
:func:`trace_binned_plain`) — the same arithmetic in the same expression
order, the executable spec each kernel is held to bit for bit on the card.
The array-of-structs wrappers :func:`trace_closest`,
:func:`trace_occlusion` and the O(R·T) spec :func:`trace_closest_brute`
are ``ray_tpu``'s test helpers, in plain PyTorch.

Traversal is a discrete decision procedure: hits come back detached
(``prim`` int32, ``backface`` bool) and shading re-derives differentiable
hit attributes from the scene tables.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import torch

from ray_tpu_torch.ops import cuda_build
from ray_tpu_torch.scene.binned import (
    CF,
    CI,
    MAX_SUBTREES,
    PICK_STACK,
    SUB_ROWS,
    SUB_SEGS,
    subtree_tree,
)
from ray_tpu_torch.scene.bvh import (
    LEAF_COUNT_BITS,
    LEAF_COUNT_MASK,
    MAX_STACK_SIZE,
)
from ray_tpu_torch.scene.wbvh import INST_ROW_BIT, NODE_COLS


class Hit(NamedTuple):
    """Closest-hit record (SoA over rays)."""

    t: torch.Tensor          # f32, distance (t_max if miss)
    prim: torch.Tensor       # i32, triangle index in leaf order (-1 = miss)
    u: torch.Tensor          # f32 barycentric of vertex 1
    v: torch.Tensor          # f32 barycentric of vertex 2
    backface: torch.Tensor   # bool


class HitInst(NamedTuple):
    """Two-level hit record: :class:`Hit` plus the instance index."""

    t: torch.Tensor
    prim: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    backface: torch.Tensor
    inst: torch.Tensor       # i32 instance index (-1 = miss)


# ray_tpu's brute-force threshold (ops/traverse.py _PALLAS_BRUTE_MAX); the
# kernel's shared-memory triangle buffer holds this many
BRUTE_MAX_TRIS = 40
# ray_tpu's BVH-kernel limit (ops/traverse_pallas.py T_MAX_BVH): where its
# router stops sending a scene to the BVH2 kernel (routing only: the port's
# BVH2 kernel reads its rows from global memory and takes any table)
BVH_MAX_ROWS = 512
# the BVH2 kernel's table limit: a leaf code holds first << 4 | count
BVH_MAX_TABLE_ROWS = 1 << 27
# stack-empty sentinel (never a valid child code)
EMPTY = -0x80000000
# two-level walk: popping it brings back the world-space ray
RESTORE = -0x7ffffffe
# every ray type (instance visibility masks are tested against it)
FULL_RAY_MASK = 0x7fffffff
# TLAS leaf marker inside the binary two-level code space (ray_tpu
# ops/traverse.py INST_LEAF_FLAG)
INST_LEAF_FLAG = 1 << 28
# slab-test slack: f32 1 + 2 ulp (ray_tpu ops/traverse.py _aabb_c)
SLAB_SLACK = 1.00000024
# the binned walk's "no subtree yet" entry distance: jnp.float32(3.4e38)
BINNED_BIG = 3.4e38
INT32_MAX = 0x7FFFFFFF


def _trace_mode(n_nodes: int, n_tris: int, has_binned: bool = False,
                has_wide: bool = False) -> str:
    """``ray_tpu``'s ``_pallas_mode`` on a TPU, and the dispatch order of
    ``_trace_closest_soa_jit``: brute, bvh, binned, then the 8-wide walk,
    and without it the BVH2 walk (``_traverse``) at any size."""
    if n_tris <= BRUTE_MAX_TRIS:
        return "brute"
    if max(n_nodes, n_tris) <= BVH_MAX_ROWS:
        return "bvh"
    if has_binned:
        return "binned"
    if has_wide:
        return "wide"
    return "bvh"


def trace_brute_plain(tris, ro, rd, t_min, t_max, active, any_hit=False) -> Hit:
    """Every ray against every triangle, in plain PyTorch: a loop over the
    (T, 9) packed triangle rows with ``_brute_kernel``'s expression order
    (ray_tpu/ops/traverse_pallas.py:72-103).  Any-hit takes the first
    passing triangle (the kernel stops there)."""
    e1 = tris[:, 3:6] - tris[:, 0:3]
    e2 = tris[:, 6:9] - tris[:, 0:3]
    rows = torch.cat([tris[:, 0:3], e1, e2], dim=1).tolist()
    rox, roy, roz = ro[:, 0], ro[:, 1], ro[:, 2]
    rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
    t_best = t_max.clone()
    prim = torch.full(t_max.shape, -1, dtype=torch.int32, device=ro.device)
    u_b = torch.zeros_like(t_max)
    v_b = torch.zeros_like(t_max)
    bf = torch.zeros(t_max.shape, dtype=torch.bool, device=ro.device)
    one = torch.ones_like(t_max)
    for k, (p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z) in enumerate(rows):
        pvx = rdy * e2z - rdz * e2y
        pvy = rdz * e2x - rdx * e2z
        pvz = rdx * e2y - rdy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        valid_det = det != 0.0
        inv_det = torch.reciprocal(torch.where(valid_det, det, one))
        tvx = rox - p0x
        tvy = roy - p0y
        tvz = roz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        upper = t_max if any_hit else t_best
        hit = (
            valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > t_min) & (t < upper) & active
        )
        if any_hit:
            hit = hit & (prim < 0)
        t_best = torch.where(hit, t, t_best)
        prim = torch.where(hit, torch.full_like(prim, k), prim)
        u_b = torch.where(hit, u, u_b)
        v_b = torch.where(hit, v, v_b)
        bf = torch.where(hit, det < 0.0, bf)
    return Hit(t=t_best, prim=prim, u=u_b, v=v_b, backface=bf)


def _safe_inv(v):
    tiny = torch.where(v >= 0.0, 1e-7, -1e-7)
    return torch.reciprocal(torch.where(torch.abs(v) > 1e-7, v, tiny))


def _aabb_c(ox, oy, oz, ix, iy, iz, lox, loy, loz, hix, hiy, hiz, t_min,
            t_max):
    """Slab test (ray_tpu ``_aabb_c``). Returns (hit, t_near); min/max
    propagate NaN, as ``jnp.minimum``/``maximum`` do."""
    tx0 = (lox - ox) * ix
    tx1 = (hix - ox) * ix
    ty0 = (loy - oy) * iy
    ty1 = (hiy - oy) * iy
    tz0 = (loz - oz) * iz
    tz1 = (hiz - oz) * iz
    tn = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.maximum(torch.minimum(tz0, tz1), t_min),
    )
    tf = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.minimum(torch.maximum(tz0, tz1), t_max),
    )
    return tn <= tf * SLAB_SLACK, tn


def _tri_c(ox, oy, oz, dx, dy, dz, trow, t_min, t_max):
    """Möller–Trumbore against (R, 9) packed rows (ray_tpu ``_tri_c``).
    Returns (hit, t, u, v, backface)."""
    p0x, p0y, p0z = trow[:, 0], trow[:, 1], trow[:, 2]
    e1x, e1y, e1z = trow[:, 3] - p0x, trow[:, 4] - p0y, trow[:, 5] - p0z
    e2x, e2y, e2z = trow[:, 6] - p0x, trow[:, 7] - p0y, trow[:, 8] - p0z
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    valid_det = det != 0.0
    inv_det = torch.reciprocal(torch.where(valid_det, det, 1.0))
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (
        valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min) & (t < t_max)
    )
    return hit, t, u, v, det < 0.0


def trace_bvh_plain(nodes, tris, ro, rd, t_min, t_max, active, max_leaf,
                    stack_size, any_hit=False, work=None, tri_vis=None,
                    ray_mask=None) -> Hit:
    """BVH2 walk in plain PyTorch: the tensor port of ``ray_tpu``'s
    ``_traverse`` (ops/traverse.py:118-233), which is bit-identical to its
    Pallas kernel ``_bvh_kernel``.

    Every ray holds a cursor ``cur`` and an (S, R) stack of deferred far
    children.  A step retires one node or one leaf per ray and folds the
    following pop into the same step.  A node tests both child boxes
    against the running ``t``, descends into the near child (``t0 <= t1``
    on the entry distances, hit or not) and pushes the far child only when
    both are hit.  A push at ``sp >= S`` is dropped but still counts, and
    its pop yields EMPTY; the lane then goes on popping in the next steps
    until it finds an entry or its stack is empty.  (In ``_traverse`` such a
    lane goes on popping only while some other lane of the batch still
    walks; here it always does, so a ray's result does not depend on the
    batch, as it cannot in a kernel that runs one ray per thread.  Without
    overflow the two loops are the same.)  A leaf tests its first
    ``min(count, max_leaf)``
    triangles.  Any-hit tests against ``t_max``, so a later passing
    triangle of the leaf overwrites an earlier one, and the walk ends after
    that leaf.

    With per-ray-type visibility (``_traverse``'s ``tri_vis`` path,
    ray_tpu/ops/traverse.py:195-198) a leaf slot is tested only when its
    triangle's mask meets the ray's: ``(tri_vis[tri] & ray_mask) != 0``.

    ``nodes``: (N, 14) f32 packed rows (child 0 box, child 1 box, both
    child codes as int bits); ``tris``: (T, 9) f32; ``tri_vis``: None or
    (T,) i32, with ``ray_mask`` (R,) i32 (None: every ray type).
    ``work``: optional dict; node steps and triangle tests are added to its
    ``"node_steps"`` / ``"tri_tests"``."""
    R = ro.shape[0]
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    ray = (ro[:, 0], ro[:, 1], ro[:, 2], dx, dy, dz,
           _safe_inv(dx), _safe_inv(dy), _safe_inv(dz), t_min, t_max)
    hit = (t_max.clone(),
           torch.full((R,), -1, dtype=torch.int32, device=ro.device),
           torch.zeros_like(t_max), torch.zeros_like(t_max),
           torch.zeros((R,), dtype=torch.bool, device=ro.device))
    nodes = nodes.contiguous()
    vis = None
    if tri_vis is not None:
        vis = (tri_vis, _full_mask(ray_mask, R, ro.device))
    return Hit(*_walk_bvh2(nodes, nodes.view(torch.int32)[:, 12:14], tris,
                           None, None, ray, hit, active, max_leaf,
                           stack_size, any_hit, work, vis))


def _full_mask(ray_mask, R, device):
    """``ray_mask``, or every ray type for each of R rays when None."""
    if ray_mask is not None:
        return ray_mask
    return torch.full((R,), FULL_RAY_MASK, dtype=torch.int32, device=device)


def _walk_bvh2(nodes, codes, tris, base, prim_map, ray, hit, walk, max_leaf,
               stack_size, any_hit, work, vis=None):
    """The BVH2 stack walk of :func:`trace_bvh_plain` (its docstring states
    the semantics), from the root for the lanes ``walk``, continuing the
    hit record ``hit`` = (t, prim, u, v, backface).

    ``nodes`` (N, ≥ 12) f32 child boxes and ``codes`` (N, 2) i32 child
    codes, ``tris`` (T, 9) f32; ``ray`` = (ox, oy, oz, dx, dy, dz, ix, iy,
    iz, t_min, t_max), each (R,).  ``base``: None, or an (R,) int64 row
    offset added to every node and triangle index (the lane's subtree slab
    in :func:`trace_binned_plain`); ``prim_map``: None (``prim`` is the
    triangle's row) or a table mapping the row to the ``prim`` recorded;
    ``vis``: None or (tri_vis (T,) i32, ray_mask (R,) i32)."""
    ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min, t_max = ray
    t_best, prim, u_b, v_b, bf = hit
    R = ox.shape[0]
    device = ox.device
    S = int(stack_size)
    lanes = torch.arange(R, device=device)

    stack = torch.full((S, R), EMPTY, dtype=torch.int32, device=device)
    sp = torch.zeros((R,), dtype=torch.int32, device=device)
    cur = torch.where(walk, 0, EMPTY).to(torch.int32)
    empty = torch.full_like(cur, EMPTY)
    if work is not None:
        work.setdefault("node_steps", 0)
        work.setdefault("tri_tests", 0)

    while bool(((cur != EMPTY) | (sp > 0)).any()):
        is_node = cur >= 0
        is_leaf = (cur < 0) & (cur != EMPTY)
        node = torch.where(is_node, cur, 0).long()
        if base is not None:
            node = node + base

        nrow = nodes[node]
        h0, t0 = _aabb_c(ox, oy, oz, ix, iy, iz, nrow[:, 0], nrow[:, 1],
                         nrow[:, 2], nrow[:, 3], nrow[:, 4], nrow[:, 5],
                         t_min, t_best)
        h1, t1 = _aabb_c(ox, oy, oz, ix, iy, iz, nrow[:, 6], nrow[:, 7],
                         nrow[:, 8], nrow[:, 9], nrow[:, 10], nrow[:, 11],
                         t_min, t_best)
        c0, c1 = codes[node, 0], codes[node, 1]
        near_is_0 = t0 <= t1
        near_code = torch.where(near_is_0, c0, c1)
        far_code = torch.where(near_is_0, c1, c0)
        near_hit = torch.where(near_is_0, h0, h1) & is_node
        far_hit = torch.where(near_is_0, h1, h0) & is_node

        # descend near; defer far only when both children are hit
        push = near_hit & far_hit
        w = push & (sp < S)
        stack[sp[w].long(), lanes[w]] = far_code[w]
        sp = sp + push.to(torch.int32)
        from_node = torch.where(near_hit, near_code,
                                torch.where(far_hit, far_code, empty))

        leaf_v = -torch.where(is_leaf, cur, -1) - 1
        first = leaf_v >> LEAF_COUNT_BITS
        count = leaf_v & LEAF_COUNT_MASK
        for k in range(max_leaf):
            valid = is_leaf & (k < count)
            tri = torch.where(valid, first + k, 0)
            row = tri.long() if base is None else tri.long() + base
            if vis is not None:
                valid = valid & ((vis[0][row] & vis[1]) != 0)
            th, tt, tu, tv, tb = _tri_c(
                ox, oy, oz, dx, dy, dz, tris[row], t_min,
                t_max if any_hit else t_best)
            take = th & valid
            t_best = torch.where(take, tt, t_best)
            prim = torch.where(take, tri if prim_map is None
                               else prim_map[row], prim)
            u_b = torch.where(take, tu, u_b)
            v_b = torch.where(take, tv, v_b)
            bf = torch.where(take, tb, bf)
            if work is not None:
                work["tri_tests"] += int(valid.sum())
        if work is not None:
            work["node_steps"] += int(is_node.sum())

        next_cur = torch.where(is_node, from_node, empty)
        if any_hit:
            done = prim >= 0
            sp = torch.where(done, 0, sp)
            next_cur = torch.where(done, empty, next_cur)

        # pop where exhausted; a slot at or past S was never written
        need_pop = (next_cur == EMPTY) & (sp > 0)
        top = sp - 1
        popped = torch.where(top < S, stack[top.clamp(0, S - 1).long(), lanes],
                             empty)
        cur = torch.where(need_pop, popped, next_cur)
        sp = torch.where(need_pop, sp - 1, sp)
    return t_best, prim, u_b, v_b, bf


def tlas_width(max_leaf: int) -> int:
    """Row width of ``wrows_tlas`` (``build_wtlas``) for ``max_leaf``."""
    return max(NODE_COLS, 11 * max_leaf, 14)


def trace_tlas_plain(rows, winst_base, ro, rd, t_min, t_max, active,
                     ray_mask, max_leaf, stack_size, any_hit=False,
                     work=None, has_vis=False) -> HitInst:
    """Two-level 8-wide walk in plain PyTorch: the tensor port of
    ``ray_tpu``'s ``_traverse_wide_tlas`` (ops/traverse.py:370-539), which
    is bit-identical to its Pallas kernel ``_tlas_kernel``.

    ``rows``: the (N, W) f32 unified table ``wrows_tlas`` (TLAS nodes,
    instance rows, then each mesh's nodes and leaf rows; codes, visibility
    masks, root codes and prims ride as int bits).  Every ray holds a
    cursor ``cur`` and an (S, R) stack.  A step reads the row ``cur`` names
    and interprets it as a wide node (descend into the nearest hit child by
    strict ``<`` — ``jnp.argmin`` — and push the other hit children as one
    resume code), an instance row (when its visibility mask meets
    ``ray_mask``: push RESTORE, move the ray into object space unnormalised
    and descend into the mesh root) or a triangle leaf row (the leaf's
    nearest hit by strict ``<`` replaces the ray's hit when nearer); RESTORE
    brings back the world ray.  The following pop is folded into the same
    step.  Node boxes are tested against the running ``t``, triangles
    against it (closest hit) or ``t_max`` (any hit, which ends the walk at
    the first leaf that hits).  A push at ``sp >= S`` is dropped but still
    counts, and its pop yields EMPTY; the lane then pops on until it finds
    an entry or its stack is empty (``_traverse_wide_tlas`` goes on popping
    only while another lane of the batch still walks — ROADMAP Queue 3).

    ``ray_mask``: (R,) i32 or None (every ray type).  ``has_vis``: the
    flatten walk with per-triangle visibility (``_traverse_wide``'s
    ``has_vis``, ray_tpu/ops/traverse.py:326-331): a leaf slot counts only
    when its visibility column (10·L … 11·L) meets ``ray_mask``.  Columns
    past ``tlas_width(max_leaf)`` (a padded table) are never read.  Returns
    a :class:`HitInst` whose ``inst`` is the instance index (the instance
    row less ``winst_base``; -1 on a miss).  ``work``: optional dict; node
    steps, instance entries and triangle tests are added to its
    ``"node_steps"`` / ``"inst_entries"`` / ``"tri_tests"``."""
    R = ro.shape[0]
    device = ro.device
    S = int(stack_size)
    L = int(max_leaf)
    rows = rows.contiguous()
    rows_i = rows.view(torch.int32)
    wox, woy, woz = ro[:, 0], ro[:, 1], ro[:, 2]
    wdx, wdy, wdz = rd[:, 0], rd[:, 1], rd[:, 2]
    wix, wiy, wiz = _safe_inv(wdx), _safe_inv(wdy), _safe_inv(wdz)
    ray_mask = _full_mask(ray_mask, R, device)
    lanes = torch.arange(R, device=device)
    i8 = torch.arange(8, dtype=torch.int32, device=device)
    bit8 = torch.ones_like(i8) << i8
    empty = torch.full((R,), EMPTY, dtype=torch.int32, device=device)
    inf = torch.tensor(float("inf"), device=device)

    stack = torch.full((S, R), EMPTY, dtype=torch.int32, device=device)
    sp = torch.zeros((R,), dtype=torch.int32, device=device)
    cur = torch.where(active, 0xFF, EMPTY).to(torch.int32)
    cur_inst = torch.zeros((R,), dtype=torch.int32, device=device)
    ox, oy, oz, dx, dy, dz, ix, iy, iz = (wox, woy, woz, wdx, wdy, wdz,
                                          wix, wiy, wiz)
    t_best = t_max.clone()
    prim = torch.full((R,), -1, dtype=torch.int32, device=device)
    u_b = torch.zeros_like(t_max)
    v_b = torch.zeros_like(t_max)
    bf = torch.zeros((R,), dtype=torch.bool, device=device)
    inst = torch.full((R,), -1, dtype=torch.int32, device=device)
    if work is not None:
        for k in ("node_steps", "inst_entries", "tri_tests"):
            work.setdefault(k, 0)

    while bool(((cur != EMPTY) | (sp > 0)).any()):
        is_node = cur >= 0
        neg = (cur < 0) & (cur != EMPTY) & (cur != RESTORE)
        is_restore = cur == RESTORE
        v = torch.where(neg, -cur - 1, 0)
        is_inst = neg & ((v & INST_ROW_BIT) != 0)
        is_tri = neg & (~is_inst)
        node = torch.where(is_node, cur >> 8, 0)
        mask = torch.where(is_node, cur & 0xFF, 0)
        ridx = torch.where(is_node, node, v & (INST_ROW_BIT - 1)).long()
        row = rows[ridx]                     # (R, W)
        row_i = rows_i[ridx]

        # ---- wide-node reading (current-space ray) ----
        codes8 = row_i[:, 48:56]
        in_mask = ((mask[:, None] >> i8) & 1) != 0
        h8, t8 = _aabb_c(
            ox[:, None], oy[:, None], oz[:, None],
            ix[:, None], iy[:, None], iz[:, None],
            row[:, 0:8], row[:, 8:16], row[:, 16:24],
            row[:, 24:32], row[:, 32:40], row[:, 40:48],
            t_min[:, None], t_best[:, None],
        )
        ok8 = h8 & in_mask & (codes8 != EMPTY) & is_node[:, None]
        t8m = torch.where(ok8, t8, inf)
        best_i = torch.argmin(t8m, dim=1)   # the first minimum
        hit_any = ok8.any(dim=1)
        best_code = codes8.gather(1, best_i[:, None])[:, 0]
        not_best = i8[None, :] != best_i[:, None]
        rem = torch.where(ok8 & not_best, bit8, 0).sum(dim=1).to(torch.int32)
        resume = (node << 8) | rem
        push_node = is_node & hit_any & (rem != 0)
        from_node = torch.where(is_node & hit_any, best_code, empty)

        # ---- instance-row reading: visibility, then enter the mesh ----
        ivis = row_i[:, 12]
        iroot = row_i[:, 13]
        enter = is_inst & ((ivis & ray_mask) != 0)
        eox = row[:, 0] * wox + row[:, 1] * woy + row[:, 2] * woz + row[:, 9]
        eoy = row[:, 3] * wox + row[:, 4] * woy + row[:, 5] * woz + row[:, 10]
        eoz = row[:, 6] * wox + row[:, 7] * woy + row[:, 8] * woz + row[:, 11]
        edx = row[:, 0] * wdx + row[:, 1] * wdy + row[:, 2] * wdz
        edy = row[:, 3] * wdx + row[:, 4] * wdy + row[:, 5] * wdz
        edz = row[:, 6] * wdx + row[:, 7] * wdy + row[:, 8] * wdz
        ii = v & (INST_ROW_BIT - 1)

        # ---- push: node resume or RESTORE marker ----
        push = push_node | enter
        push_val = torch.where(enter, RESTORE, resume).to(torch.int32)
        w = push & (sp < S)
        stack[sp[w].long(), lanes[w]] = push_val[w]
        sp = sp + push.to(torch.int32)

        # ---- current-space ray (enter → object, restore → world) ----
        def pick(e_val, w_val, cur_val):
            return torch.where(enter, e_val,
                               torch.where(is_restore, w_val, cur_val))

        ox, oy, oz = pick(eox, wox, ox), pick(eoy, woy, oy), pick(eoz, woz, oz)
        dx, dy, dz = pick(edx, wdx, dx), pick(edy, wdy, dy), pick(edz, wdz, dz)
        ix = pick(_safe_inv(edx), wix, ix)
        iy = pick(_safe_inv(edy), wiy, iy)
        iz = pick(_safe_inv(edz), wiz, iz)
        cur_inst = torch.where(enter, ii, cur_inst)

        # ---- triangle-leaf reading (object-space ray, world-metric t) ----
        th, tt, tu, tv, tb = _tri_c(
            ox[:, None], oy[:, None], oz[:, None],
            dx[:, None], dy[:, None], dz[:, None],
            row[:, 0:9 * L].reshape(R, 9, L), t_min[:, None],
            (t_max if any_hit else t_best)[:, None],
        )
        prim4 = row_i[:, 9 * L:10 * L]
        valid4 = is_tri[:, None] & (prim4 >= 0)
        if has_vis:
            valid4 = valid4 & ((row_i[:, 10 * L:11 * L] & ray_mask[:, None])
                               != 0)
        hit4 = th & valid4
        tt4 = torch.where(hit4, tt, inf)
        k_best = torch.argmin(tt4, dim=1)[:, None]
        any4 = hit4.any(dim=1)
        lt = tt4.gather(1, k_best)[:, 0]
        take = any4 & (lt < t_best)
        t_best = torch.where(take, lt, t_best)
        prim = torch.where(take, prim4.gather(1, k_best)[:, 0], prim)
        u_b = torch.where(take, tu.gather(1, k_best)[:, 0], u_b)
        v_b = torch.where(take, tv.gather(1, k_best)[:, 0], v_b)
        bf = torch.where(take, tb.gather(1, k_best)[:, 0], bf)
        inst = torch.where(take, cur_inst, inst)
        if work is not None:
            work["node_steps"] += int(is_node.sum())
            work["inst_entries"] += int(enter.sum())
            work["tri_tests"] += int(valid4.sum())

        next_cur = torch.where(is_node, from_node,
                               torch.where(enter, iroot, empty))
        if any_hit:
            done = prim >= 0
            sp = torch.where(done, 0, sp)
            next_cur = torch.where(done, empty, next_cur)

        # pop where exhausted; a slot at or past S was never written
        need_pop = (next_cur == EMPTY) & (sp > 0)
        top = sp - 1
        popped = torch.where(top < S, stack[top.clamp(0, S - 1).long(), lanes],
                             empty)
        cur = torch.where(need_pop, popped, next_cur)
        sp = torch.where(need_pop, sp - 1, sp)

    inst = torch.where(prim >= 0, inst - int(winst_base), -1).to(torch.int32)
    return HitInst(t=t_best, prim=prim, u=u_b, v=v_b, backface=bf, inst=inst)


# the instance columns the binary two-level walk reads, in the order of the
# kernel's 16-float instance rows (then vis and blas_root as int bits)
INST_XFORM_COLS = ("inv00", "inv01", "inv02", "inv10", "inv11", "inv12",
                   "inv20", "inv21", "inv22", "invtx", "invty", "invtz")


def trace_tlas_bin_plain(nodes, tris, inst, ro, rd, t_min, t_max, active,
                         ray_mask, max_leaf, stack_size, any_hit=False,
                         work=None) -> HitInst:
    """Binary two-level walk in plain PyTorch: the tensor port of
    ``ray_tpu``'s ``_traverse_tlas`` (ops/traverse.py:844-986), which it
    runs for tlas scenes without ``wrows_tlas`` (≤ 256 unique triangles).

    ``nodes``: the tlas finalize's (N, 14) packed BVH2 rows — the TLAS
    first, then every mesh's BVH, child codes pre-offset, a TLAS leaf the
    code ``-((INST_LEAF_FLAG | instance) + 1)``; ``tris``: the (T, 9)
    object-space triangles; ``inst``: the instance columns (``vis``,
    ``blas_root``, ``inv00`` … ``inv22``, ``invtx`` … ``invtz``).

    Every ray holds a cursor ``cur``, the instance it is in and an (S, R)
    stack.  A node step is :func:`trace_bvh_plain`'s: both child boxes
    against [t_min, t_best] in the current-space ray, the near child by
    ``t0 <= t1``, the far one pushed when both are hit.  An instance leaf
    whose ``vis`` meets ``ray_mask`` pushes RESTORE, moves the ray into
    object space — origin ``((inv·0 x + inv·1 y) + inv·2 z) + invt``,
    direction the same without ``invt`` and not renormalised, so t stays
    world-metric — takes ``_safe_inv`` of the new direction and descends
    into ``blas_root``.  A triangle leaf tests its first ``min(count,
    max_leaf)`` slots against t_best (closest hit) or t_max (any hit, where
    the last passing slot wins and the walk ends after the leaf), recording
    the current instance with each take.  RESTORE brings back the world
    ray.  The following pop is folded into each step; overflow pops on, as
    in :func:`trace_bvh_plain` (ROADMAP Queue 3).

    ``ray_mask``: (R,) i32 or None (every ray type).  Returns a
    :class:`HitInst` (``inst`` -1 on a miss).  ``work``: optional dict;
    node steps, instance entries and triangle tests are added to its
    ``"node_steps"`` / ``"inst_entries"`` / ``"tri_tests"``."""
    R = ro.shape[0]
    device = ro.device
    S = int(stack_size)
    nodes = nodes.contiguous()
    codes = nodes.view(torch.int32)[:, 12:14]
    wox, woy, woz = ro[:, 0], ro[:, 1], ro[:, 2]
    wdx, wdy, wdz = rd[:, 0], rd[:, 1], rd[:, 2]
    wix, wiy, wiz = _safe_inv(wdx), _safe_inv(wdy), _safe_inv(wdz)
    ray_mask = _full_mask(ray_mask, R, device)
    lanes = torch.arange(R, device=device)
    empty = torch.full((R,), EMPTY, dtype=torch.int32, device=device)

    stack = torch.full((S, R), EMPTY, dtype=torch.int32, device=device)
    sp = torch.zeros((R,), dtype=torch.int32, device=device)
    cur = torch.where(active, 0, EMPTY).to(torch.int32)
    cur_inst = torch.zeros((R,), dtype=torch.int32, device=device)
    ox, oy, oz, dx, dy, dz, ix, iy, iz = (wox, woy, woz, wdx, wdy, wdz,
                                          wix, wiy, wiz)
    t_best = t_max.clone()
    prim = torch.full((R,), -1, dtype=torch.int32, device=device)
    u_b = torch.zeros_like(t_max)
    v_b = torch.zeros_like(t_max)
    bf = torch.zeros((R,), dtype=torch.bool, device=device)
    inst_b = torch.full((R,), -1, dtype=torch.int32, device=device)
    if work is not None:
        for k in ("node_steps", "inst_entries", "tri_tests"):
            work.setdefault(k, 0)

    while bool(((cur != EMPTY) | (sp > 0)).any()):
        is_node = cur >= 0
        leafish = (cur < 0) & (cur != EMPTY) & (cur != RESTORE)
        v = torch.where(leafish, -cur - 1, 0)
        is_inst = leafish & ((v & INST_LEAF_FLAG) != 0)
        is_tri = leafish & (~is_inst)
        is_restore = cur == RESTORE
        node = torch.where(is_node, cur, 0).long()

        # ---- internal node (TLAS or mesh BVH, current-space ray) ----
        nrow = nodes[node]
        h0, t0 = _aabb_c(ox, oy, oz, ix, iy, iz, nrow[:, 0], nrow[:, 1],
                         nrow[:, 2], nrow[:, 3], nrow[:, 4], nrow[:, 5],
                         t_min, t_best)
        h1, t1 = _aabb_c(ox, oy, oz, ix, iy, iz, nrow[:, 6], nrow[:, 7],
                         nrow[:, 8], nrow[:, 9], nrow[:, 10], nrow[:, 11],
                         t_min, t_best)
        c0, c1 = codes[node, 0], codes[node, 1]
        near_is_0 = t0 <= t1
        near_code = torch.where(near_is_0, c0, c1)
        far_code = torch.where(near_is_0, c1, c0)
        near_hit = torch.where(near_is_0, h0, h1) & is_node
        far_hit = torch.where(near_is_0, h1, h0) & is_node
        push_far = near_hit & far_hit
        from_node = torch.where(near_hit, near_code,
                                torch.where(far_hit, far_code, empty))

        # ---- instance leaf: visibility, then enter the mesh ----
        ii = torch.where(is_inst, v & (INST_LEAF_FLAG - 1), 0).long()
        enter = is_inst & ((inst["vis"][ii] & ray_mask) != 0)
        m = [inst[k][ii] for k in INST_XFORM_COLS]
        eox = m[0] * wox + m[1] * woy + m[2] * woz + m[9]
        eoy = m[3] * wox + m[4] * woy + m[5] * woz + m[10]
        eoz = m[6] * wox + m[7] * woy + m[8] * woz + m[11]
        edx = m[0] * wdx + m[1] * wdy + m[2] * wdz
        edy = m[3] * wdx + m[4] * wdy + m[5] * wdz
        edz = m[6] * wdx + m[7] * wdy + m[8] * wdz
        from_inst = torch.where(enter, inst["blas_root"][ii], empty)

        # ---- push: the far child, or RESTORE on entering ----
        push = push_far | enter
        push_val = torch.where(enter, RESTORE, far_code).to(torch.int32)
        w = push & (sp < S)
        stack[sp[w].long(), lanes[w]] = push_val[w]
        sp = sp + push.to(torch.int32)

        # ---- current-space ray (enter → object, restore → world) ----
        def pick(e_val, w_val, cur_val):
            return torch.where(enter, e_val,
                               torch.where(is_restore, w_val, cur_val))

        ox, oy, oz = pick(eox, wox, ox), pick(eoy, woy, oy), pick(eoz, woz, oz)
        dx, dy, dz = pick(edx, wdx, dx), pick(edy, wdy, dy), pick(edz, wdz, dz)
        ix = pick(_safe_inv(edx), wix, ix)
        iy = pick(_safe_inv(edy), wiy, iy)
        iz = pick(_safe_inv(edz), wiz, iz)
        cur_inst = torch.where(enter, ii.to(torch.int32), cur_inst)

        # ---- triangle leaf (object-space ray, world-metric t) ----
        leaf_v = -torch.where(is_tri, cur, -1) - 1
        first = leaf_v >> LEAF_COUNT_BITS
        count = leaf_v & LEAF_COUNT_MASK
        for k in range(max_leaf):
            valid = is_tri & (k < count)
            tri = torch.where(valid, first + k, 0)
            th, tt, tu, tv, tb = _tri_c(
                ox, oy, oz, dx, dy, dz, tris[tri.long()], t_min,
                t_max if any_hit else t_best)
            take = th & valid
            t_best = torch.where(take, tt, t_best)
            prim = torch.where(take, tri, prim)
            u_b = torch.where(take, tu, u_b)
            v_b = torch.where(take, tv, v_b)
            bf = torch.where(take, tb, bf)
            inst_b = torch.where(take, cur_inst, inst_b)
            if work is not None:
                work["tri_tests"] += int(valid.sum())
        if work is not None:
            work["node_steps"] += int(is_node.sum())
            work["inst_entries"] += int(enter.sum())

        next_cur = torch.where(is_node, from_node,
                               torch.where(enter, from_inst, empty))
        if any_hit:
            done = prim >= 0
            sp = torch.where(done, 0, sp)
            next_cur = torch.where(done, empty, next_cur)

        # pop where exhausted; a slot at or past S was never written
        need_pop = (next_cur == EMPTY) & (sp > 0)
        top = sp - 1
        popped = torch.where(top < S, stack[top.clamp(0, S - 1).long(), lanes],
                             empty)
        cur = torch.where(need_pop, popped, next_cur)
        sp = torch.where(need_pop, sp - 1, sp)
    return HitInst(t=t_best, prim=prim, u=u_b, v=v_b, backface=bf,
                   inst=inst_b)


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_inputs(kernel, tables, ro, rd, t_min, t_max, active):
    """Check that all inputs lie on one device, and on CUDA also each
    tensor's dtype, shape and contiguity.  Returns (device, R, the tables'
    row counts); the last two are None on the CPU."""
    device = ro.device
    named = (*tables, ("rd", rd, None), ("t_min", t_min, None),
             ("t_max", t_max, None), ("active", active, None))
    for name, x, _ in named:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, ro on {device}")
    if device.type == "cpu":
        return device, None, None
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CPU or CUDA, not {device}")
    R = ro.shape[0] if ro.dim() == 2 else -1
    rows = []
    for name, x, width in tables:
        n = x.shape[0] if x.dim() == 2 else -1
        _check(name, x, torch.float32, (n, width), device)
        rows.append(n)
    _check("ro", ro, torch.float32, (R, 3), device)
    _check("rd", rd, torch.float32, (R, 3), device)
    _check("t_min", t_min, torch.float32, (R,), device)
    _check("t_max", t_max, torch.float32, (R,), device)
    _check("active", active, torch.bool, (R,), device)
    return device, R, rows


def _launch(name, fn, device, R, tables, ro, rd, t_min, t_max, active,
            any_hit, *extra) -> Hit:
    """Allocate the five outputs, launch ``fn`` on the current stream and
    count the launch under ``name``."""
    out = Hit(
        t=torch.empty((R,), dtype=torch.float32, device=device),
        prim=torch.empty((R,), dtype=torch.int32, device=device),
        u=torch.empty((R,), dtype=torch.float32, device=device),
        v=torch.empty((R,), dtype=torch.float32, device=device),
        backface=torch.empty((R,), dtype=torch.bool, device=device),
    )
    if R == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *tables, ro.data_ptr(), rd.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), active.data_ptr(), R,
            out.t.data_ptr(), out.prim.data_ptr(), out.u.data_ptr(),
            out.v.data_ptr(), out.backface.data_ptr(), *extra, int(any_hit),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    cuda_build.launch_counts[
        f"{name}_anyhit" if any_hit else f"{name}_closest"] += 1
    return out


def trace_brute(tris, ro, rd, t_min, t_max, active, any_hit=False) -> Hit:
    """Brute-force trace: (T, 9) f32 packed triangles, (R, 3) f32 ``ro`` /
    ``rd``, (R,) f32 ``t_min`` / ``t_max``, (R,) bool ``active``, all
    contiguous on one device.  CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream, on the triangles'
    cached :func:`tri_rows` (built at the first launch on them)."""
    device, R, rows = _cuda_inputs("trace_brute", (("tris", tris, 9),),
                                   ro, rd, t_min, t_max, active)
    if device.type == "cpu":
        return trace_brute_plain(tris, ro, rd, t_min, t_max, active, any_hit)
    (T,) = rows
    if T > BRUTE_MAX_TRIS:
        raise ValueError(f"trace_brute takes at most {BRUTE_MAX_TRIS} "
                         f"triangles, got {T}")
    (trows,) = _brute_kernel_tables(tris)
    return _launch("trace_brute", _brute_fn(), device, R,
                   (trows.data_ptr(), T), ro, rd, t_min, t_max, active,
                   any_hit)


def trace_bvh(nodes, tris, ro, rd, t_min, t_max, active, max_leaf,
              stack_size, any_hit=False, tri_vis=None, ray_mask=None) -> Hit:
    """BVH2 trace: (N, 14) f32 packed node rows, (T, 9) f32 packed
    triangles (any N, T below 2^27: the kernel reads them from global
    memory), the rays as for :func:`trace_brute`, the scene's ``max_leaf``
    (≤ 15) and ``stack_size`` (≤ 64); optionally per-triangle visibility
    ``tri_vis`` (T,) i32 with the rays' ``ray_mask`` (R,) i32 (None: every
    ray type).  CPU tensors run :func:`trace_bvh_plain`; CUDA tensors
    launch the kernel on the current stream, on the tables' cached
    :func:`node_rows` and :func:`tri_rows` (built at the first launch on
    them; with ``tri_vis`` a second copy whose word 9 holds the mask, and
    the masked kernel, counted as ``trace_bvh_vis``)."""
    device, R, rows = _cuda_inputs(
        "trace_bvh", (("nodes", nodes, 14), ("tris", tris, 9)),
        ro, rd, t_min, t_max, active)
    for name, x in (("tri_vis", tri_vis), ("ray_mask", ray_mask)):
        if x is not None and x.device != device:
            raise ValueError(f"{name} is on {x.device}, ro on {device}")
    if device.type == "cpu":
        return trace_bvh_plain(nodes, tris, ro, rd, t_min, t_max, active,
                               max_leaf, stack_size, any_hit,
                               tri_vis=tri_vis, ray_mask=ray_mask)
    N, T = rows
    if max(N, T) >= BVH_MAX_TABLE_ROWS:
        raise ValueError(f"trace_bvh takes fewer than {BVH_MAX_TABLE_ROWS} "
                         f"node and triangle rows, got {N} and {T}")
    if not 1 <= max_leaf <= LEAF_COUNT_MASK:
        raise ValueError(f"max_leaf {max_leaf} outside [1, {LEAF_COUNT_MASK}]")
    if not 1 <= stack_size <= MAX_STACK_SIZE:
        raise ValueError(f"stack_size {stack_size} outside "
                         f"[1, {MAX_STACK_SIZE}]")
    if tri_vis is None:
        if ray_mask is not None:
            raise ValueError("trace_bvh takes a ray_mask only with tri_vis")
        nrows, trows = _bvh_kernel_tables(nodes, tris)
        return _launch("trace_bvh", _bvh_fn(), device, R,
                       (nrows.data_ptr(), N, trows.data_ptr(), T),
                       ro, rd, t_min, t_max, active, any_hit,
                       int(max_leaf), int(stack_size))
    _check("tri_vis", tri_vis, torch.int32, (T,), device)
    ray_mask = _full_mask(ray_mask, R, device)
    _check("ray_mask", ray_mask, torch.int32, (R,), device)
    nrows, trows = _bvh_vis_kernel_tables(nodes, tris, tri_vis)
    return _launch("trace_bvh_vis", _bvh_vis_fn(), device, R,
                   (nrows.data_ptr(), N, trows.data_ptr(), T),
                   ro, rd, t_min, t_max, active, any_hit,
                   int(max_leaf), int(stack_size), ray_mask.data_ptr())


def tri_rows(tris, tri_vis=None):
    """The (T, 12) f32 triangle rows the brute and BVH kernels read as
    three 16-byte loads: p0, e1 = p1 - p0, e2 = p2 - p0 (the plain
    versions' own float32 subtractions, so the same bits) and three words
    that are zero, or with ``tri_vis`` (T,) i32 the first of them the
    triangle's visibility mask as int bits, from the (T, 9) packed rows p0
    p1 p2."""
    rows = torch.zeros((tris.shape[0], 12), dtype=torch.float32,
                       device=tris.device)
    rows[:, 0:3] = tris[:, 0:3]
    rows[:, 3:6] = tris[:, 3:6] - tris[:, 0:3]
    rows[:, 6:9] = tris[:, 6:9] - tris[:, 0:3]
    if tri_vis is not None:
        rows.view(torch.int32)[:, 9] = tri_vis
    return rows


def inst_rows(inst):
    """The (I, 16) f32 instance rows the binary two-level kernel reads as
    four 16-byte loads: the object-from-world 3x3 (``inv00`` … ``inv22``,
    row-major) and translation (``invtx`` … ``invtz``), the visibility
    mask and the mesh's root code as int bits, two zero words."""
    n = inst["vis"].shape[0]
    rows = torch.zeros((n, 16), dtype=torch.float32, device=inst["vis"].device)
    for c, k in enumerate(INST_XFORM_COLS):
        rows[:, c] = inst[k]
    rows.view(torch.int32)[:, 12] = inst["vis"]
    rows.view(torch.int32)[:, 13] = inst["blas_root"]
    return rows


def node_rows(nodes):
    """The (N, 16) f32 node rows the BVH kernel reads as four 16-byte
    loads: the (N, 14) packed rows (lo0 hi0 lo1 hi1, the child codes as int
    bits) and two zero words."""
    rows = torch.zeros((nodes.shape[0], 16), dtype=torch.float32,
                       device=nodes.device)
    rows[:, 0:14] = nodes
    return rows


# the kernels' own copies of their tables, built once per source table:
# (kernel, id(first source)) -> (weak references to the sources, their
# versions, the copies)
_KERNEL_TABLES: dict = {}


def _kernel_tables(kernel, src, build):
    """``build(*src)``, made at the first launch on the tables ``src`` and
    kept while they live and are not modified in place."""
    key = (kernel, id(src[0]))
    versions = tuple(t._version for t in src)
    hit = _KERNEL_TABLES.get(key)
    if (hit is not None and all(r() is t for r, t in zip(hit[0], src))
            and hit[1] == versions):
        return hit[2]
    tables = build(*src)
    _KERNEL_TABLES[key] = (tuple(map(weakref.ref, src)), versions, tables)
    weakref.finalize(src[0], _KERNEL_TABLES.pop, key, None)
    return tables


def _brute_kernel_tables(tris):
    """(tri_rows,) of the brute kernel, cached per triangle table."""
    return _kernel_tables("trace_brute", (tris,),
                          lambda t: (tri_rows(t.contiguous()),))


def _bvh_kernel_tables(nodes, tris):
    """(node_rows, tri_rows) of the BVH kernel, cached per scene."""
    return _kernel_tables(
        "trace_bvh", (nodes, tris),
        lambda n, t: (node_rows(n.contiguous()), tri_rows(t.contiguous())))


def _bvh_vis_kernel_tables(nodes, tris, tri_vis):
    """(node_rows, tri_rows with the masks) of the masked BVH kernel,
    cached per scene beside the unmasked copy."""
    return _kernel_tables(
        "trace_bvh_vis", (nodes, tris, tri_vis),
        lambda n, t, m: (node_rows(n.contiguous()),
                         tri_rows(t.contiguous(), m.contiguous())))


def _tlas_bin_kernel_tables(nodes, tris, inst):
    """(node_rows, tri_rows, inst_rows) of the binary two-level kernel,
    cached per scene."""
    cols = tuple(inst[k] for k in ("vis", "blas_root", *INST_XFORM_COLS))

    def build(n, t, *c):
        return (node_rows(n.contiguous()), tri_rows(t.contiguous()),
                inst_rows(dict(zip(("vis", "blas_root", *INST_XFORM_COLS),
                                   c))))
    return _kernel_tables("trace_tlas_bin", (nodes, tris, *cols), build)



def _flip_sign(x, s):
    """x with its sign flipped where s's sign bit is set."""
    bits = x.view(torch.int32) ^ (s.view(torch.int32) & -0x80000000)
    return bits.view(torch.float32)


# tri_test.cuh's pre-test constants
PRETEST_TINY = 2.0 ** -60
PRETEST_SLACK = 1.0 + 2.0 ** -10


def tri_pretest_plain(rows, ro, rd, t_min, upper):
    """The divide-free pre-test of the brute and BVH kernels
    (``csrc/tri_test.cuh``, whose comment gives the argument), lane by
    lane: (R, 12) :func:`tri_rows`, (R, 3) ``ro`` / ``rd``, (R,) ``t_min``
    and ``upper`` (t_best, or t_max for any hit).  Returns (R,) bool: False
    where a rule rejects the pair, which must only happen where the full
    test (``trace_brute_plain``'s) fails.  Used by no path: the kernels run
    it, the tests hold it against the full test."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = rows[:, 0:9].unbind(1)
    dx, dy, dz = rd.unbind(1)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    tvx, tvy, tvz = ro[:, 0] - p0x, ro[:, 1] - p0y, ro[:, 2] - p0z
    U = tvx * pvx + tvy * pvy + tvz * pvz
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    V = dx * qvx + dy * qvy + dz * qvz
    T = e2x * qvx + e2y * qvy + e2z * qvz
    a = torch.abs(det)
    tiny = a * PRETEST_TINY
    Us, Vs, Ts = (_flip_sign(x, det) for x in (U, V, T))
    far = torch.fmax(upper * a * PRETEST_SLACK, torch.zeros_like(a))
    reject = ((Us < -tiny) | (Vs < -tiny) | (Us + Vs > a * PRETEST_SLACK)
              | ((t_min >= 0.0) & (Ts < -tiny)) | (Ts > far))
    return ~reject


def _brute_fn():
    lib = cuda_build.load("trace_brute")
    fn = lib.trace_brute_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, p, ctypes.c_int64,
                       p, p, p, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _bvh_fn():
    lib = cuda_build.load("trace_bvh")
    fn = lib.trace_bvh_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, p, ctypes.c_int64,
                       p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _bvh_vis_fn():
    lib = cuda_build.load("trace_bvh")
    fn = lib.trace_bvh_vis_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, p, ctypes.c_int64,
                       p, p, p, p, p, i, i, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def check_tlas_rows(rows):
    """The table the ``trace_tlas`` kernel reads for ``rows`` (W columns,
    W ≥ 56): it reads rows as 16-byte loads, so it gets the table itself
    when W is a multiple of 4 floats and the base 16-byte aligned (both
    modes' default ``max_leaf`` give widths 56 and 88), else the cached
    copy padded with zero columns (``max_leaf`` 6, 7, 9-11, 13-15 give
    other widths; it steps rows by the padded width and reads slots by
    ``max_leaf``, and the plain walk never reads past ``tlas_width``).  The
    copy is kept while the table lives.  Raises ``ValueError`` on a table
    that is not 2-D or narrower than a node row."""
    if rows.dim() != 2 or rows.shape[1] < NODE_COLS:
        raise ValueError(f"trace_tlas takes (N, W >= {NODE_COLS}) rows, got "
                         f"{tuple(rows.shape)}")
    if rows.shape[1] % 4 == 0 and rows.data_ptr() % 16 == 0:
        return rows

    def pad(r):
        out = torch.zeros((r.shape[0], -(-r.shape[1] // 4) * 4),
                          dtype=r.dtype, device=r.device)
        out[:, :r.shape[1]] = r
        return (out,)
    return _kernel_tables("trace_tlas", (rows,), pad)[0]


def trace_tlas(rows, winst_base, ro, rd, t_min, t_max, active, ray_mask,
               max_leaf, stack_size, any_hit=False, has_vis=False) -> HitInst:
    """Two-level trace over the unified table ``wrows_tlas``: (N, W) f32
    rows with W = ``tlas_width(max_leaf)`` (any N below 2^23: the table is
    read from global memory, not staged), the scene's ``winst_base``, the
    rays as for :func:`trace_brute`, an optional (R,) i32 ``ray_mask``, the
    scene's ``max_leaf`` (≤ 15) and ``stack_size`` (≤ 64).  ``has_vis``:
    leaf slots are tested against ``ray_mask`` too (the masked flatten
    walk; the kernel's masked instantiation, counted as
    ``trace_tlas_vis``).  CPU tensors run :func:`trace_tlas_plain`; CUDA
    tensors launch the kernel on the current stream, on
    :func:`check_tlas_rows`' table.  ``inst`` comes back rebased by
    ``winst_base`` (-1 on a miss)."""
    tables = (("rows", rows, tlas_width(max_leaf)),)
    if ray_mask is not None and ray_mask.device != ro.device:
        raise ValueError(f"ray_mask is on {ray_mask.device}, ro on {ro.device}")
    device, R, n_rows = _cuda_inputs("trace_tlas", tables, ro, rd, t_min,
                                     t_max, active)
    if device.type == "cpu":
        return trace_tlas_plain(rows, winst_base, ro, rd, t_min, t_max,
                                active, ray_mask, max_leaf, stack_size,
                                any_hit, has_vis=has_vis)
    (N,) = n_rows
    if ray_mask is not None:
        _check("ray_mask", ray_mask, torch.int32, (R,), device)
    if not 1 <= N < (1 << 23):
        raise ValueError(f"trace_tlas takes 1 to 2^23 - 1 rows, got {N}")
    if not 1 <= max_leaf <= LEAF_COUNT_MASK:
        raise ValueError(f"max_leaf {max_leaf} outside [1, {LEAF_COUNT_MASK}]")
    if not 1 <= stack_size <= MAX_STACK_SIZE:
        raise ValueError(f"stack_size {stack_size} outside "
                         f"[1, {MAX_STACK_SIZE}]")
    table = check_tlas_rows(rows)
    out = [torch.empty((R,), dtype=d, device=device)
           for d in (torch.float32, torch.int32, torch.float32, torch.float32,
                     torch.bool, torch.int32)]
    if R == 0:
        return HitInst(*out)
    name = "trace_tlas_vis" if has_vis else "trace_tlas"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _tlas_fn(has_vis)(
            table.data_ptr(), N, table.shape[1], ro.data_ptr(), rd.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), active.data_ptr(),
            None if ray_mask is None else ray_mask.data_ptr(), R,
            *(o.data_ptr() for o in out), int(max_leaf), int(stack_size),
            int(any_hit), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    cuda_build.launch_counts[
        f"{name}_anyhit" if any_hit else f"{name}_closest"] += 1
    t, prim, u, v, bf, inst_row = out
    inst = torch.where(prim >= 0, inst_row - int(winst_base), -1)
    return HitInst(t=t, prim=prim, u=u, v=v, backface=bf,
                   inst=inst.to(torch.int32))


def _tlas_fn(has_vis=False):
    lib = cuda_build.load("trace_tlas")
    fn = lib.trace_tlas_vis_launch if has_vis else lib.trace_tlas_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, i, i, p, p, p, p, p, p, ctypes.c_int64,
                       p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def trace_wide(rows, ro, rd, t_min, t_max, active, max_leaf, stack_size,
               any_hit=False, ray_mask=None, has_vis=False) -> Hit:
    """The 8-wide walk of a flatten scene over its ``wrows`` table:
    ``ray_tpu``'s ``_traverse_wide`` (ops/traverse.py:236), which is the
    two-level walk on a table with no instance rows, so it runs as
    :func:`trace_tlas` with ``winst_base`` 0 (on a CUDA tensor the
    ``trace_tlas`` kernel, counted as its launch), the instance dropped.
    ``rows``: (N, W) f32 with W = ``tlas_width(max_leaf)``.  With
    ``has_vis`` each leaf slot's visibility column is tested against
    ``ray_mask`` (None: every ray type)."""
    h = trace_tlas(rows, 0, ro, rd, t_min, t_max, active, ray_mask, max_leaf,
                   stack_size, any_hit=any_hit, has_vis=has_vis)
    return Hit(t=h.t, prim=h.prim, u=h.u, v=h.v, backface=h.backface)


def trace_tlas_bin(nodes, tris, inst, ro, rd, t_min, t_max, active,
                   ray_mask, max_leaf, stack_size, any_hit=False) -> HitInst:
    """The binary two-level trace of a tlas scene without ``wrows_tlas``
    (``ray_tpu``'s ``_traverse_tlas``): (N, 14) f32 packed node rows (TLAS
    first), (T, 9) f32 object-space triangles, the instance columns
    (``vis``, ``blas_root``, ``inv00`` … ``invtz``, each (I,)), the rays as
    for :func:`trace_brute`, an optional (R,) i32 ``ray_mask``, the
    scene's ``max_leaf`` (≤ 15) and ``stack_size`` (≤ 64).  CPU tensors
    run :func:`trace_tlas_bin_plain`; CUDA tensors launch
    ``csrc/trace_tlas_bin.cu`` on the current stream, on the scene's
    cached :func:`node_rows`, :func:`tri_rows` and :func:`inst_rows`
    (built at the first launch on them)."""
    device, R, rows = _cuda_inputs(
        "trace_tlas_bin", (("nodes", nodes, 14), ("tris", tris, 9)),
        ro, rd, t_min, t_max, active)
    for k in ("vis", "blas_root", *INST_XFORM_COLS):
        if inst[k].device != device:
            raise ValueError(f"inst[{k!r}] is on {inst[k].device}, ro on "
                             f"{device}")
    if ray_mask is not None and ray_mask.device != device:
        raise ValueError(f"ray_mask is on {ray_mask.device}, ro on {device}")
    if device.type == "cpu":
        return trace_tlas_bin_plain(nodes, tris, inst, ro, rd, t_min, t_max,
                                    active, ray_mask, max_leaf, stack_size,
                                    any_hit)
    N, T = rows
    n_inst = inst["vis"].shape[0]
    if max(N, T) >= BVH_MAX_TABLE_ROWS or not 1 <= n_inst < INST_LEAF_FLAG:
        raise ValueError(f"trace_tlas_bin takes fewer than "
                         f"{BVH_MAX_TABLE_ROWS} node and triangle rows and "
                         f"1 to 2^28 - 1 instances, got {N}, {T} and "
                         f"{n_inst}")
    _check("inst['vis']", inst["vis"], torch.int32, (n_inst,), device)
    _check("inst['blas_root']", inst["blas_root"], torch.int32, (n_inst,),
           device)
    for k in INST_XFORM_COLS:
        _check(f"inst[{k!r}]", inst[k], torch.float32, (n_inst,), device)
    if ray_mask is not None:
        _check("ray_mask", ray_mask, torch.int32, (R,), device)
    if not 1 <= max_leaf <= LEAF_COUNT_MASK:
        raise ValueError(f"max_leaf {max_leaf} outside [1, {LEAF_COUNT_MASK}]")
    if not 1 <= stack_size <= MAX_STACK_SIZE:
        raise ValueError(f"stack_size {stack_size} outside "
                         f"[1, {MAX_STACK_SIZE}]")
    nrows, trows, irows = _tlas_bin_kernel_tables(nodes, tris, inst)
    out = [torch.empty((R,), dtype=d, device=device)
           for d in (torch.float32, torch.int32, torch.float32, torch.float32,
                     torch.bool, torch.int32)]
    if R == 0:
        return HitInst(*out)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _tlas_bin_fn()(
            nrows.data_ptr(), N, trows.data_ptr(), T, irows.data_ptr(),
            n_inst, ro.data_ptr(), rd.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), active.data_ptr(),
            None if ray_mask is None else ray_mask.data_ptr(), R,
            *(o.data_ptr() for o in out), int(max_leaf), int(stack_size),
            int(any_hit), stream,
        )
    if err != 0:
        raise RuntimeError(f"trace_tlas_bin kernel launch failed: CUDA error "
                           f"{err}")
    cuda_build.launch_counts[
        "trace_tlas_bin_anyhit" if any_hit else "trace_tlas_bin_closest"] += 1
    return HitInst(*out)


def _tlas_bin_fn():
    lib = cuda_build.load("trace_tlas_bin")
    fn = lib.trace_tlas_bin_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, i, p, i, p, i, p, p, p, p, p, p, ctypes.c_int64,
                       p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# The binned trace of big flatten scenes (ray_tpu's trace_flat_binned):
# subtree slabs from ray_tpu_torch.scene.binned, walked near to far.
# ---------------------------------------------------------------------------


def _binned_tables(binned):
    """(slab_f, slab_i, sub_lo, sub_hi) as contiguous tensors, S and the
    walk's stack size."""
    S = int(binned["slab_i"].shape[0]) // CI
    return (binned["slab_f"].contiguous(), binned["slab_i"].contiguous(),
            binned["sub_lo"].contiguous(), binned["sub_hi"].contiguous(),
            S, int(binned["stack_arr"].shape[0]))


def _next_subtree(sub_lo, sub_hi, ray, f_t, f_sid, t_best, chunk=64):
    """Each lane's next subtree: the lexicographic minimum of (t_enter, sid)
    strictly after its frontier (f_t, f_sid) over the subtree boxes that
    its ray enters before ``t_best`` (``_binned_kernel``'s
    ``next_subtree``: a box is taken when its t_enter < the best so far,
    or equal with a smaller sid; the best starts at (3.4e38, INT32_MAX)).
    The S boxes are scanned ``chunk`` at a time.  Returns (t_enter, sid),
    sid -1 where no subtree is left."""
    ox, oy, oz, _, _, _, ix, iy, iz, t_min, _ = ray
    n = ox.shape[0]
    S = sub_lo.shape[0]
    bt = torch.full((n,), BINNED_BIG, dtype=torch.float32, device=ox.device)
    bs = torch.full((n,), INT32_MAX, dtype=torch.int64, device=ox.device)
    col = (lambda a: a[:, None])  # noqa: E731
    for c0 in range(0, S, chunk):
        lo, hi = sub_lo[c0:c0 + chunk], sub_hi[c0:c0 + chunk]
        sid = torch.arange(c0, c0 + lo.shape[0], device=ox.device)
        hit, tn = _aabb_c(col(ox), col(oy), col(oz), col(ix), col(iy),
                          col(iz), lo[:, 0], lo[:, 1], lo[:, 2], hi[:, 0],
                          hi[:, 1], hi[:, 2], col(t_min), col(t_best))
        after = (tn > col(f_t)) | ((tn == col(f_t)) & (sid > col(f_sid)))
        cand = hit & after & (tn <= BINNED_BIG)
        ct = torch.where(cand, tn, float("inf")).amin(dim=1)
        first = torch.argmax((cand & (tn == col(ct))).to(torch.int8), dim=1)
        # a later chunk's sid is larger: it wins only on a smaller t_enter,
        # or on t_enter == 3.4e38 while nothing is taken yet
        take = cand.any(dim=1) & ((ct < bt) | ((ct == bt) & (bs == INT32_MAX)))
        bt = torch.where(take, ct, bt)
        bs = torch.where(take, first + c0, bs)
    return bt, torch.where(bs == INT32_MAX, -1, bs)


def trace_binned_plain(binned, ro, rd, t_min, t_max, active, max_leaf,
                       any_hit=False, work=None) -> Hit:
    """The binned trace in plain PyTorch: ``_binned_kernel``'s per-lane
    semantics (ray_tpu/ops/traverse_pallas.py:939-1168).

    Each ray keeps a frontier (t_enter, sid), starting at (-3.4e38, -1),
    and runs rounds: it picks its next subtree (:func:`_next_subtree`: the
    lexicographic-min (t_enter, sid) after its frontier, among the subtree
    boxes it enters before its best hit), walks that subtree's slab with
    :func:`trace_bvh_plain`'s walk on local codes (a fresh stack each
    round, ``prim`` mapped from the slab's local→global column) and moves
    its frontier there; it stops when no subtree is left, and in any-hit
    mode once it has a hit.  ``ray_tpu``'s kernel serialises a block's
    lanes over rounds (the block walks its smallest pending sid, and a lane
    whose next subtree differs sits the round out, keeping its frontier and
    best hit), so every lane visits the same subtrees in the same order as
    here.  Stack overflow pops on, as :func:`trace_bvh_plain` does (ROADMAP
    Queue 3).

    ``binned``: the dict of :func:`ray_tpu_torch.scene.binned.pack_binned_scene`
    as tensors.  ``work``: optional dict; ``rounds`` (subtree walks),
    ``box_tests`` (S for every lane's subtree scan), ``node_steps`` and
    ``tri_tests`` are added to it."""
    slab_f, slab_i, sub_lo, sub_hi, S, stack_size = _binned_tables(binned)
    R = ro.shape[0]
    device = ro.device
    # row-major per-entry tables: entry idx of subtree s is row s*512 + idx
    cols_f = slab_f.view(S, CF // 4, SUB_ROWS).transpose(1, 2)
    cols_i = slab_i.view(S, CI // 4, SUB_ROWS).transpose(1, 2)
    nodes = cols_f[:, :, 0:12].reshape(S * SUB_ROWS, 12)
    tris = cols_f[:, :, 12:21].reshape(S * SUB_ROWS, 9)
    codes = cols_i[:, :, 0:2].reshape(S * SUB_ROWS, 2)
    prim_map = cols_i[:, :, 2].reshape(S * SUB_ROWS)

    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    ray = (ro[:, 0], ro[:, 1], ro[:, 2], dx, dy, dz,
           _safe_inv(dx), _safe_inv(dy), _safe_inv(dz), t_min, t_max)
    t_best = t_max.clone()
    prim = torch.full((R,), -1, dtype=torch.int32, device=device)
    u_b = torch.zeros_like(t_max)
    v_b = torch.zeros_like(t_max)
    bf = torch.zeros((R,), dtype=torch.bool, device=device)
    f_t = torch.full((R,), -BINNED_BIG, dtype=torch.float32, device=device)
    f_sid = torch.full((R,), -1, dtype=torch.int64, device=device)
    live = active.clone()
    if work is not None:
        for k in ("rounds", "box_tests", "node_steps", "tri_tests"):
            work.setdefault(k, 0)

    while True:
        if any_hit:
            live = live & (prim < 0)
        lanes = torch.nonzero(live).squeeze(1)
        if lanes.numel() == 0:
            break
        sub_ray = tuple(a[lanes] for a in ray)
        bt, bs = _next_subtree(sub_lo, sub_hi, sub_ray, f_t[lanes],
                               f_sid[lanes], t_best[lanes])
        go = bs >= 0
        live[lanes[~go]] = False
        if work is not None:
            work["box_tests"] += S * int(lanes.numel())
            work["rounds"] += int(go.sum())
        lanes, bt, bs = lanes[go], bt[go], bs[go]
        if lanes.numel() == 0:
            break
        sub_ray = tuple(a[lanes] for a in ray)
        hit = _walk_bvh2(
            nodes, codes, tris, bs * SUB_ROWS, prim_map, sub_ray,
            (t_best[lanes], prim[lanes], u_b[lanes], v_b[lanes], bf[lanes]),
            torch.ones_like(lanes, dtype=torch.bool), max_leaf, stack_size,
            any_hit, work)
        for dst, src in zip((t_best, prim, u_b, v_b, bf), hit):
            dst[lanes] = src
        f_t[lanes] = bt
        f_sid[lanes] = bs
    return Hit(t=t_best, prim=prim, u=u_b, v=v_b, backface=bf)


def binned_sort_key_plain(sub_lo, sub_hi, ro, rd, t_min, t_max, active,
                          chunk=64) -> torch.Tensor:
    """Each ray's first subtree, the key ``trace_flat_binned`` sorts rays
    by (ray_tpu/ops/traverse_pallas.py:1255-1275), in its own arithmetic:
    the entry distance is the max over the axes of the slab minima, the
    exit distance the max of the maxima times the slack, capped by t_max;
    the first box in sid order with the smallest entry distance below
    3.4e38 wins.  (R,) int32, S where no box is hit or the lane is
    inactive.  It decides only the order of the rays, never a result."""
    S = sub_lo.shape[0]
    inv = torch.reciprocal(torch.where(
        torch.abs(rd) > 1e-7, rd,
        torch.where(rd >= 0, 1e-7, -1e-7).to(rd.dtype)))
    best_t = torch.full(t_min.shape, BINNED_BIG, dtype=torch.float32,
                        device=ro.device)
    best_s = torch.full(t_min.shape, S, dtype=torch.int64, device=ro.device)
    for c0 in range(0, S, chunk):
        lo, hi = sub_lo[c0:c0 + chunk], sub_hi[c0:c0 + chunk]
        t0 = (lo[None] - ro[:, None]) * inv[:, None]
        t1 = (hi[None] - ro[:, None]) * inv[:, None]
        tn = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=-1),
                           t_min[:, None])
        tf = torch.minimum(
            torch.amax(torch.maximum(t0, t1), dim=-1) * SLAB_SLACK,
            t_max[:, None])
        cand = (tn <= tf) & active[:, None] & (tn < BINNED_BIG)
        ct = torch.where(cand, tn, float("inf")).amin(dim=1)
        first = torch.argmax((cand & (tn == ct[:, None])).to(torch.int8),
                             dim=1)
        take = cand.any(dim=1) & (ct < best_t)
        best_t = torch.where(take, ct, best_t)
        best_s = torch.where(take, first + c0, best_s)
    return best_s.to(torch.int32)


def _binned_inputs(binned, ro, rd, t_min, t_max, active):
    slab_f, slab_i, sub_lo, sub_hi, S, stack_size = _binned_tables(binned)
    tables = (("slab_f", slab_f, 128), ("sub_lo", sub_lo, 3),
              ("sub_hi", sub_hi, 3))
    if slab_i.device != ro.device:
        raise ValueError(f"slab_i is on {slab_i.device}, ro on {ro.device}")
    device, R, rows = _cuda_inputs("trace_binned", tables, ro, rd, t_min,
                                   t_max, active)
    if device.type == "cuda":
        _check("slab_i", slab_i, torch.int32, (S * CI, 128), device)
        if tuple(rows) != (S * CF, S, S):
            raise ValueError(f"binned tables of {S} subtrees need slab_f "
                             f"({S * CF}, 128) and sub_lo/sub_hi ({S}, 3), "
                             f"got {rows[0]} and {rows[1]}/{rows[2]} rows")
        if not 2 <= S <= MAX_SUBTREES:
            raise ValueError(f"trace_binned takes 2 to {MAX_SUBTREES} "
                             f"subtrees, got {S}")
        if not 1 <= stack_size <= MAX_STACK_SIZE:
            raise ValueError(f"stack_size {stack_size} outside "
                             f"[1, {MAX_STACK_SIZE}]")
    return (slab_f, slab_i, sub_lo, sub_hi, S, stack_size), device, R


def binned_rows(slab_f, slab_i):
    """The row-major copy of the subtree slabs that the binned kernel reads
    (one transpose and one copy each; the same bits as the slabs):

    - ``node_rows`` (S·512, 16) f32, one 64-byte record a node entry: its
      twelve child-box floats (lo0 xyz, hi0 xyz, lo1 xyz, hi1 xyz), its two
      child codes as int bits, two zero words;
    - ``tri_rows`` (S·512, 12) f32, one 48-byte record a triangle entry:
      its nine vertex floats (p0 p1 p2), its global prim as int bits, two
      zero words.

    Entry ``idx`` of subtree ``s`` is row ``s·512 + idx`` of each."""
    S = slab_i.shape[0] // CI
    cols_f = slab_f.reshape(S, CF // SUB_SEGS, SUB_ROWS).transpose(1, 2)
    cols_i = slab_i.reshape(S, CI // SUB_SEGS, SUB_ROWS).transpose(1, 2)
    node = torch.zeros((S, SUB_ROWS, 16), dtype=torch.float32,
                       device=slab_f.device)
    node[:, :, 0:12] = cols_f[:, :, 0:12]
    node.view(torch.int32)[:, :, 12:14] = cols_i[:, :, 0:2]
    tri = torch.zeros((S, SUB_ROWS, 12), dtype=torch.float32,
                      device=slab_f.device)
    tri[:, :, 0:9] = cols_f[:, :, 12:21]
    tri.view(torch.int32)[:, :, 9] = cols_i[:, :, 2]
    return node.reshape(S * SUB_ROWS, 16), tri.reshape(S * SUB_ROWS, 12)


def _binned_kernel_tables(binned):
    """(node_rows, tri_rows, tree) of :func:`binned_rows` and
    :func:`ray_tpu_torch.scene.binned.subtree_tree` on the tables' device,
    built at the first launch on a scene's tables and kept while they
    live (:func:`_kernel_tables`).  Raises ``ValueError`` when the tree is
    deeper than the kernel's search stack."""
    def build(slab_f, slab_i, sub_lo, sub_hi):
        tree, _ = subtree_tree(sub_lo.cpu().numpy(), sub_hi.cpu().numpy(),
                               PICK_STACK)
        return (*binned_rows(slab_f.contiguous(), slab_i.contiguous()),
                torch.from_numpy(tree).to(slab_f.device))
    return _kernel_tables(
        "trace_binned",
        tuple(binned[k] for k in ("slab_f", "slab_i", "sub_lo", "sub_hi")),
        build)


def binned_sort_key(binned, ro, rd, t_min, t_max, active) -> torch.Tensor:
    """:func:`binned_sort_key_plain` on a CPU tensor; on a CUDA tensor the
    ``trace_binned.cu`` key kernel (one thread per ray, the first subtree
    found by a search of the subtree tree), counted under
    ``trace_binned_sortkey``."""
    (_, _, sub_lo, sub_hi, S, _), device, R = _binned_inputs(
        binned, ro, rd, t_min, t_max, active)
    if device.type == "cpu":
        return binned_sort_key_plain(sub_lo, sub_hi, ro, rd, t_min, t_max,
                                     active)
    key = torch.empty((R,), dtype=torch.int32, device=device)
    if R == 0:
        return key
    tree = _binned_kernel_tables(binned)[2]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _binned_key_fn()(
            tree.data_ptr(), S, ro.data_ptr(),
            rd.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            active.data_ptr(), R, key.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"binned sort-key kernel launch failed: CUDA "
                           f"error {err}")
    cuda_build.launch_counts["trace_binned_sortkey"] += 1
    return key


def trace_binned(binned, ro, rd, t_min, t_max, active, max_leaf,
                 any_hit=False, sort_rays=True) -> Hit:
    """The binned trace of a big flatten scene (``ray_tpu``'s
    ``trace_flat_binned``): ``binned`` the dict of slab tables
    (:mod:`ray_tpu_torch.scene.binned`; 2 to 512 subtrees, a stack of at
    most 64), the rays as for :func:`trace_brute`, the scene's
    ``max_leaf`` (≤ 15).  With ``sort_rays`` the rays are first ordered by
    their first subtree (:func:`binned_sort_key`, a stable sort) and the
    hits scattered back, which changes no result.  CPU tensors run
    :func:`trace_binned_plain`; CUDA tensors launch the kernel on the
    current stream, on the scene's row-major slab copy and subtree tree
    (:func:`_binned_kernel_tables`, built at the first launch)."""
    (*_, S, stack_size), device, R = _binned_inputs(binned, ro, rd, t_min,
                                                    t_max, active)
    if device.type == "cuda" and not 1 <= max_leaf <= LEAF_COUNT_MASK:
        raise ValueError(f"max_leaf {max_leaf} outside [1, {LEAF_COUNT_MASK}]")
    perm = None
    if sort_rays:
        perm = torch.argsort(
            binned_sort_key(binned, ro, rd, t_min, t_max, active), stable=True)
        ro, rd, t_min, t_max, active = (
            a[perm] for a in (ro, rd, t_min, t_max, active))
    if device.type == "cpu":
        out = trace_binned_plain(binned, ro, rd, t_min, t_max, active,
                                 max_leaf, any_hit)
    else:
        node_rows, tri_rows, tree = _binned_kernel_tables(binned)
        # the persistent warps' ray counter
        counter = torch.zeros((1,), dtype=torch.int32, device=device)
        out = _launch("trace_binned", _binned_fn(), device, R,
                      (node_rows.data_ptr(), tri_rows.data_ptr(),
                       tree.data_ptr(), S),
                      ro, rd, t_min, t_max, active, any_hit, int(max_leaf),
                      stack_size, counter.data_ptr())
    if perm is None:
        return out
    back = torch.empty_like(perm)
    back[perm] = torch.arange(perm.shape[0], device=device)
    return Hit(*(x[back] for x in out))


def _binned_fn():
    lib = cuda_build.load("trace_binned")
    fn = lib.trace_binned_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, i, p, p, p, p, p, ctypes.c_int64,
                       p, p, p, p, p, i, i, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def _binned_key_fn():
    lib = cuda_build.load("trace_binned")
    fn = lib.binned_sort_key_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, p, ctypes.c_int64, p, p]
        fn.restype = ctypes.c_int
    return fn


def _trace_tlas_soa(bvh, tris, inst, ro, rd, t_min, t_max, active, ray_mask,
                    max_leaf, stack_size, any_hit) -> HitInst:
    rays = (ro.detach().contiguous(), rd.detach().contiguous(),
            t_min.detach().contiguous(), t_max.detach().contiguous(),
            active.contiguous())
    mask = None if ray_mask is None else ray_mask.contiguous()
    if "wrows_tlas" not in bvh:
        return trace_tlas_bin(bvh["packed"], tris["packed"], inst, *rays,
                              mask, max_leaf, stack_size, any_hit=any_hit)
    return trace_tlas(bvh["wrows_tlas"], int(bvh["winst_base"]), *rays, mask,
                      max_leaf, stack_size, any_hit=any_hit)


def trace_closest_tlas(bvh, tris, inst, ro, rd, t_min, t_max, active,
                       ray_mask=None, max_leaf: int = 4,
                       stack_size: int = MAX_STACK_SIZE) -> HitInst:
    """Two-level closest-hit trace (``ray_tpu``'s ``trace_closest_tlas``).
    ``bvh``: ``SceneFlat.bvh_soa`` of a tlas scene; with ``wrows_tlas``
    (and ``winst_base``) it runs :func:`trace_tlas`, else
    :func:`trace_tlas_bin` on ``bvh["packed"]``, ``tris["packed"]`` and
    the instance columns ``inst``.  Returns a :class:`HitInst`."""
    return _trace_tlas_soa(bvh, tris, inst, ro, rd, t_min, t_max, active,
                           ray_mask, max_leaf, stack_size, False)


def trace_occlusion_tlas(bvh, tris, inst, ro, rd, t_min, t_max, active,
                         ray_mask=None, max_leaf: int = 4,
                         stack_size: int = MAX_STACK_SIZE) -> torch.Tensor:
    """Two-level any-hit (shadow) trace: returns (R,) bool ``occluded``."""
    hit = _trace_tlas_soa(bvh, tris, inst, ro, rd, t_min, t_max, active,
                          ray_mask, max_leaf, stack_size, True)
    return hit.prim >= 0


def _trace(bvh, tris, ro, rd, t_min, t_max, active, max_leaf, stack_size,
           tri_vis, ray_mask, any_hit):
    rays = (ro.detach().contiguous(), rd.detach().contiguous(),
            t_min.detach().contiguous(), t_max.detach().contiguous(),
            active.contiguous())
    if tri_vis is not None:
        # ray_tpu's mode=None: the masked wide walk, else the masked BVH2
        # walk, whatever the size (ops/traverse.py:601-604, :616-626)
        mask = None if ray_mask is None else ray_mask.contiguous()
        if "wrows" in bvh:
            return trace_wide(bvh["wrows"], *rays, max_leaf, stack_size,
                              any_hit=any_hit, ray_mask=mask, has_vis=True)
        return trace_bvh(bvh["packed"], tris["packed"], *rays, max_leaf,
                         stack_size, any_hit=any_hit,
                         tri_vis=tri_vis.contiguous(), ray_mask=mask)
    mode = _trace_mode(bvh["code0"].shape[0], tris["p0x"].shape[0],
                       "binned_slab_f" in bvh, "wrows" in bvh)
    if mode == "brute":
        return trace_brute(tris["packed"], *rays, any_hit=any_hit)
    if mode == "bvh":
        return trace_bvh(bvh["packed"], tris["packed"], *rays, max_leaf,
                         stack_size, any_hit=any_hit)
    if mode == "binned":
        binned = {k[7:]: v for k, v in bvh.items() if k.startswith("binned_")}
        return trace_binned(binned, *rays, max_leaf, any_hit=any_hit)
    return trace_wide(bvh["wrows"], *rays, max_leaf, stack_size,
                      any_hit=any_hit)


def trace_closest_soa(bvh, tris, ro, rd, t_min, t_max, active,
                      max_leaf: int = 4, stack_size: int = MAX_STACK_SIZE,
                      tri_vis=None, ray_mask=None) -> Hit:
    """Closest-hit trace against the scene's SoA node and triangle tables.

    Args:
      bvh: dict of (N,) node columns + packed (N, 14) rows
        (``SceneFlat.bvh_soa``; past 512 rows its binned slabs
        ``binned_*``, else its 8-wide ``wrows``, else the BVH2 is walked).
      tris: dict of (T,) triangle columns + packed (T, 9) rows, leaf order.
      ro, rd: (R, 3) f32; t_min, t_max: (R,) f32; active: (R,) bool.
      tri_vis/ray_mask: optional (T,)/(R,) i32 per-ray-type visibility —
        triangles whose mask shares no bit with the ray's are skipped.
    """
    return _trace(bvh, tris, ro, rd, t_min, t_max, active, max_leaf,
                  stack_size, tri_vis, ray_mask, False)


def trace_occlusion_soa(bvh, tris, ro, rd, t_min, t_max, active,
                        max_leaf: int = 4, stack_size: int = MAX_STACK_SIZE,
                        tri_vis=None, ray_mask=None) -> torch.Tensor:
    """Any-hit (shadow) trace: returns (R,) bool ``occluded``."""
    hit = _trace(bvh, tris, ro, rd, t_min, t_max, active, max_leaf,
                 stack_size, tri_vis, ray_mask, True)
    return hit.prim >= 0


# ---------------------------------------------------------------------------
# ray_tpu's array-of-structs wrappers over (vertices, tri_vidx) inputs, used
# by tests (ops/traverse.py:738-812)
# ---------------------------------------------------------------------------


def _soa_from_arrays(nodes_child_lo, nodes_child_hi, nodes_child,
                     prim_indices, vertices, tri_vidx):
    bvh = {}
    for side in range(2):
        for axis, ax in enumerate("xyz"):
            bvh[f"lo{side}{ax}"] = nodes_child_lo[:, side, axis]
            bvh[f"hi{side}{ax}"] = nodes_child_hi[:, side, axis]
        bvh[f"code{side}"] = nodes_child[:, side]
    bvh["packed"] = torch.cat([
        nodes_child_lo[:, 0], nodes_child_hi[:, 0],
        nodes_child_lo[:, 1], nodes_child_hi[:, 1],
        nodes_child[:, :2].to(torch.int32).contiguous().view(torch.float32),
    ], dim=1)
    tris_leaf = vertices[tri_vidx[prim_indices.long()].long()]  # (T, 3, 3)
    tris = {}
    for v in range(3):
        for axis, ax in enumerate("xyz"):
            tris[f"p{v}{ax}"] = tris_leaf[:, v, axis]
    tris["packed"] = tris_leaf.reshape(tris_leaf.shape[0], 9).contiguous()
    return bvh, tris


def trace_closest(nodes_child_lo, nodes_child_hi, nodes_child, prim_indices,
                  vertices, tri_vidx, ro, rd, t_min, t_max, active,
                  max_leaf: int = 4, stack_size: int = MAX_STACK_SIZE) -> Hit:
    """Array-of-structs wrapper (``ray_tpu``'s ``trace_closest``): a BVH2's
    child boxes (N, 2, 3), child codes (N, 2) and ``prim_indices``, the
    vertices and triangle indices.  Unlike ``trace_closest_soa``'s leaf
    order, ``prim`` is the original triangle id (-1 on a miss)."""
    bvh, tris = _soa_from_arrays(nodes_child_lo, nodes_child_hi, nodes_child,
                                 prim_indices, vertices, tri_vidx)
    hit = trace_closest_soa(bvh, tris, ro, rd, t_min, t_max, active,
                            max_leaf=max_leaf, stack_size=stack_size)
    orig = prim_indices[torch.clamp_min(hit.prim, 0).long()].to(torch.int32)
    return hit._replace(prim=torch.where(hit.prim >= 0, orig, -1))


def trace_occlusion(nodes_child_lo, nodes_child_hi, nodes_child, prim_indices,
                    vertices, tri_vidx, ro, rd, t_min, t_max, active,
                    max_leaf: int = 4,
                    stack_size: int = MAX_STACK_SIZE) -> torch.Tensor:
    """Any-hit counterpart of :func:`trace_closest`: (R,) bool."""
    bvh, tris = _soa_from_arrays(nodes_child_lo, nodes_child_hi, nodes_child,
                                 prim_indices, vertices, tri_vidx)
    return trace_occlusion_soa(bvh, tris, ro, rd, t_min, t_max, active,
                               max_leaf=max_leaf, stack_size=stack_size)


def trace_closest_brute(vertices, tri_vidx, ro, rd, t_min, t_max,
                        active) -> Hit:
    """O(R·T) reference intersector (``ray_tpu``'s
    ``trace_closest_brute``): every ray against every triangle of the
    vertex buffer with :func:`~ray_tpu_torch.ops.intersect.intersect_tri`,
    the nearest hit by the first minimum of t.  A test oracle, on no
    path."""
    from ray_tpu_torch.ops.intersect import intersect_tri

    idx = tri_vidx.long()
    p0, p1, p2 = vertices[idx[:, 0]], vertices[idx[:, 1]], vertices[idx[:, 2]]
    hit, t, u, v, bf = intersect_tri(
        ro[:, None, :], rd[:, None, :], p0[None], p1[None], p2[None],
        t_min[:, None], t_max[:, None])
    hit = hit & active[:, None]
    t = torch.where(hit, t, torch.full_like(t, float("inf")))
    best = torch.argmin(t, dim=1)
    r = torch.arange(ro.shape[0], device=ro.device)
    has = hit[r, best]
    return Hit(
        t=torch.where(has, t[r, best], t_max),
        prim=torch.where(has, best.to(torch.int32), -1).to(torch.int32),
        u=torch.where(has, u[r, best], 0.0),
        v=torch.where(has, v[r, best], 0.0),
        backface=torch.where(has, bf[r, best], False),
    )
