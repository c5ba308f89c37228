"""The plain traversal of the reference: frozen from ``ray_tpu_torch/ops/
traverse.py`` (lines 74-737 and 1556-1663 as of the port's first
benchmark), with the two routes the configurations take: the brute-force
test of a flattened scene of at most 40 triangles and the 8-wide two-level
walk.  Each runs as plain PyTorch on whatever device the tensors are on,
so the reference never launches a kernel of the port; any other scene
raises."""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtbench.ref.scene.bvh import MAX_STACK_SIZE
from rtbench.ref.scene.wbvh import INST_ROW_BIT


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


def _full_mask(ray_mask, R, device):
    """``ray_mask``, or every ray type for each of R rays when None."""
    if ray_mask is not None:
        return ray_mask
    return torch.full((R,), FULL_RAY_MASK, dtype=torch.int32, device=device)


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


def _rays(ro, rd, t_min, t_max, active):
    return (ro.detach().contiguous(), rd.detach().contiguous(),
            t_min.detach().contiguous(), t_max.detach().contiguous(),
            active.contiguous())


def _trace_tlas(bvh, ro, rd, t_min, t_max, active, max_leaf, stack_size,
                any_hit) -> HitInst:
    """The port's route for a two-level scene past 256 unique triangles:
    the walk of the unified 8-wide table."""
    if "wrows_tlas" not in bvh:
        raise ValueError("the reference walks two-level scenes only through "
                         "their 8-wide table (past 256 unique triangles)")
    return trace_tlas_plain(bvh["wrows_tlas"], int(bvh["winst_base"]),
                            *_rays(ro, rd, t_min, t_max, active), None,
                            max_leaf, stack_size, any_hit)


def trace_closest_tlas(bvh, ro, rd, t_min, t_max, active, max_leaf: int = 4,
                       stack_size: int = MAX_STACK_SIZE) -> HitInst:
    return _trace_tlas(bvh, ro, rd, t_min, t_max, active, max_leaf,
                       stack_size, False)


def trace_occlusion_tlas(bvh, ro, rd, t_min, t_max, active, max_leaf: int = 4,
                         stack_size: int = MAX_STACK_SIZE) -> torch.Tensor:
    hit = _trace_tlas(bvh, ro, rd, t_min, t_max, active, max_leaf, stack_size,
                      True)
    return hit.prim >= 0


def _trace_flat(tris, ro, rd, t_min, t_max, active, any_hit) -> Hit:
    """The port's route for a flattened scene of at most
    ``BRUTE_MAX_TRIS`` triangles: the brute-force test."""
    if tris["p0x"].shape[0] > BRUTE_MAX_TRIS:
        raise ValueError(f"the reference walks flattened scenes only by brute "
                         f"force (at most {BRUTE_MAX_TRIS} triangles)")
    return trace_brute_plain(tris["packed"],
                             *_rays(ro, rd, t_min, t_max, active),
                             any_hit=any_hit)


def trace_closest_soa(tris, ro, rd, t_min, t_max, active) -> Hit:
    return _trace_flat(tris, ro, rd, t_min, t_max, active, False)


def trace_occlusion_soa(tris, ro, rd, t_min, t_max, active) -> torch.Tensor:
    return _trace_flat(tris, ro, rd, t_min, t_max, active, True).prim >= 0
