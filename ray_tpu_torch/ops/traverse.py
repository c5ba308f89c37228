"""Ray traversal entry points and the trace kernels' wrappers.

The port of ``ray_tpu.ops.traverse``'s ``trace_closest_soa`` /
``trace_occlusion_soa``, routed as ``ray_tpu``'s ``_pallas_mode`` routes
on a TPU (:func:`_trace_mode`):

* ≤ 40 triangles → :func:`trace_brute` (``trace_brute_pallas``);
* max(nodes, triangles) ≤ 512 → :func:`trace_bvh` (``trace_bvh_pallas``),
  a per-ray stack walk of the BVH2;
* larger scenes raise ``NotImplementedError`` (the 8-wide walk is ROADMAP
  Queue 1 item 19).

Each wrapper launches its hand-written kernel
(``ray_tpu_torch/csrc/trace_{brute,bvh}.cu``) on a CUDA tensor, or raises;
on a CPU tensor it runs its plain PyTorch version
(:func:`trace_brute_plain`, :func:`trace_bvh_plain`) — the same arithmetic
in the same expression order, the executable spec each kernel is held to
bit for bit on the card.

Traversal is a discrete decision procedure: hits come back detached
(``prim`` int32, ``backface`` bool) and shading re-derives differentiable
hit attributes from the scene tables.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ray_tpu_torch._roadmap import not_ported
from ray_tpu_torch.ops import cuda_build
from ray_tpu_torch.scene.bvh import (
    LEAF_COUNT_BITS,
    LEAF_COUNT_MASK,
    MAX_STACK_SIZE,
)


class Hit(NamedTuple):
    """Closest-hit record (SoA over rays)."""

    t: torch.Tensor          # f32, distance (t_max if miss)
    prim: torch.Tensor       # i32, triangle index in leaf order (-1 = miss)
    u: torch.Tensor          # f32 barycentric of vertex 1
    v: torch.Tensor          # f32 barycentric of vertex 2
    backface: torch.Tensor   # bool


# ray_tpu's brute-force threshold (ops/traverse.py _PALLAS_BRUTE_MAX); the
# kernel's shared-memory triangle buffer holds this many
BRUTE_MAX_TRIS = 40
# ray_tpu's BVH-kernel limit (ops/traverse_pallas.py T_MAX_BVH): node and
# triangle rows the kernel stages in shared memory
BVH_MAX_ROWS = 512
# stack-empty sentinel (never a valid child code)
EMPTY = -0x80000000
# slab-test slack: f32 1 + 2 ulp (ray_tpu ops/traverse.py _aabb_c)
SLAB_SLACK = 1.00000024


def _trace_mode(n_nodes: int, n_tris: int) -> str:
    if n_tris <= BRUTE_MAX_TRIS:
        return "brute"
    if max(n_nodes, n_tris) <= BVH_MAX_ROWS:
        return "bvh"
    raise not_ported(
        f"the 8-wide BVH walk ({n_tris} triangles, {n_nodes} nodes)",
        "Queue 1 item 19")


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
                    stack_size, any_hit=False, work=None) -> Hit:
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

    ``nodes``: (N, 14) f32 packed rows (child 0 box, child 1 box, both
    child codes as int bits); ``tris``: (T, 9) f32.  ``work``: optional
    dict; node steps and triangle tests are added to its ``"node_steps"`` /
    ``"tri_tests"``."""
    R = ro.shape[0]
    device = ro.device
    S = int(stack_size)
    ox, oy, oz = ro[:, 0], ro[:, 1], ro[:, 2]
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    codes = nodes.contiguous().view(torch.int32)[:, 12:14]
    lanes = torch.arange(R, device=device)

    stack = torch.full((S, R), EMPTY, dtype=torch.int32, device=device)
    sp = torch.zeros((R,), dtype=torch.int32, device=device)
    cur = torch.where(active, 0, EMPTY).to(torch.int32)
    t_best = t_max.clone()
    prim = torch.full((R,), -1, dtype=torch.int32, device=device)
    u_b = torch.zeros_like(t_max)
    v_b = torch.zeros_like(t_max)
    bf = torch.zeros((R,), dtype=torch.bool, device=device)
    empty = torch.full_like(cur, EMPTY)
    if work is not None:
        work.setdefault("node_steps", 0)
        work.setdefault("tri_tests", 0)

    while bool(((cur != EMPTY) | (sp > 0)).any()):
        is_node = cur >= 0
        is_leaf = (cur < 0) & (cur != EMPTY)
        node = torch.where(is_node, cur, 0).long()

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
            th, tt, tu, tv, tb = _tri_c(
                ox, oy, oz, dx, dy, dz, tris[tri.long()], t_min,
                t_max if any_hit else t_best)
            take = th & valid
            t_best = torch.where(take, tt, t_best)
            prim = torch.where(take, tri, prim)
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
    return Hit(t=t_best, prim=prim, u=u_b, v=v_b, backface=bf)


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
    tensors launch the kernel on the current stream."""
    device, R, rows = _cuda_inputs("trace_brute", (("tris", tris, 9),),
                                   ro, rd, t_min, t_max, active)
    if device.type == "cpu":
        return trace_brute_plain(tris, ro, rd, t_min, t_max, active, any_hit)
    (T,) = rows
    if T > BRUTE_MAX_TRIS:
        raise ValueError(f"trace_brute takes at most {BRUTE_MAX_TRIS} "
                         f"triangles, got {T}")
    return _launch("trace_brute", _brute_fn(), device, R,
                   (tris.data_ptr(), T), ro, rd, t_min, t_max, active,
                   any_hit)


def trace_bvh(nodes, tris, ro, rd, t_min, t_max, active, max_leaf,
              stack_size, any_hit=False) -> Hit:
    """BVH2 trace: (N, 14) f32 packed node rows, (T, 9) f32 packed
    triangles (N, T ≤ 512), the rays as for :func:`trace_brute`, the
    scene's ``max_leaf`` (≤ 15) and ``stack_size`` (≤ 64).  CPU tensors run
    :func:`trace_bvh_plain`; CUDA tensors launch the kernel on the current
    stream."""
    device, R, rows = _cuda_inputs(
        "trace_bvh", (("nodes", nodes, 14), ("tris", tris, 9)),
        ro, rd, t_min, t_max, active)
    if device.type == "cpu":
        return trace_bvh_plain(nodes, tris, ro, rd, t_min, t_max, active,
                               max_leaf, stack_size, any_hit)
    N, T = rows
    if max(N, T) > BVH_MAX_ROWS:
        raise ValueError(f"trace_bvh takes at most {BVH_MAX_ROWS} node and "
                         f"triangle rows, got {N} and {T}")
    if not 1 <= max_leaf <= LEAF_COUNT_MASK:
        raise ValueError(f"max_leaf {max_leaf} outside [1, {LEAF_COUNT_MASK}]")
    if not 1 <= stack_size <= MAX_STACK_SIZE:
        raise ValueError(f"stack_size {stack_size} outside "
                         f"[1, {MAX_STACK_SIZE}]")
    return _launch("trace_bvh", _bvh_fn(), device, R,
                   (nodes.data_ptr(), N, tris.data_ptr(), T),
                   ro, rd, t_min, t_max, active, any_hit,
                   int(max_leaf), int(stack_size))


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


def _trace(bvh, tris, ro, rd, t_min, t_max, active, max_leaf, stack_size,
           tri_vis, any_hit):
    if tri_vis is not None:
        raise not_ported("per-ray-type visibility masks", "Queue 1 item 20")
    mode = _trace_mode(bvh["code0"].shape[0], tris["p0x"].shape[0])
    rays = (ro.detach().contiguous(), rd.detach().contiguous(),
            t_min.detach().contiguous(), t_max.detach().contiguous(),
            active.contiguous())
    if mode == "brute":
        return trace_brute(tris["packed"], *rays, any_hit=any_hit)
    return trace_bvh(bvh["packed"], tris["packed"], *rays, max_leaf,
                     stack_size, any_hit=any_hit)


def trace_closest_soa(bvh, tris, ro, rd, t_min, t_max, active,
                      max_leaf: int = 4, stack_size: int = MAX_STACK_SIZE,
                      tri_vis=None, ray_mask=None) -> Hit:
    """Closest-hit trace against the scene's SoA node and triangle tables.

    Args:
      bvh: dict of (N,) node columns + packed (N, 14) rows
        (``SceneFlat.bvh_soa``; the 8-wide ``wrows``, if present, is not
        read).
      tris: dict of (T,) triangle columns + packed (T, 9) rows, leaf order.
      ro, rd: (R, 3) f32; t_min, t_max: (R,) f32; active: (R,) bool.
      tri_vis/ray_mask: per-ray-type visibility (not ported yet).
    """
    return _trace(bvh, tris, ro, rd, t_min, t_max, active, max_leaf,
                  stack_size, tri_vis, False)


def trace_occlusion_soa(bvh, tris, ro, rd, t_min, t_max, active,
                        max_leaf: int = 4, stack_size: int = MAX_STACK_SIZE,
                        tri_vis=None, ray_mask=None) -> torch.Tensor:
    """Any-hit (shadow) trace: returns (R,) bool ``occluded``."""
    hit = _trace(bvh, tris, ro, rd, t_min, t_max, active, max_leaf,
                 stack_size, tri_vis, True)
    return hit.prim >= 0
