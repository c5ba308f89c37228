"""Ray traversal entry points, and the brute-force trace kernel's wrapper.

The port of ``ray_tpu.ops.traverse``'s ``trace_closest_soa`` /
``trace_occlusion_soa``.  ``ray_tpu`` routes a scene of ≤ 40 triangles to
its Pallas brute-force kernel (``_pallas_mode``); here the same scenes go
to :func:`trace_brute`:

* on a CUDA tensor it launches the hand-written kernel
  ``ray_tpu_torch/csrc/trace_brute.cu`` (or raises);
* on a CPU tensor it runs :func:`trace_brute_plain`, the same arithmetic
  in plain PyTorch, in the same expression order — the executable spec the
  kernel is held to bit for bit on the card.

Traversal is a discrete decision procedure: hits come back detached
(``prim`` int32, ``backface`` bool) and shading re-derives differentiable
hit attributes from the scene tables.  Scenes that would take ``ray_tpu``'s
BVH, wide or binned walks raise ``NotImplementedError`` in this slice.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ray_tpu_torch._roadmap import not_ported
from ray_tpu_torch.ops import cuda_build
from ray_tpu_torch.scene.bvh import MAX_STACK_SIZE


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


def _trace_mode(n_nodes: int, n_tris: int) -> str:
    if n_tris <= BRUTE_MAX_TRIS:
        return "brute"
    raise not_ported(
        f"BVH traversal ({n_tris} triangles, {n_nodes} nodes)",
        "Queue 2 item 2 and Queue 1 item 19")


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


def trace_brute(tris, ro, rd, t_min, t_max, active, any_hit=False) -> Hit:
    """Brute-force trace: (T, 9) f32 packed triangles, (R, 3) f32 ``ro`` /
    ``rd``, (R,) f32 ``t_min`` / ``t_max``, (R,) bool ``active``, all
    contiguous on one device.  CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream."""
    device = ro.device
    for name, x in (("tris", tris), ("rd", rd), ("t_min", t_min),
                    ("t_max", t_max), ("active", active)):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, ro on {device}")
    if device.type == "cpu":
        return trace_brute_plain(tris, ro, rd, t_min, t_max, active, any_hit)
    if device.type != "cuda":
        raise ValueError(f"trace_brute runs on CPU or CUDA, not {device}")
    R = ro.shape[0] if ro.dim() == 2 else -1
    T = tris.shape[0] if tris.dim() == 2 else -1
    _check("tris", tris, torch.float32, (T, 9), device)
    _check("ro", ro, torch.float32, (R, 3), device)
    _check("rd", rd, torch.float32, (R, 3), device)
    _check("t_min", t_min, torch.float32, (R,), device)
    _check("t_max", t_max, torch.float32, (R,), device)
    _check("active", active, torch.bool, (R,), device)
    if T > BRUTE_MAX_TRIS:
        raise ValueError(f"trace_brute takes at most {BRUTE_MAX_TRIS} "
                         f"triangles, got {T}")
    out = Hit(
        t=torch.empty((R,), dtype=torch.float32, device=device),
        prim=torch.empty((R,), dtype=torch.int32, device=device),
        u=torch.empty((R,), dtype=torch.float32, device=device),
        v=torch.empty((R,), dtype=torch.float32, device=device),
        backface=torch.empty((R,), dtype=torch.bool, device=device),
    )
    if R == 0:
        return out
    fn = _brute_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            tris.data_ptr(), T, ro.data_ptr(), rd.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), active.data_ptr(), R,
            out.t.data_ptr(), out.prim.data_ptr(), out.u.data_ptr(),
            out.v.data_ptr(), out.backface.data_ptr(), int(any_hit), stream,
        )
    if err != 0:
        raise RuntimeError(f"trace_brute kernel launch failed: CUDA error {err}")
    cuda_build.launch_counts[
        "trace_brute_anyhit" if any_hit else "trace_brute_closest"] += 1
    return out


def _brute_fn():
    lib = cuda_build.load("trace_brute")
    fn = lib.trace_brute_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, p, ctypes.c_int64,
                       p, p, p, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _trace(bvh, tris, ro, rd, t_min, t_max, active, tri_vis, any_hit):
    if tri_vis is not None:
        raise not_ported("per-ray-type visibility masks", "Queue 1 item 20")
    _trace_mode(bvh["code0"].shape[0], tris["p0x"].shape[0])
    return trace_brute(
        tris["packed"], ro.detach().contiguous(), rd.detach().contiguous(),
        t_min.detach().contiguous(), t_max.detach().contiguous(),
        active.contiguous(), any_hit=any_hit,
    )


def trace_closest_soa(bvh, tris, ro, rd, t_min, t_max, active,
                      max_leaf: int = 4, stack_size: int = MAX_STACK_SIZE,
                      tri_vis=None, ray_mask=None) -> Hit:
    """Closest-hit trace against the scene's SoA node and triangle tables.

    Args:
      bvh: dict of (N,) node columns (``SceneFlat.bvh_soa``).
      tris: dict of (T,) triangle columns + packed (T, 9) rows, leaf order.
      ro, rd: (R, 3) f32; t_min, t_max: (R,) f32; active: (R,) bool.
      tri_vis/ray_mask: per-ray-type visibility (not ported yet).
    """
    return _trace(bvh, tris, ro, rd, t_min, t_max, active, tri_vis, False)


def trace_occlusion_soa(bvh, tris, ro, rd, t_min, t_max, active,
                        max_leaf: int = 4, stack_size: int = MAX_STACK_SIZE,
                        tri_vis=None, ray_mask=None) -> torch.Tensor:
    """Any-hit (shadow) trace: returns (R,) bool ``occluded``."""
    hit = _trace(bvh, tris, ro, rd, t_min, t_max, active, tri_vis, True)
    return hit.prim >= 0
