"""Ray/primitive intersection primitives (broadcast over wavefronts).

The port of ``ray_tpu.ops.intersect``: Möller–Trumbore straight from the
vertex buffer, with the signed-determinant backface convention.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.linalg import cross, dot

# det == 0.0 exactly is the only degenerate case: any absolute epsilon would
# reject small triangles (see ray_tpu/ops/intersect.py HIT_EPS)
HIT_EPS = 0.0


def intersect_aabb(ro, inv_d, box_lo, box_hi, t_min, t_max):
    """Slab test.  Returns (hit, t_near); ``inv_d`` from
    :func:`~ray_tpu_torch.ops.linalg.safe_invert`.  The 1.00000024 factor
    is the conservative-traversal slack (Ize, "Robust BVH Ray
    Traversal")."""
    lo_t = (box_lo - ro) * inv_d
    hi_t = (box_hi - ro) * inv_d
    near = torch.minimum(lo_t, hi_t)
    far = torch.maximum(lo_t, hi_t)
    tn = torch.maximum(near.amax(dim=-1), t_min)
    tf = torch.minimum(far.amin(dim=-1), t_max)
    return tn <= tf * 1.00000024, tn


def intersect_tri(ro, rd, p0, p1, p2, t_min, t_max):
    """Möller–Trumbore ray/triangle test.

    All inputs broadcast; returns (hit, t, u, v, backface) where ``u, v`` are
    barycentrics of p1/p2 and ``backface`` is True when the ray hits the CW
    side (negative determinant).
    """
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = cross(rd, e2)
    det = dot(e1, pvec, keepdims=False)
    valid_det = det != 0.0
    inv_det = torch.reciprocal(torch.where(valid_det, det, torch.ones_like(det)))
    tvec = ro - p0
    u = dot(tvec, pvec, keepdims=False) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec, keepdims=False) * inv_det
    t = dot(e2, qvec, keepdims=False) * inv_det
    hit = (
        valid_det
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v, det < 0.0
