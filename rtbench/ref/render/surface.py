"""Hit → differentiable surface attributes + material resolution.

The port of ``ray_tpu.render.surface``: barycentric interpolation of
shading normal/UVs from the packed per-triangle row, geometric plane
normal, backface flip + back-material select and the radial tangent frame
— all recomputed from the scene tables, so gradients flow to vertices and
normals through the detached hit record.  In tlas mode the row is in
object space and the hit's instance transform (positions by the matrix,
normals by its inverse transpose) carries it to world space.

``ray_tpu`` reads the packed row with a one-hot matmul (a TPU layout
device); here it is plain indexing, with the same values.  Mix nodes,
transparency, normal maps and the per-material tangent rotation are left
out: finalize refuses scenes that have them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtbench.ref.ops.linalg import cross, dot, safe_normalize


class Surface(NamedTuple):
    """Analogue of the reference's ``surface_t`` (internal/CoreRef.h:108)."""

    P: torch.Tensor        # (R, 3) hit position
    N: torch.Tensor        # (R, 3) shading normal (flipped to front side)
    plane_N: torch.Tensor  # (R, 3) geometric normal (flipped)
    T: torch.Tensor        # (R, 3)
    B: torch.Tensor        # (R, 3)
    uv: torch.Tensor       # (R, 2)
    backfacing: torch.Tensor  # (R,) bool
    tri_area: torch.Tensor    # (R,) world-space triangle area
    lod_base: torch.Tensor    # (R,) 0.5·log2(ta/pa) cone-LOD term


# named pieces of the packed (T, 41) tri_surf row (scene._pack_tri_surf):
# p0 p1 p2 | n0 n1 n2 | uv0 uv1 uv2 | mat_f mat_b | solid_f solid_b |
# light | tanq tanq0 (affine world→object-radial-tangent map)
TRI_PIECES = {
    "p0": (0, 3), "p1": (3, 6), "p2": (6, 9),
    "n0": (9, 12), "n1": (12, 15), "n2": (15, 18),
    "uv0": (18, 20), "uv1": (20, 22), "uv2": (22, 24),
    "mat_f": (24, 25), "mat_b": (25, 26),
    "solid_f": (26, 27), "solid_b": (27, 28),
    "light": (28, 29),
    "tanq": (29, 38), "tanq0": (38, 41),
}


def fetch_tri_pieces(table, prim, keys):
    """Per-hit reads of named pieces of a packed (T, C) row table: one row
    gather over the span the keys need.  Returns {key: (R, k) or (R,)} —
    scalar pieces (k == 1) are squeezed.  Misses (prim < 0) read row 0."""
    i = torch.clamp_min(prim, 0).long()
    a_min = min(TRI_PIECES[k][0] for k in keys)
    b_max = max(TRI_PIECES[k][1] for k in keys)
    rows = table[:, a_min:b_max][i]
    out = {}
    for k in keys:
        a, b = TRI_PIECES[k]
        v = rows[:, a - a_min:b - a_min]
        out[k] = v[:, 0] if b - a == 1 else v
    return out


_DEFAULT_KEYS = tuple(k for k in TRI_PIECES if k not in ("tanq", "tanq0"))


def fetch_tri_row(scene, prim, keys=None):
    """Per-hit surface attributes as a dict of named pieces (see
    ``TRI_PIECES``); default: everything but the tangent map."""
    return fetch_tri_pieces(
        scene.tri_surf, prim, _DEFAULT_KEYS if keys is None else keys
    )


_INST_XFORM_COLS = (
    "m00", "m01", "m02", "mtx", "m10", "m11", "m12", "mty",
    "m20", "m21", "m22", "mtz",
    "inv00", "inv01", "inv02", "inv10", "inv11", "inv12",
    "inv20", "inv21", "inv22", "invtx", "invtz",
)


def fetch_inst_cols(inst, ii):
    """The per-instance transform columns for each lane's instance id."""
    i = ii.long()
    return {n: inst[n][i] for n in _INST_XFORM_COLS}


def _inst_xform_point(cols, p):
    """World-from-object point transform from per-lane columns."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return torch.stack([
        cols["m00"] * x + cols["m01"] * y + cols["m02"] * z + cols["mtx"],
        cols["m10"] * x + cols["m11"] * y + cols["m12"] * z + cols["mty"],
        cols["m20"] * x + cols["m21"] * y + cols["m22"] * z + cols["mtz"],
    ], dim=-1)


def _inst_xform_normal(cols, n):
    """Normal transform = (A⁻¹)ᵀ, from the inverse columns transposed."""
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    return torch.stack([
        cols["inv00"] * x + cols["inv10"] * y + cols["inv20"] * z,
        cols["inv01"] * x + cols["inv11"] * y + cols["inv21"] * z,
        cols["inv02"] * x + cols["inv12"] * y + cols["inv22"] * z,
    ], dim=-1)


def hit_light_id(scene, prim, inst=None, row=None):
    """Light id of an emissive hit triangle (-1 if not a light).  In tlas
    mode it is per (instance, triangle): the instance's light base plus the
    triangle's per-mesh emissive ordinal (row column 28)."""
    if row is None:
        row = fetch_tri_row(scene, prim)
    ids = row["light"].to(torch.int32)
    if scene.mode == "tlas":
        base = scene.inst["light_base"][torch.clamp_min(inst, 0).long()]
        return torch.where((ids >= 0) & (inst >= 0), base + ids, -1).to(
            torch.int32)
    return ids


def compute_surface(scene, prim, u, v, backface, ro, rd, t, inst=None,
                    row=None):
    """Interpolate differentiable surface attributes for hit triangles.
    ``inst``: (R,) instance indices in tlas mode.  ``row``: optional
    pre-fetched :func:`fetch_tri_row` result shared with the other per-hit
    lookups."""
    if row is None:
        row = fetch_tri_row(scene, prim)
    p0, p1, p2 = row["p0"], row["p1"], row["p2"]
    n0, n1, n2 = row["n0"], row["n1"], row["n2"]
    uv0, uv1, uv2 = row["uv0"], row["uv1"], row["uv2"]
    tlas = scene.mode == "tlas"
    if tlas:
        inst_cols = fetch_inst_cols(scene.inst, torch.clamp_min(inst, 0))
        p0 = _inst_xform_point(inst_cols, p0)
        p1 = _inst_xform_point(inst_cols, p1)
        p2 = _inst_xform_point(inst_cols, p2)
        n0 = safe_normalize(_inst_xform_normal(inst_cols, n0))
        n1 = safe_normalize(_inst_xform_normal(inst_cols, n1))
        n2 = safe_normalize(_inst_xform_normal(inst_cols, n2))

    w = (1.0 - u - v)[:, None]
    uc, vc = u[:, None], v[:, None]
    # position from barycentrics keeps the gradient path through geometry
    P = w * p0 + uc * p1 + vc * p2
    N = safe_normalize(w * n0 + uc * n1 + vc * n2)
    uv = w * uv0 + uc * uv1 + vc * uv2

    fwd = cross(p1 - p0, p2 - p0)
    fwd_len = torch.sqrt(torch.clamp_min(dot(fwd, fwd, False), 1e-30))
    plane_N = fwd / fwd_len[:, None]
    tri_area = 0.5 * fwd_len

    # texture-space over world parallelogram area: the geometry half of the
    # ray-cone LOD λ (reference ShadeRef.cpp:1279-1283)
    e1, e2 = uv1 - uv0, uv2 - uv0
    ta = torch.abs(e1[:, 0] * e2[:, 1] - e2[:, 0] * e1[:, 1])
    lod_base = 0.5 * torch.log2(
        torch.clamp_min(ta, 1e-30) / torch.clamp_min(fwd_len, 1e-30)
    )

    flip = backface[:, None]
    N = torch.where(flip, -N, N)
    plane_N = torch.where(flip, -plane_N, plane_N)

    # radial tangent (ShadeRef.cpp:1355-1366): rotate the object-space hit
    # position around Y and carry the direction back to world space.  Tlas
    # mode applies the instance inverse live; flatten mode bakes the affine
    # map Q·P + q0 from the world hit point per triangle
    if tlas:
        iv = inst_cols
        plsx = iv["inv00"] * P[:, 0] + iv["inv01"] * P[:, 1] \
            + iv["inv02"] * P[:, 2] + iv["invtx"]
        plsz = iv["inv20"] * P[:, 0] + iv["inv21"] * P[:, 1] \
            + iv["inv22"] * P[:, 2] + iv["invtz"]
        t_ls = torch.stack([-plsz, torch.zeros_like(plsx), plsx], dim=-1)
        tangent = _inst_xform_normal(inst_cols, t_ls)
    else:
        tq = fetch_tri_pieces(scene.tri_surf, prim, ("tanq", "tanq0"))
        Q = tq["tanq"].reshape(-1, 3, 3)
        tangent = (
            Q[:, :, 0] * P[:, 0:1] + Q[:, :, 1] * P[:, 1:2]
            + Q[:, :, 2] * P[:, 2:3]
        ) + tq["tanq0"]
    tn = cross(tangent, N)
    degenerate = dot(tn, tn, False) < 1e-20
    tangent = torch.where(degenerate[:, None], P, tangent)
    B = safe_normalize(cross(tangent, N))
    T = cross(N, B)

    return Surface(P=P, N=N, plane_N=plane_N, T=T, B=B, uv=uv,
                   backfacing=backface, tri_area=tri_area, lod_base=lod_base)


def pick_hit_material(scene, prim, backface, row=None):
    """Front/back material id per hit (reference tri_mat_data_t select,
    ShadeRef.cpp:1256-1266). Returns -1 where no material applies."""
    if row is None:
        row = fetch_tri_row(scene, prim)
    front = row["mat_f"].to(torch.int32)
    back = row["mat_b"].to(torch.int32)
    return torch.where(backface, back, front)


