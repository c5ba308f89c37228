"""Hit → differentiable surface attributes + material resolution.

The port of ``ray_tpu.render.surface``: barycentric interpolation of
shading normal/UVs from the packed per-triangle row, geometric plane
normal, backface flip + back-material select and the radial tangent frame
— all recomputed from the scene tables, so gradients flow to vertices and
normals through the detached hit record.  In tlas mode the row is in
object space and the hit's instance transform (positions by the matrix,
normals by its inverse transpose) carries it to world space.

``ray_tpu`` reads the packed row with a one-hot matmul (a TPU layout
device); here it is plain indexing, with the same values.  Mix nodes
resolve stochastically to a leaf material (:func:`resolve_mix`, with the
Fresnel factor in the shade stage and without it in the trace stage), and
shadow rays through transparent surfaces take the deterministic
Mix-weighted transparency color (:func:`shadow_transmittance`).  Normal
maps (:func:`apply_normal_map`) and the per-material tangent rotation
(:func:`apply_tangent_rotation`) bend the frame after Mix resolution, in
that order, and are the static pass-throughs they are in ``ray_tpu`` when
no material has them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ray_tpu_torch.ops.linalg import cross, dot, safe_div_pos, safe_normalize
from ray_tpu_torch.render.bsdf.microfacet import fresnel_dielectric_cos
from ray_tpu_torch.scene.materials import MAT_FLAG_MIX_ADD, ShadingNode
from ray_tpu_torch.scene.textures import sample_bilinear, texture_lod

MAX_MIX_DEPTH = 4  # Mix nodes may nest; resolution is unrolled this deep


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
    duv_major_unit: torch.Tensor  # (R, 2) UV direction of the footprint's major axis
    aniso_elong: torch.Tensor     # (R,) footprint elongation 1/|cosθ| - 1
    raw_tangent: torch.Tensor     # (R, 3) unorthonormalized radial tangent


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

    # anisotropic footprint: the view direction projected into the surface
    # plane, mapped world→UV through the triangle edges; detached
    with torch.no_grad():
        cosv = torch.abs(dot(rd, plane_N, False))
        t_w = rd - dot(rd, plane_N) * plane_N
        t_w = t_w / torch.sqrt(torch.clamp_min(dot(t_w, t_w, False), 1e-20))[:, None]
        we1, we2 = p1 - p0, p2 - p0
        g11 = dot(we1, we1, False)
        g12 = dot(we1, we2, False)
        g22 = dot(we2, we2, False)
        b1 = dot(we1, t_w, False)
        b2 = dot(we2, t_w, False)
        det = torch.clamp_min(g11 * g22 - g12 * g12, 1e-20)
        ca = (g22 * b1 - g12 * b2) / det
        cb = (g11 * b2 - g12 * b1) / det
        duv_major_unit = ca[:, None] * e1 + cb[:, None] * e2
        aniso_elong = 1.0 / torch.clamp_min(cosv, 0.05) - 1.0

    return Surface(P=P, N=N, plane_N=plane_N, T=T, B=B, uv=uv,
                   backfacing=backface, tri_area=tri_area, lod_base=lod_base,
                   duv_major_unit=duv_major_unit, aniso_elong=aniso_elong,
                   raw_tangent=tangent)


def apply_tangent_rotation(scene, mat_id, surf: Surface):
    """Per-material tangent rotation about the (possibly normal-mapped)
    shading normal, then the frame rebuilt — ShadeRef.cpp:1362-1366 with
    tangent_rotation = 2π·anisotropic_rotation (SceneCPU.cpp:226,263).
    A static no-op when no material rotates."""
    if not scene.has_aniso_rotation:
        return surf
    rot = scene.materials["anisotropic_rotation"].index_select(
        0, torch.clamp_min(mat_id, 0).long())
    angle = 2.0 * math.pi * torch.clamp(rot, 0.0, 1.0)
    n = surf.N
    t = surf.raw_tangent
    c = torch.cos(angle)[:, None]
    s = torch.sin(angle)[:, None]
    ndt = dot(n, t)
    t_rot = t * c + cross(n, t) * s + n * ndt * (1.0 - c)
    tangent = torch.where((angle != 0.0)[:, None], t_rot, t)
    B = safe_normalize(cross(tangent, n))
    T = cross(n, B)
    return surf._replace(T=T, B=B)


def pick_hit_material(scene, prim, backface, row=None):
    """Front/back material id per hit (reference tri_mat_data_t select,
    ShadeRef.cpp:1256-1266). Returns -1 where no material applies."""
    if row is None:
        row = fetch_tri_row(scene, prim)
    front = row["mat_f"].to(torch.int32)
    back = row["mat_b"].to(torch.int32)
    return torch.where(backface, back, front)


def resolve_mix(scene, mat_id, uv, mix_rand, I, N, ext_ior, backfacing,
                tex_rand, lam=None, fetch_kw=None, use_fresnel=True):
    """Stochastically resolve Mix-node chains (ShadeRef.cpp:1303-1335),
    unrolled ``MAX_MIX_DEPTH`` deep; non-Mix lanes pass through.  Returns
    (leaf_mat_id, rescaled mix_rand, mix_weight) — a static pass-through
    when the scene has no Mix node.  ``use_fresnel=False`` is the trace
    stage's resolve (CoreRef.cpp:3103-3126), which does not scale the mix
    value by the dielectric Fresnel term."""
    if not scene.has_mix:
        return mat_id, mix_rand, torch.ones_like(mix_rand)
    mats = scene.materials
    mix_weight = torch.ones_like(mix_rand)
    for _ in range(MAX_MIX_DEPTH):
        i = torch.clamp_min(mat_id, 0).long()
        mtype_ = mats["type"][i]
        mix_val = mats["strength"].index_select(0, i)
        base_tex = mats["base_texture"][i]
        ior = mats["ior"].index_select(0, i)
        flags_ = mats["flags"][i]
        mm1 = mats["mix_mat1"][i]
        mm2 = mats["mix_mat2"][i]
        is_mix = (mtype_ == ShadingNode.MIX) & (mat_id >= 0)
        if scene.has_textures:
            lod = (None if lam is None
                   else texture_lod(scene.textures, base_tex, lam))
            tex = sample_bilinear(scene.textures, base_tex, uv, lod,
                                  **(fetch_kw or {}))
            mix_val = mix_val * torch.where(base_tex >= 0, tex[:, 0], 1.0)
        if use_fresnel:
            eta = torch.where(backfacing, safe_div_pos(ext_ior, ior),
                              safe_div_pos(ior, ext_ior))
            rr = torch.where(ior != 0.0,
                             fresnel_dielectric_cos(dot(I, N, False), eta),
                             1.0)
            mix_val = mix_val * torch.clamp(rr, 0.0, 1.0)

        mix_add = (flags_ & MAT_FLAG_MIX_ADD) != 0
        take2 = mix_rand <= mix_val
        new_id = torch.where(take2, mm2, mm1)
        w_mult = torch.where(
            mix_add,
            torch.where(take2, safe_div_pos(1.0, mix_val),
                        safe_div_pos(1.0, 1.0 - mix_val)),
            1.0,
        )
        new_rand = torch.where(
            take2,
            safe_div_pos(mix_rand, mix_val),
            safe_div_pos(mix_rand - mix_val, 1.0 - mix_val),
        )
        mat_id = torch.where(is_mix, new_id, mat_id)
        mix_rand = torch.where(is_mix, torch.clamp(new_rand, 0.0, 1.0),
                               mix_rand)
        mix_weight = torch.where(is_mix, mix_weight * w_mult, mix_weight)
    return mat_id, mix_rand, mix_weight


def shadow_transmittance(scene, mat_id, uv, lam=None,
                         depth: int = MAX_MIX_DEPTH):
    """Deterministic Mix-weighted transparency color for shadow rays
    (reference CoreRef.cpp:3213-3250: the shadow loop expands the Mix DAG
    with weights — no Fresnel, no stochastic pick — and sums the
    Transparent leaves' base colors).  Returns (R, 3)."""
    mats = scene.materials
    i = torch.clamp_min(mat_id, 0).long()
    mtype = mats["type"][i]
    bcol = mats["base_color"].index_select(0, i)
    is_transp = (mtype == ShadingNode.TRANSPARENT) & (mat_id >= 0)
    leaf = torch.where(is_transp[:, None], bcol, 0.0)
    if depth == 0 or not scene.has_mix:  # static: Transparent leaves only
        return leaf
    mix_val = mats["strength"].index_select(0, i)
    base_tex = mats["base_texture"][i]
    mm1 = mats["mix_mat1"][i]
    mm2 = mats["mix_mat2"][i]
    is_mix = (mtype == ShadingNode.MIX) & (mat_id >= 0)
    if scene.has_textures:
        lod = None if lam is None else texture_lod(scene.textures, base_tex,
                                                    lam)
        tex = sample_bilinear(scene.textures, base_tex, uv, lod)
        mix_val = mix_val * torch.where(base_tex >= 0, tex[:, 0], 1.0)
    mix_val = torch.clamp(mix_val, 0.0, 1.0)
    t1 = shadow_transmittance(scene, mm1, uv, lam, depth - 1)
    t2 = shadow_transmittance(scene, mm2, uv, lam, depth - 1)
    mixed = (1.0 - mix_val)[:, None] * t1 + mix_val[:, None] * t2
    return torch.where(is_mix[:, None], mixed, leaf)


def apply_normal_map(scene, mat_id, surf: Surface, I, tex_rand, lam=None,
                     fetch_kw=None):
    """Tangent-space normal mapping (z rebuilt from x and y, as a BC5 map
    stores them), blended toward the interpolated normal by
    ``normal_map_intensity``, then ``ray_tpu``'s lite form of Cycles'
    ensure_valid_reflection (the reference's iterative one:
    ShadeRef.cpp:252-352): where the reflection of ``I`` about the new
    normal would dip under the geometric plane, the geometric normal is
    taken.  The frame is rebuilt around the result.  A static no-op when
    no material has a normal map."""
    if not scene.has_normal_maps:
        return surf
    mats = scene.materials
    i = torch.clamp_min(mat_id, 0).long()
    nm = mats["normal_map"][i]
    nm_k = mats["normal_map_intensity"].index_select(0, i)
    has = nm >= 0
    lod = None if lam is None else texture_lod(scene.textures, nm, lam)
    tex = sample_bilinear(scene.textures, nm, surf.uv, lod,
                          **(fetch_kw or {}))
    n_ts = tex[:, :3] * 2.0 - 1.0
    x, y = n_ts[:, 0], n_ts[:, 1]
    z = torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))
    N_new = safe_normalize(
        x[:, None] * surf.T + z[:, None] * surf.N + y[:, None] * surf.B)
    k = nm_k[:, None]
    N_new = safe_normalize(surf.N + (N_new - surf.N) * k)

    # keep reflections valid: fall back to the geometric normal where the
    # reflected view direction would dip below the surface
    refl = I - 2.0 * dot(N_new, I) * N_new
    bad = (dot(surf.plane_N, refl, False)
           < 0.01 * torch.abs(dot(surf.plane_N, I, False)))
    N_fixed = torch.where(bad[:, None], surf.plane_N, N_new)

    N_out = torch.where(has[:, None], N_fixed, surf.N)
    B = safe_normalize(cross(surf.T, N_out))
    T = cross(N_out, B)
    return surf._replace(N=N_out, B=B, T=T)
