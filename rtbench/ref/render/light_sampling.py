"""Next-event estimation: light picking + per-type position sampling.

A frozen copy of ``ray_tpu_torch.render.light_sampling`` cut to the light
types the benchmark's configurations use: emissive-triangle (TRI) lights,
sampled by spherical-triangle solid angle with the uniform-area fallback;
sphere (and spot) lights, sampled over the cone they subtend; and a
constant-color environment light over the hemisphere.  Camera and BSDF
rays hit the visible sphere lights (:func:`intersect_area_lights`).
Lights are picked by the hierarchical light tree (stochastic descent,
leaf→root pdf re-walk) or, on scenes with fewer lights than the tree
threshold, by the power CDF.  In tlas mode a TRI light's world-space
triangle comes from the light table (the scene's vertices are object
space).

``ls.pdf`` is the solid-angle pdf times the light pick probability, so an
NEE contribution is ``ls.col·f_cos/ls.pdf``.  The tree descent is sampling
and runs detached, as in ``ray_tpu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtbench.ref.ops.linalg import (
    MAX_DIST,
    cross,
    dot,
    offset_ray,
    orthonormal_basis,
    safe_div_pos,
    safe_normalize,
    saturate,
    world_from_tangent,
)
from rtbench.ref.render.bsdf.microfacet import PI
from rtbench.ref.render.surface import fetch_tri_pieces
from rtbench.ref.scene.lights import LightType


class LightSample(NamedTuple):
    """Analogue of ``light_sample_t`` (internal/CoreRef.h:123)."""

    col: torch.Tensor       # (R, 3)
    L: torch.Tensor         # (R, 3) direction to light
    lp: torch.Tensor        # (R, 3) point on light (biased off surface)
    area: torch.Tensor      # (R,) 0 → skip MIS (invisible/delta light)
    dist_mul: torch.Tensor  # (R,) shadow-ray length multiplier (env = MAX)
    pdf: torch.Tensor       # (R,) solid-angle pdf × pick probability
    cast_shadow: torch.Tensor  # (R,) bool
    from_env: torch.Tensor     # (R,) bool


# Minimum solid angle to use the spherical parametrization; below it the
# caller falls back to uniform area sampling (Constants.inl:12-13).
SPHERICAL_AREA_THRESHOLD = 5e-5


def _safe_div_signed(a, b, eps=1e-9):
    """a/b with |b| clamped away from zero, preserving b's sign."""
    mag = torch.clamp_min(torch.abs(b), eps)
    return a / torch.where(b < 0.0, -mag, mag)


def _orthogonalize(a, b):
    """Component of b orthogonal to unit a, normalized."""
    return safe_normalize(b - dot(a, b) * a)


def _angle_between(u, v):
    return torch.arccos(torch.clamp(dot(u, v, False), -1.0, 1.0))


def _slerp(a, b, t):
    """Spherical lerp between unit vectors, safe at θ→0."""
    cos_th = torch.clamp(dot(a, b, False), -1.0, 1.0)
    th = torch.arccos(cos_th)
    sin_th = torch.sin(th)
    ok = sin_th > 1e-6
    inv = safe_div_pos(1.0, torch.where(ok, sin_th, torch.ones_like(sin_th)))
    w0 = torch.where(ok, torch.sin((1.0 - t) * th) * inv, 1.0 - t)
    w1 = torch.where(ok, torch.sin(t * th) * inv, t)
    return w0[..., None] * a + w1[..., None] * b


def sample_spherical_triangle(P, p1, p2, p3, r1, r2):
    """Arvo's stratified spherical-triangle sampling (reference
    internal/CoreRef.cpp:1356-1427).  Returns ``(pdf, direction, valid)``:
    pdf = 1/solid-angle, unit direction from P, valid=False below
    SPHERICAL_AREA_THRESHOLD."""
    A = safe_normalize(p1 - P)
    B = safe_normalize(p2 - P)
    C = safe_normalize(p3 - P)

    BA = _orthogonalize(A, B - A)
    CA = _orthogonalize(A, C - A)
    AB = _orthogonalize(B, A - B)
    CB = _orthogonalize(B, C - B)
    BC = _orthogonalize(C, B - C)
    AC = _orthogonalize(C, A - C)

    alpha = _angle_between(BA, CA)
    beta = _angle_between(AB, CB)
    gamma = _angle_between(BC, AC)
    area = alpha + beta + gamma - PI
    valid = area > SPHERICAL_AREA_THRESHOLD
    pdf = safe_div_pos(1.0, torch.clamp_min(area, 1e-12))

    b_arc = torch.arccos(torch.clamp(dot(C, A, False), -1.0, 1.0))
    c_arc = torch.arccos(torch.clamp(dot(A, B, False), -1.0, 1.0))

    area_s = r1 * area
    p_s, q_s = torch.sin(area_s - alpha), torch.cos(area_s - alpha)
    s_alpha, c_alpha = torch.sin(alpha), torch.cos(alpha)
    u_ = q_s - c_alpha
    v_ = p_s + s_alpha * torch.cos(c_arc)
    denom = (v_ * p_s + u_ * q_s) * s_alpha
    ratio = _safe_div_signed((v_ * q_s - u_ * p_s) * c_alpha - v_, denom, 1e-12)
    s = safe_div_pos(1.0, torch.clamp_min(b_arc, 1e-9)) * torch.arccos(
        torch.clamp(ratio, -1.0, 1.0)
    )
    C_s = _slerp(A, C, s)
    cs_b = dot(C_s, B, False)
    denom2 = torch.arccos(torch.clamp(cs_b, -1.0, 1.0))
    t = safe_div_pos(
        torch.arccos(torch.clamp(1.0 - r2 * (1.0 - cs_b), -1.0, 1.0)),
        torch.clamp_min(denom2, 1e-9),
    )
    direction = safe_normalize(_slerp(B, C_s, t))
    return pdf, direction, valid


def _map_to_cone(r1, r2, axis, radius):
    """Concentric disk point on the plane through ``axis``'s endpoint
    (reference CoreRef.cpp map_to_cone)."""
    ox = 2.0 * r1 - 1.0
    oy = 2.0 * r2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    # signed ratio divisions: ox/oy span [-1, 1]
    theta = torch.where(
        use_x,
        0.25 * PI * _safe_div_signed(oy, torch.where(use_x, ox, 1.0)),
        0.5 * PI
        - 0.25 * PI * _safe_div_signed(ox, torch.where(use_x, 1.0, oy)),
    )
    st, ct = torch.sin(theta), torch.cos(theta)
    du = torch.where(zero, 0.0, r * ct)
    dv = torch.where(zero, 0.0, r * st)
    n = safe_normalize(axis)
    t, b = orthonormal_basis(n)
    return axis + radius[..., None] * (du[..., None] * t + dv[..., None] * b)


def _spot_factor(sdot, spot_cos, spot_blend):
    """Spot falloff from -L·dir (reference ShadeRef.cpp:1152-1163); 1 for
    plain sphere lights (spot_cos = -2)."""
    sangle = torch.arccos(saturate(sdot))
    slimit = torch.arccos(torch.clamp(spot_cos, -1.0, 1.0))
    return torch.where(
        spot_cos > -1.5,
        torch.where(
            sdot > 0.0,
            saturate(safe_div_pos(slimit - sangle,
                                  torch.clamp_min(spot_blend, 1e-6))),
            0.0,
        ),
        1.0,
    )


def _lnode_importance(lt, node, P):
    """Importance of light-tree node rows seen from P — the reference's
    8-wide-descent formula (CoreRef.cpp:958-1002): flux attenuated by the
    node's emission cone and 1/d², or plain flux for infinite lights."""
    lo = lt["lo"][node]
    hi = lt["hi"][node]
    axis = lt["axis"][node]
    flux = lt["flux"][node]
    omega_n = lt["omega_n"][node]
    omega_e = lt["omega_e"][node]

    local = lo[..., 0] > -MAX_DIST
    v = P - 0.5 * (lo + hi)
    ext = hi - lo
    extent = 0.5 * torch.sqrt(torch.clamp_min(dot(ext, ext, False), 0.0))
    dist2 = torch.clamp_min(dot(v, v, False), 1e-12)
    dist = torch.sqrt(dist2)
    v_len2 = torch.where(local, torch.maximum(dist2, extent), 1.0)
    cos_w = dot(axis, v, False) / dist
    sin_w = torch.sqrt(torch.clamp_min(1.0 - cos_w * cos_w, 0.0))
    inside = dist2 < extent * extent
    cos_b = torch.where(
        inside, -1.0,
        torch.sqrt(torch.clamp_min(1.0 - (extent * extent) / dist2, 0.0)),
    )
    sin_b = torch.sqrt(torch.clamp_min(1.0 - cos_b * cos_b, 0.0))
    cos_n = torch.cos(omega_n)
    sin_n = torch.sqrt(torch.clamp_min(1.0 - cos_n * cos_n, 0.0))
    cos_e = torch.cos(omega_e)

    def _cos_sub(sa, ca, sb, cb):
        # cos(max(a - b, 0)) — CoreRef.cpp:900-905
        return torch.where(ca > cb, 1.0, ca * cb + sa * sb)

    def _sin_sub(sa, ca, sb, cb):
        return torch.where(ca > cb, 0.0, sa * cb - ca * sb)

    cos_x = _cos_sub(sin_w, cos_w, sin_n, cos_n)
    sin_x = _sin_sub(sin_w, cos_w, sin_n, cos_n)
    cos_omega = _cos_sub(sin_x, cos_x, sin_b, cos_b)
    mul = torch.where(cos_omega > cos_e, cos_omega, 0.0)
    return torch.where(local, flux * mul / v_len2, flux)


def _detached_tree(scene):
    return {k: v.detach() for k, v in scene.light_tree.items()}


def pick_light_tree(scene, P, u):
    """Stochastic top-down descent through the binary light tree.  Returns
    (light_idx i32, pick_pdf f32, rescaled u); pick_pdf == 0 marks a failed
    descent (zero-importance subtree)."""
    lt = _detached_tree(scene)
    P = P.detach()
    shape = P.shape[:-1]
    node = torch.zeros(shape, dtype=torch.int32, device=P.device)
    pdf = torch.ones(shape, dtype=torch.float32, device=P.device)
    failed = torch.zeros(shape, dtype=torch.bool, device=P.device)
    for _ in range(scene.light_tree_depth):
        li = lt["left"][node]
        ri = lt["right"][node]
        internal = li >= 0
        imp_l = _lnode_importance(lt, torch.clamp_min(li, 0), P)
        imp_r = _lnode_importance(lt, torch.clamp_min(ri, 0), P)
        total = imp_l + imp_r
        failed = failed | (internal & (total <= 0.0))
        p_l = safe_div_pos(imp_l, total)
        go_left = u < p_l
        p_take = torch.where(go_left, p_l, 1.0 - p_l)
        u_new = torch.where(
            go_left,
            safe_div_pos(u, p_l),
            safe_div_pos(u - p_l, 1.0 - p_l),
        )
        u = torch.where(internal, torch.clamp(u_new, 0.0, 0.9999999), u)
        node = torch.where(internal, torch.where(go_left, li, ri), node)
        pdf = torch.where(internal, pdf * p_take, pdf)
    light = ~lt["left"][node]  # leaf rows encode ~light_index
    pdf = torch.where(failed, 0.0, pdf)
    return light, pdf, u


def light_pick_pdf(scene, P, light_idx):
    """Probability that NEE light picking selects ``light_idx`` from a
    shading point P: leaf→root re-walk of the tree when hierarchical NEE is
    on, else the static CDF pick pdf."""
    safe_idx = torch.clamp(light_idx, 0, scene.lights["type"].shape[0] - 1)
    if scene.light_tree_depth <= 0:
        return scene.lights["pick_pdf"][safe_idx]
    lt = _detached_tree(scene)
    P = P.detach()
    node = lt["leaf_node"][safe_idx]
    pdf = torch.ones(node.shape, dtype=torch.float32, device=P.device)
    for _ in range(scene.light_tree_depth):
        par = lt["parent"][node]
        side = lt["side"][node]
        has = par >= 0
        pn = torch.clamp_min(par, 0)
        # a parent is internal, so its child codes are node indices
        li = torch.clamp_min(lt["left"][pn], 0)
        ri = torch.clamp_min(lt["right"][pn], 0)
        imp_l = _lnode_importance(lt, li, P)
        imp_r = _lnode_importance(lt, ri, P)
        total = imp_l + imp_r
        mine = torch.where(side == 1, imp_r, imp_l)
        pdf = torch.where(has, pdf * safe_div_pos(mine, total), pdf)
        node = torch.where(has, pn, node)
    return pdf


def sample_light_source(scene, P, T, B, N, rand_pick, rand_uv):
    """Sample one light for each of R shading points.  Returns a
    :class:`LightSample`; ``pdf == 0`` marks a failed/absent sample."""
    lights = scene.lights
    R = P.shape[0]
    nl = lights["type"].shape[0]
    # the scene's static light-type set: absent types cost nothing
    kinds = {k for (k, _v, _d, _p) in scene.light_kinds}
    has_sphere = LightType.SPHERE in kinds
    has_tri = LightType.TRI in kinds
    has_env = LightType.ENV in kinds

    if scene.light_tree_depth > 0:
        # hierarchical pick (reference USE_HIERARCHICAL_NEE path)
        idx, pick_pdf, _ = pick_light_tree(scene, P, rand_pick)
        idx = torch.clamp(idx, 0, nl - 1)
    else:
        # pick by CDF (flux-proportional limit of the tree)
        idx = torch.searchsorted(lights["pick_cdf"], rand_pick.contiguous(),
                                 right=True).to(torch.int32)
        idx = torch.clamp(idx, 0, nl - 1)
        pick_pdf = lights["pick_pdf"][idx]

    def col(name):
        return lights[name][idx]

    ltype = col("type")
    lcol = col("col")
    cast_shadow = col("cast_shadow")

    r1 = rand_uv[..., 0]
    r2 = rand_uv[..., 1]

    dev = P.device
    out_col = lcol
    out_L = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    out_lp = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    out_area = torch.zeros((R,), dtype=torch.float32, device=dev)
    out_pdf = torch.zeros((R,), dtype=torch.float32, device=dev)
    out_distmul = torch.ones((R,), dtype=torch.float32, device=dev)
    out_fromenv = torch.zeros((R,), dtype=torch.bool, device=dev)

    if has_sphere:
        # ---- sphere (incl. spot) — CoreRef.cpp:3322-3368 ----
        lpos = col("pos")
        ldir = col("dir")
        radius = col("radius")
        visible = col("visible")
        to_c = lpos - P
        d = torch.sqrt(torch.clamp_min(dot(to_c, to_c, False), 1e-30))
        light_normal = to_c / d[:, None]
        outside = d > radius
        temp = torch.sqrt(torch.clamp_min(d * d - radius * radius, 0.0))
        disk_radius = safe_div_pos(temp * radius, d)
        disk_dist = torch.where(radius > 0.0,
                                safe_div_pos(temp * disk_radius, radius), d)
        cone_pt = _map_to_cone(r1, r2, disk_dist[:, None] * light_normal,
                               disk_radius)
        cone_len = torch.sqrt(torch.clamp_min(dot(cone_pt, cone_pt, False),
                                              1e-30))
        sph_L = cone_pt / cone_len[:, None]
        # project the sampled direction onto the sphere surface
        b_q = dot(sph_L, -to_c, False)
        c_q = dot(to_c, to_c, False) - radius * radius
        disc = torch.clamp_min(b_q * b_q - c_q, 0.0)
        ls_dist = -b_q - torch.sqrt(disc)
        sph_surf = P + sph_L * ls_dist[:, None]
        sph_fwd = safe_normalize(sph_surf - lpos)
        sampled_area = PI * disk_radius * disk_radius
        cos_theta_s = dot(sph_L, light_normal, False)
        sph_pdf = torch.where(
            radius > 0.0,
            safe_div_pos(cone_len * cone_len,
                         sampled_area * torch.clamp_min(cos_theta_s, 1e-7)),
            safe_div_pos(cone_len * cone_len, PI),
        )
        sph_lp = torch.where((radius > 0.0)[:, None],
                             offset_ray(sph_surf, sph_fwd), lpos)
        spot = _spot_factor(-dot(sph_L, ldir, False), col("spot_cos"),
                            col("spot_blend"))
        is_sph = ltype == LightType.SPHERE
        sph_ok = is_sph & outside
        out_L = torch.where(sph_ok[:, None], sph_L, out_L)
        out_lp = torch.where(sph_ok[:, None], sph_lp, out_lp)
        out_pdf = torch.where(sph_ok, sph_pdf, out_pdf)
        out_area = torch.where(sph_ok & visible, sampled_area, out_area)
        out_col = torch.where(is_sph[:, None], out_col * spot[:, None],
                              out_col)

    if has_tri:
        # ---- triangle — CoreRef.cpp:3507-3577 ----
        doublesided = col("doublesided")
        if scene.mode == "tlas":
            # the scene's vertices are object space under instancing: the
            # light table carries the world-space triangle
            tp0, tp1, tp2 = col("tp0"), col("tp1"), col("tp2")
        else:
            tri = torch.clamp_min(col("tri_index"), 0)
            trow = fetch_tri_pieces(scene.tri_surf, tri, ("p0", "p1", "p2"))
            tp0, tp1, tp2 = trow["p0"], trow["p1"], trow["p2"]
        tfwd = cross(tp1 - tp0, tp2 - tp0)
        tfwd_len = torch.sqrt(torch.clamp_min(dot(tfwd, tfwd, False), 1e-30))
        tri_fwd = tfwd / tfwd_len[:, None]
        tri_area = 0.5 * tfwd_len
        # spherical-triangle (Arvo) solid-angle sampling with uniform-area
        # fallback (CoreRef.cpp:3530-3556)
        st_pdf, st_L, st_ok = sample_spherical_triangle(P, tp0, tp1, tp2, r1, r2)
        te1 = tp1 - tp0
        te2 = tp2 - tp0
        st_pvec = cross(st_L, te2)
        st_tvec = P - tp0
        st_qvec = cross(st_tvec, te1)
        st_det = dot(te1, st_pvec, False)
        st_inv = _safe_div_signed(1.0, st_det, 1e-12)
        st_u = dot(st_tvec, st_pvec, False) * st_inv
        st_v = dot(st_L, st_qvec, False) * st_inv
        st_lp = (
            (1.0 - st_u - st_v)[:, None] * tp0
            + st_u[:, None] * tp1
            + st_v[:, None] * tp2
        )
        sr1 = torch.sqrt(torch.clamp_min(r1, 0.0))
        tlp_area = (
            tp0 * (1.0 - sr1)[:, None]
            + sr1[:, None] * (tp1 * (1.0 - r2)[:, None] + tp2 * r2[:, None])
        )
        tlp = torch.where(st_ok[:, None], st_lp, tlp_area)
        tvec = tlp - P
        tdist = torch.sqrt(torch.clamp_min(dot(tvec, tvec, False), 1e-30))
        tL = torch.where(st_ok[:, None], st_L, tvec / tdist[:, None])
        tcos = -dot(tL, tri_fwd, False)
        tcos_eff = torch.where(doublesided, torch.abs(tcos), tcos)
        tri_ok = (ltype == LightType.TRI) & (tcos_eff > 0.0)
        tri_pdf = torch.where(
            st_ok,
            st_pdf,
            safe_div_pos(tdist * tdist, tri_area * torch.clamp_min(tcos_eff, 1e-9)),
        )
        tri_side = torch.where((tcos >= 0.0)[:, None], tri_fwd, -tri_fwd)
        out_L = torch.where(tri_ok[:, None], tL, out_L)
        out_lp = torch.where(tri_ok[:, None], offset_ray(tlp, tri_side), out_lp)
        out_pdf = torch.where(tri_ok, tri_pdf, out_pdf)
        out_area = torch.where(tri_ok, tri_area, out_area)

    if has_env:
        # ---- env — CoreRef.cpp:3578-3611: a constant color, uniform
        # over the hemisphere ----
        phi_e = 2.0 * PI * r2
        spe, cpe = torch.sin(phi_e), torch.cos(phi_e)
        de = torch.sqrt(torch.clamp_min(1.0 - r1 * r1, 0.0))
        env_ts = torch.stack([de * cpe, de * spe, r1], dim=-1)
        env_L = world_from_tangent(T, B, N, env_ts)
        env_pdf_sa = torch.full(r1.shape, 0.5 / PI, dtype=torch.float32,
                                device=dev)
        is_env = ltype == LightType.ENV
        # radiance comes from env_color; the table color only weights picks
        out_col = torch.where(is_env[:, None], env_color(scene, env_L), out_col)
        out_L = torch.where(is_env[:, None], env_L, out_L)
        out_lp = torch.where(is_env[:, None], P + env_L, out_lp)
        out_pdf = torch.where(is_env, env_pdf_sa, out_pdf)
        out_area = torch.where(is_env, 1.0, out_area)
        out_distmul = torch.where(is_env, MAX_DIST, out_distmul)
        out_fromenv = out_fromenv | is_env

    # fold in pick probability (reference: ls.pdf /= factor)
    out_pdf = out_pdf * pick_pdf

    return LightSample(
        col=out_col,
        L=out_L,
        lp=out_lp,
        area=out_area,
        dist_mul=out_distmul,
        pdf=out_pdf,
        cast_shadow=cast_shadow,
        from_env=out_fromenv,
    )


def env_color(scene, L):
    """Environment radiance along L: the constant color (reference
    Evaluate_EnvColor, ShadeRef.cpp:1038-1076, without a map)."""
    return scene.env_col.expand(L.shape)


def intersect_area_lights(scene, ro, rd, t_max):
    """Closest visible analytic light along each ray (reference
    IntersectAreaLights, internal/CoreRef.cpp:3616): every visible sphere
    light against all rays.  Returns ``(t, light_idx,
    pdf, spot)``: hit distance (inf if none), light id (-1), the NEE pdf of
    that hit × the pick probability from ``ro`` (the MIS weight's input,
    reference Evaluate_LightColor, ShadeRef.cpp:1080-1170), and the spot
    factor."""
    L = scene.lights
    R = ro.shape[0]
    dev = ro.device
    best_t = torch.full((R,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_pdf = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_spot = torch.ones((R,), dtype=torch.float32, device=dev)
    ones = torch.ones((R,), dtype=torch.float32, device=dev)

    for i, (ltype, visible, dsd, _portal) in enumerate(scene.light_kinds):
        if not visible or ltype != LightType.SPHERE:
            continue
        col_pos = L["pos"][i]
        radius = L["radius"][i]
        oc = ro - col_pos[None, :]
        b = dot(rd, oc, False)
        c = dot(oc, oc, False) - radius * radius
        disc = b * b - c
        t_hit = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        ok = (disc >= 0.0) & (t_hit > 0.0) & (t_hit < t_max)
        # NEE pdf of this direction (the sampler's solid-angle disk
        # form, so that the MIS weights cancel)
        d2 = dot(oc, oc, False)
        d = torch.sqrt(torch.clamp_min(d2, 1e-12))
        temp = torch.sqrt(torch.clamp_min(d2 - radius * radius, 0.0))
        disk_r = safe_div_pos(temp * radius, d)
        disk_dist = safe_div_pos(temp * disk_r,
                                 torch.clamp_min(radius, 1e-9))
        area = PI * disk_r * disk_r
        ln = -oc / d[:, None]
        cos_theta = dot(rd, ln, False)
        pdf = safe_div_pos(disk_dist * disk_dist,
                           area * torch.clamp_min(cos_theta, 1e-9))
        spot = _spot_factor(-dot(rd, L["dir"][i][None, :], False),
                            L["spot_cos"][i], L["spot_blend"][i])
        closer = ok & (t_hit < best_t)
        best_t = torch.where(closer, t_hit, best_t)
        best_i = torch.where(closer, i, best_i)
        best_pdf = torch.where(closer, pdf, best_pdf)
        best_spot = torch.where(closer, spot, best_spot)

    # fold in the pick probability from the ray origin
    best_pdf = best_pdf * light_pick_pdf(scene, ro, best_i)
    return best_t, best_i, best_pdf, best_spot


def tri_light_hit_pdf(scene, prim, t, I, pick_pdf_of_light, light_id=None,
                      ro=None):
    """Solid-angle pdf of having NEE-sampled the emissive triangle that a
    BSDF ray just hit — for the MIS weight at emissive hits (reference
    ShadeRef.cpp:1502-1537): spherical-triangle solid angle from the ray
    origin when above threshold, uniform-area form otherwise.  In tlas mode
    the world-space triangle comes from the light table (``light_id``)."""
    if scene.mode == "tlas":
        lid = torch.clamp_min(light_id, 0).long()
        p0 = scene.lights["tp0"][lid]
        p1 = scene.lights["tp1"][lid]
        p2 = scene.lights["tp2"][lid]
    else:
        trow = fetch_tri_pieces(scene.tri_surf, prim, ("p0", "p1", "p2"))
        p0, p1, p2 = trow["p0"], trow["p1"], trow["p2"]
    fwd = cross(p1 - p0, p2 - p0)
    fwd_len = torch.sqrt(torch.clamp_min(dot(fwd, fwd, False), 1e-30))
    tri_fwd = fwd / fwd_len[:, None]
    area = 0.5 * fwd_len
    cos_theta = torch.abs(dot(I, tri_fwd, False))
    den = area * torch.clamp_min(cos_theta, 1e-9)
    t2 = t * t
    # a miss's t² overflows: no gradient reaches the denominator there
    # (-inf/den² times the lane's zero gradient would be NaN)
    den = torch.where(torch.isfinite(t2), den, den.detach())
    pdf = safe_div_pos(t2, den)
    if ro is not None:
        zero = torch.zeros_like(t)
        st_pdf, _, st_ok = sample_spherical_triangle(ro, p0, p1, p2, zero, zero)
        pdf = torch.where(st_ok, st_pdf, pdf)
    return pdf * pick_pdf_of_light


