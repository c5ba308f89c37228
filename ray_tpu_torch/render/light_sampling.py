"""Next-event estimation: light picking + per-type position sampling.

The port of ``ray_tpu.render.light_sampling``: emissive-triangle (TRI)
lights, sampled by spherical-triangle solid angle with the uniform-area
fallback; sphere (and spot) lights, sampled over the cone they subtend;
directional lights over their angular cone; rect lights by spherical-
rectangle solid angle (Ureña) with the uniform-area fallback; disk lights
by area (concentric map); line lights over their cylinder; a constant-
color environment light over the hemisphere, and a latlong environment
map importance-sampled through its marginal / conditional CDF tables
(:func:`sample_env_importance`, :func:`env_hit_pdf`); and sky portals —
rect or disk windows that emit the environment seen through them and
block environment shadow rays one-sidedly (:func:`portal_shadow_block`).
Camera and BSDF rays hit the visible sphere, rect, disk and line lights
(:func:`intersect_area_lights`).  Lights are picked by the hierarchical
light tree (stochastic descent, leaf→root pdf re-walk) or, on scenes with
fewer lights than the tree threshold, by the power CDF.  In tlas mode a
TRI light's world-space triangle comes from the light table (the scene's
vertices are object space).

``ls.pdf`` is the solid-angle pdf times the light pick probability, so an
NEE contribution is ``ls.col·f_cos/ls.pdf``.  The tree descent is sampling
and runs detached, as in ``ray_tpu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ray_tpu_torch.ops.linalg import (
    HIT_BIAS,
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
from ray_tpu_torch.render.bsdf.microfacet import PI
from ray_tpu_torch.render.surface import fetch_tri_pieces
from ray_tpu_torch.scene.lights import LightType
from ray_tpu_torch.scene.textures import sample_bilinear


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


def sample_spherical_rectangle(P, light_pos, axis_u, axis_v, r1, r2):
    """Ureña et al.'s area-preserving spherical-rectangle parametrization:
    uniform solid-angle sampling of a rect light (reference
    internal/CoreRef.cpp:1288-1354).  ``axis_u``/``axis_v`` are the full
    (unnormalized) edge vectors.  Returns ``(pdf, point, valid)``: pdf =
    1/solid-angle, the world-space sample point, valid=False below
    SPHERICAL_AREA_THRESHOLD (the caller falls back to area sampling)."""
    corner = light_pos - 0.5 * axis_u - 0.5 * axis_v
    ulen2 = torch.clamp_min(dot(axis_u, axis_u, False), 1e-30)
    vlen2 = torch.clamp_min(dot(axis_v, axis_v, False), 1e-30)
    ulen = torch.sqrt(ulen2)
    vlen = torch.sqrt(vlen2)
    x_ax = axis_u / ulen[..., None]
    y_ax = axis_v / vlen[..., None]
    z_ax = cross(x_ax, y_ax)

    d0 = corner - P
    z0 = dot(d0, z_ax, False)
    # flip z to point against the shading point
    flip = z0 > 0.0
    z_ax = torch.where(flip[..., None], -z_ax, z_ax)
    z0 = torch.where(flip, -z0, z0)
    x0 = dot(d0, x_ax, False)
    y0 = dot(d0, y_ax, False)
    x1 = x0 + ulen
    y1 = y0 + vlen

    # internal angles (gamma_i) from the plane normals of the 4 edges
    diff0, diff1, diff2, diff3 = x0 - x1, y1 - y0, x1 - x0, y0 - y1
    nz0, nz1, nz2, nz3 = y0 * diff0, x1 * diff1, y1 * diff2, x0 * diff3
    z0sq = z0 * z0

    def _nrm(nz, df):
        return nz * torch.rsqrt(torch.clamp_min(z0sq * df * df + nz * nz,
                                                1e-30))

    nz0 = _nrm(nz0, diff0)
    nz1 = _nrm(nz1, diff1)
    nz2 = _nrm(nz2, diff2)
    nz3 = _nrm(nz3, diff3)
    g0 = torch.arccos(torch.clamp(-nz0 * nz1, -1.0, 1.0))
    g1 = torch.arccos(torch.clamp(-nz1 * nz2, -1.0, 1.0))
    g2 = torch.arccos(torch.clamp(-nz2 * nz3, -1.0, 1.0))
    g3 = torch.arccos(torch.clamp(-nz3 * nz0, -1.0, 1.0))

    b0, b1 = nz0, nz2
    k = 2.0 * PI - g2 - g3
    area = g0 + g1 - k
    valid = area > SPHERICAL_AREA_THRESHOLD
    pdf = safe_div_pos(1.0, torch.clamp_min(area, 1e-12))

    # sample: cu → xu, then hv → yv (Ureña's marginal/conditional inversion)
    au = r1 * area + k
    sau, cau = torch.sin(au), torch.cos(au)
    fu = _safe_div_signed(cau * b0 - b1, sau)
    cu = torch.where(fu > 0.0, 1.0, -1.0) * torch.rsqrt(
        torch.clamp_min(fu * fu + b0 * b0, 1e-30))
    cu = torch.clamp(cu, -1.0, 1.0)
    xu = -(cu * z0) / torch.clamp_min(
        torch.sqrt(torch.clamp_min(1.0 - cu * cu, 0.0)), 1e-7)
    xu = torch.minimum(torch.maximum(xu, x0), x1)
    d_ = torch.sqrt(torch.clamp_min(xu * xu + z0sq, 1e-30))
    h0 = y0 * torch.rsqrt(torch.clamp_min(d_ * d_ + y0 * y0, 1e-30))
    h1 = y1 * torch.rsqrt(torch.clamp_min(d_ * d_ + y1 * y1, 1e-30))
    hv = h0 + r2 * (h1 - h0)
    hv2 = hv * hv
    yv = torch.where(
        hv2 < 1.0 - 1e-6,
        (hv * d_) * torch.rsqrt(torch.clamp_min(1.0 - hv2, 1e-12)),
        y1,
    )
    p = (P + xu[..., None] * x_ax + yv[..., None] * y_ax
         + z0[..., None] * z_ax)
    return pdf, p, valid


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


def sample_light_source(scene, P, T, B, N, rand_pick, rand_uv,
                        no_sphrect: bool = False):
    """Sample one light for each of R shading points.  Returns a
    :class:`LightSample`; ``pdf == 0`` marks a failed/absent sample.
    ``no_sphrect`` (a PassSettings debug toggle) forces uniform-area rect
    sampling."""
    lights = scene.lights
    R = P.shape[0]
    nl = lights["type"].shape[0]
    # the scene's static light-type set: absent types cost nothing
    kinds = {k for (k, _v, _d, _p) in scene.light_kinds}
    has_sphere = LightType.SPHERE in kinds
    has_dir = LightType.DIR in kinds
    has_rect = LightType.RECT in kinds
    has_disk = LightType.DISK in kinds
    has_line = LightType.LINE in kinds
    has_tri = LightType.TRI in kinds
    has_env = LightType.ENV in kinds
    has_portal = any(p for (_k, _v, _d, p) in scene.light_kinds)

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

    if has_dir:
        # ---- directional — CoreRef.cpp:3369-3391 ----
        ldir = col("dir")
        visible = col("visible")
        tan_angle = torch.tan(torch.deg2rad(col("angle")) * 0.5)
        has_spread = tan_angle != 0.0
        cone = _map_to_cone(r1, r2, ldir, tan_angle)
        dir_L = torch.where(has_spread[:, None], safe_normalize(cone), ldir)
        dir_area = torch.where(has_spread, PI * tan_angle * tan_angle, 0.0)
        dir_cos = dot(dir_L, ldir, False)
        dir_pdf = torch.where(
            has_spread,
            safe_div_pos(1.0, dir_area * torch.clamp_min(dir_cos, 1e-7)), 1.0)
        is_dir = ltype == LightType.DIR
        out_L = torch.where(is_dir[:, None], dir_L, out_L)
        out_lp = torch.where(is_dir[:, None], P + dir_L, out_lp)
        out_pdf = torch.where(is_dir, dir_pdf, out_pdf)
        out_area = torch.where(is_dir & visible, dir_area, out_area)
        out_distmul = torch.where(is_dir, MAX_DIST, out_distmul)

    if has_rect:
        # ---- rect — CoreRef.cpp:3392-3422: spherical-rectangle (Ureña)
        # solid-angle sampling, uniform area sampling when the subtended
        # solid angle is tiny (USE_SPHERICAL_AREA_LIGHT_SAMPLING) ----
        lpos = col("pos")
        width = col("width")
        height = col("height")
        visible = col("visible")
        doublesided = col("doublesided")
        rect_u = col("u") * width[:, None]
        rect_v = col("v") * height[:, None]
        rect_fwd = safe_normalize(cross(rect_u, rect_v))
        sr_pdf, sr_p, sr_ok = sample_spherical_rectangle(
            P, lpos, rect_u, rect_v, r1, r2)
        if no_sphrect:
            sr_ok = torch.zeros_like(sr_ok)
        rp_area = (lpos + rect_u * (r1 - 0.5)[:, None]
                   + rect_v * (r2 - 0.5)[:, None])
        rp = torch.where(sr_ok[:, None], sr_p, rp_area)
        rvec = rp - P
        rdist = torch.sqrt(torch.clamp_min(dot(rvec, rvec, False), 1e-30))
        rect_L = rvec / rdist[:, None]
        rect_area = width * height
        rcos = dot(-rect_L, rect_fwd, False)
        rcos_eff = torch.where(doublesided, torch.abs(rcos), rcos)
        rect_ok = (ltype == LightType.RECT) & (rcos_eff > 0.0)
        rect_pdf = torch.where(
            sr_ok, sr_pdf,
            safe_div_pos(rdist * rdist,
                         rect_area * torch.clamp_min(rcos_eff, 1e-9)))
        rect_side = torch.where((rcos > 0.0)[:, None], rect_fwd, -rect_fwd)
        out_L = torch.where(rect_ok[:, None], rect_L, out_L)
        out_lp = torch.where(rect_ok[:, None], offset_ray(rp, rect_side),
                             out_lp)
        out_pdf = torch.where(rect_ok, rect_pdf, out_pdf)
        out_area = torch.where(rect_ok & visible, rect_area, out_area)

    if has_disk:
        # ---- disk — CoreRef.cpp:3423-3466: area sampling through the
        # concentric map (signed ratio divisions: ox/oy span [-1, 1]) ----
        lpos = col("pos")
        lu = col("u")
        lv = col("v")
        width = col("width")
        height = col("height")
        visible = col("visible")
        doublesided = col("doublesided")
        ox = 2.0 * r1 - 1.0
        oy = 2.0 * r2 - 1.0
        use_x = torch.abs(ox) > torch.abs(oy)
        rr = torch.where(use_x, ox, oy)
        th = torch.where(
            use_x,
            0.25 * PI * _safe_div_signed(oy, torch.where(use_x, ox, 1.0)),
            0.5 * PI
            - 0.25 * PI * _safe_div_signed(ox, torch.where(use_x, 1.0, oy)),
        )
        sth, cth = torch.sin(th), torch.cos(th)
        zero_off = (ox == 0.0) & (oy == 0.0)
        du = torch.where(zero_off, 0.0, 0.5 * rr * cth)
        dv = torch.where(zero_off, 0.0, 0.5 * rr * sth)
        dp = lpos + lu * (du * width)[:, None] + lv * (dv * height)[:, None]
        disk_fwd = safe_normalize(cross(lu, lv))
        dvec = dp - P
        ddist = torch.sqrt(torch.clamp_min(dot(dvec, dvec, False), 1e-30))
        dL = dvec / ddist[:, None]
        disk_area = 0.25 * PI * width * height
        dcos = dot(-dL, disk_fwd, False)
        dcos_eff = torch.where(doublesided, torch.abs(dcos), dcos)
        disk_ok = (ltype == LightType.DISK) & (dcos_eff > 0.0)
        disk_pdf = safe_div_pos(ddist * ddist,
                                disk_area * torch.clamp_min(dcos_eff, 1e-9))
        disk_side = torch.where((dcos > 0.0)[:, None], disk_fwd, -disk_fwd)
        out_L = torch.where(disk_ok[:, None], dL, out_L)
        out_lp = torch.where(disk_ok[:, None], offset_ray(dp, disk_side),
                             out_lp)
        out_pdf = torch.where(disk_ok, disk_pdf, out_pdf)
        out_area = torch.where(disk_ok & visible, disk_area, out_area)

    if has_line:
        # ---- line — CoreRef.cpp:3467-3506: a point on the cylinder's
        # half facing P ----
        lpos = col("pos")
        lv = col("v")
        radius = col("radius")
        height = col("height")
        visible = col("visible")
        c2s = P - lpos
        line_u = safe_normalize(cross(c2s, lv))
        line_v2 = cross(line_u, lv)
        phi = PI * r1
        sphl, cphl = torch.sin(phi), torch.cos(phi)
        line_n = cphl[:, None] * line_u + sphl[:, None] * line_v2
        lp_line = (lpos + line_n * radius[:, None]
                   + (r2 - 0.5)[:, None] * lv * height[:, None])
        lvec = lp_line - P
        ldist = torch.sqrt(torch.clamp_min(dot(lvec, lvec, False), 1e-30))
        lL = lvec / ldist[:, None]
        line_area = 2.0 * PI * radius * height
        lcos = 1.0 - torch.abs(dot(lL, lv, False))
        line_ok = (ltype == LightType.LINE) & (lcos != 0.0)
        line_pdf = safe_div_pos(ldist * ldist,
                                line_area * torch.clamp_min(lcos, 1e-9))
        out_L = torch.where(line_ok[:, None], lL, out_L)
        out_lp = torch.where(line_ok[:, None], lp_line, out_lp)
        out_pdf = torch.where(line_ok, line_pdf, out_pdf)
        out_area = torch.where(line_ok & visible, line_area, out_area)

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
        # ---- env — CoreRef.cpp:3578-3611: importance-sampled from the
        # latlong CDF tables when a map exists, uniform hemisphere
        # otherwise ----
        if scene.env_tab_h > 0:
            env_L, env_pdf_sa = sample_env_importance(scene, r1, r2)
        else:
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

    if has_portal:
        # sky portals: a rect/disk window that emits the environment seen
        # through it (CoreRef.cpp:3406-3419: ls.col *= env, ls.from_env)
        is_portal = col("portal") & ((ltype == LightType.RECT)
                                     | (ltype == LightType.DISK))
        out_col = torch.where(is_portal[:, None],
                              out_col * env_color(scene, out_L), out_col)
        out_fromenv = out_fromenv | is_portal

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
    """Environment radiance along L: the constant color times, with a map,
    the latlong texture turned by ``env_rotation`` about +y (reference
    Evaluate_EnvColor, ShadeRef.cpp:1038-1076), bilinear at level 0."""
    col = scene.env_col.expand(L.shape)
    if scene.env_tab_h <= 0:  # static: no env map in this scene
        return col
    has_map = scene.env_map >= 0
    uv = torch.stack(_latlong_uv(scene, L), dim=-1)
    tex_id = torch.where(has_map, scene.env_map, 0).expand(L.shape[:-1])
    tex = sample_bilinear(scene.textures, tex_id.contiguous(), uv)
    return torch.where(has_map, col * tex[..., :3], col)


def _latlong_uv(scene, L):
    """The latlong coordinates (u, v) in [0, 1] of directions L under the
    environment's rotation about +y."""
    rot = scene.env_rotation
    x = L[..., 0] * torch.cos(rot) - L[..., 2] * torch.sin(rot)
    z = L[..., 0] * torch.sin(rot) + L[..., 2] * torch.cos(rot)
    theta = torch.arccos(torch.clamp(L[..., 1], -1.0, 1.0)) / PI
    phi = torch.atan2(z, x)
    return torch.where(phi < 0.0, phi + 2.0 * PI, phi) / (2.0 * PI), theta


def _bits(n):
    b = 0
    while (1 << b) < n:
        b += 1
    return b


def _search_cdf(gather, length, r):
    """Vectorised binary search: the smallest i with cdf[i] > r, by
    ``_bits(length)`` gathers (``gather(i)`` returns the cdf at an (R,)
    index array), as ``ray_tpu``'s, so the texel picked is its index."""
    lo = torch.zeros(r.shape, dtype=torch.int32, device=r.device)
    hi = torch.full_like(lo, length)
    for _ in range(_bits(length)):
        mid = (lo + hi) >> 1
        v = gather(torch.clamp(mid, 0, length - 1).long())
        go_right = v <= r
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return torch.clamp(lo, 0, length - 1)


def sample_env_importance(scene, r1, r2):
    """Inverse-transform sample of the latlong environment's luminance CDF
    (``ray_tpu``'s counterpart of the reference's ``Sample_EnvQTree``):
    a row by the marginal CDF with ``r1``, a column by that row's
    conditional CDF with ``r2``, the remainders placing the direction
    inside the texel.  Returns (L, pdf over solid angle)."""
    H, W = scene.env_tab_h, scene.env_tab_w
    marg = scene.env_marginal_cdf
    cond = scene.env_cond_cdf

    y = _search_cdf(lambda i: marg[i], H, r1)
    yl = y.long()
    y_lo = torch.where(y > 0, marg[torch.clamp_min(yl - 1, 0)], 0.0)
    y_w = torch.clamp_min(marg[yl] - y_lo, 1e-12)
    fy = saturate((r1 - y_lo) / y_w)

    x = _search_cdf(lambda i: cond[yl * W + i], W, r2)
    xl = x.long()
    x_lo = torch.where(x > 0, cond[yl * W + torch.clamp_min(xl - 1, 0)], 0.0)
    x_w = torch.clamp_min(cond[yl * W + xl] - x_lo, 1e-12)
    fx = saturate((r2 - x_lo) / x_w)

    u = (x.to(torch.float32) + fx) / W
    v = (y.to(torch.float32) + fy) / H
    theta = v * PI
    phi = u * 2.0 * PI
    st = torch.sin(theta)
    xp = st * torch.cos(phi)
    zp = st * torch.sin(phi)
    rot = scene.env_rotation
    L = torch.stack([
        torch.cos(rot) * xp + torch.sin(rot) * zp,
        torch.cos(theta),
        -torch.sin(rot) * xp + torch.cos(rot) * zp,
    ], dim=-1)
    pdf = scene.env_pdf[yl * W + xl]
    return L, pdf


def env_hit_pdf(scene, L):
    """Solid-angle pdf that :func:`sample_env_importance` would have given
    direction ``L``: the texel's table entry (the miss-side MIS
    counterpart, reference Evaluate_EnvQTree, ShadeRef.cpp:1056-1066)."""
    H, W = scene.env_tab_h, scene.env_tab_w
    u, theta = _latlong_uv(scene, L)
    x = torch.clamp((u * W).to(torch.int32), 0, W - 1).long()
    y = torch.clamp((theta * H).to(torch.int32), 0, H - 1).long()
    return scene.env_pdf[y * W + x]


def intersect_area_lights(scene, ro, rd, t_max, no_sphrect: bool = False):
    """Closest visible analytic light along each ray (reference
    IntersectAreaLights, internal/CoreRef.cpp:3616): every visible sphere,
    rect, disk and line light against all rays.  Returns ``(t, light_idx,
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
        if not visible or ltype in (LightType.TRI, LightType.ENV,
                                    LightType.DIR):
            continue
        col_pos = L["pos"][i]
        if ltype == LightType.SPHERE:
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
        elif ltype in (LightType.RECT, LightType.DISK):
            u_ax = L["u"][i] * L["width"][i]
            v_ax = L["v"][i] * L["height"][i]
            fwd = torch.linalg.cross(u_ax, v_ax)
            fwd = fwd / torch.clamp_min(torch.linalg.norm(fwd), 1e-12)
            denom = dot(rd, fwd[None, :], False)
            # a single-sided light emits along +fwd: only rays travelling
            # against it see it, like the sampler's cos(-L, fwd) > 0 test
            facing = (torch.abs(denom) > 1e-7) if dsd else (denom < -1e-7)
            t_hit = dot(col_pos[None, :] - ro, fwd[None, :], False) / (
                torch.where(torch.abs(denom) > 1e-9, denom, 1e-9))
            p = ro + rd * t_hit[:, None] - col_pos[None, :]
            pu = dot(p, u_ax[None, :], False) / torch.clamp_min(
                torch.sum(u_ax * u_ax), 1e-12)
            pv = dot(p, v_ax[None, :], False) / torch.clamp_min(
                torch.sum(v_ax * v_ax), 1e-12)
            if ltype == LightType.RECT:
                inside = (torch.abs(pu) <= 0.5) & (torch.abs(pv) <= 0.5)
                area = L["width"][i] * L["height"][i]
            else:
                inside = (pu * pu + pv * pv) <= 0.25
                area = 0.25 * PI * L["width"][i] * L["height"][i]
            ok = facing & (t_hit > 0.0) & (t_hit < t_max) & inside
            cos_theta = torch.abs(denom)
            pdf = safe_div_pos(t_hit * t_hit,
                               area * torch.clamp_min(cos_theta, 1e-9))
            if ltype == LightType.RECT:
                # the spherical-rect pdf where the sampler would use it
                # (ShadeRef.cpp:1128-1141)
                zero = torch.zeros((R,), dtype=torch.float32, device=dev)
                sr_pdf, _, sr_ok = sample_spherical_rectangle(
                    ro, col_pos.expand(R, 3), u_ax.expand(R, 3),
                    v_ax.expand(R, 3), zero, zero)
                if not no_sphrect:
                    pdf = torch.where(sr_ok, sr_pdf, pdf)
            spot = ones
        else:
            # LINE: a finite cylinder of radius r around axis v through pos
            axis = L["v"][i]
            r_cyl = L["radius"][i]
            h = L["height"][i]
            oc = ro - col_pos[None, :]
            d_perp = rd - dot(rd, axis[None, :]) * axis[None, :]
            o_perp = oc - dot(oc, axis[None, :]) * axis[None, :]
            a_q = dot(d_perp, d_perp, False)
            b_q = dot(d_perp, o_perp, False)
            c_q = dot(o_perp, o_perp, False) - r_cyl * r_cyl
            disc = b_q * b_q - a_q * c_q
            t_hit = safe_div_pos(-b_q - torch.sqrt(torch.clamp_min(disc, 0.0)),
                                 torch.clamp_min(a_q, 1e-12))
            z = dot(oc + rd * t_hit[:, None], axis[None, :], False)
            ok = ((disc >= 0.0) & (t_hit > 0.0) & (t_hit < t_max)
                  & (torch.abs(z) <= 0.5 * h))
            area = 2.0 * PI * r_cyl * h
            cos_theta = 1.0 - torch.abs(dot(rd, axis[None, :], False))
            pdf = safe_div_pos(t_hit * t_hit,
                               area * torch.clamp_min(cos_theta, 1e-9))
            spot = ones
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


def portal_shadow_block(scene, ro, rd, dist):
    """Sky-portal shadow blocking — the reference's blocker-light pass
    (TraceShadowRays → IntersectAreaLights shadow variant,
    CoreRef.cpp:4866-4870, leaf test :4533-4590): only sky portals block,
    and only environment shadow rays, so that environment light reaches the
    interior through the portal windows alone.  Returns (R,) bool: True
    where the ray crosses a portal one-sidedly (cosθ < 0) within ``dist``.
    The caller applies it to ``ls.from_env`` rays; a scene without portals
    blocks nothing."""
    L = scene.lights
    R = ro.shape[0]
    blocked = torch.zeros((R,), dtype=torch.bool, device=ro.device)
    for i, (ltype, _vis, _dsd, is_portal) in enumerate(scene.light_kinds):
        if not is_portal or ltype not in (LightType.RECT, LightType.DISK):
            continue
        pos = L["pos"][i]
        u_ax = L["u"][i] * L["width"][i]
        v_ax = L["v"][i] * L["height"][i]
        fwd = torch.linalg.cross(u_ax, v_ax)
        fwd = fwd / torch.clamp_min(torch.linalg.norm(fwd), 1e-12)
        cos_theta = dot(rd, fwd[None, :], False)
        t = (torch.sum(fwd * pos) - dot(ro, fwd[None, :], False)) / (
            torch.clamp_max(cos_theta, -1e-12))
        hit = (cos_theta < 0.0) & (t > HIT_BIAS) & (t < dist)
        vi = ro + rd * t[:, None] - pos[None, :]
        a1 = dot(vi, u_ax[None, :], False) / torch.clamp_min(
            torch.sum(u_ax * u_ax), 1e-12)
        a2 = dot(vi, v_ax[None, :], False) / torch.clamp_min(
            torch.sum(v_ax * v_ax), 1e-12)
        if ltype == LightType.RECT:
            inside = (torch.abs(a1) <= 0.5) & (torch.abs(a2) <= 0.5)
        else:
            inside = torch.sqrt(a1 * a1 + a2 * a2) <= 0.5
        blocked = blocked | (hit & inside)
    return blocked
