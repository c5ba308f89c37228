"""BSDF lobe evaluate/sample pairs.

The port of ``ray_tpu.render.bsdf.lobes``, with its conventions:
``eval_*`` returns ``(f_cos, pdf)`` — BSDF × |cos| as an RGB weight and the
solid-angle pdf of the lobe's own sampler — ``sample_*`` returns ``(dir,
f_cos, pdf)``, the ray direction ``I`` points into the surface, and delta
lobes (mirror, perfect refraction) return the pseudo-pdf ``DELTA_PDF``.
Lobes: Oren-Nayar, principled (Burley) diffuse with sheen, GGX specular
with bounded-VNDF sampling, GGX refraction and GTR1 clearcoat.
"""

from __future__ import annotations

import torch

from rtbench.ref.ops.linalg import (
    dot,
    safe_div_pos,
    sqr,
    tangent_from_world,
    world_from_tangent,
)
from rtbench.ref.render.bsdf.microfacet import (
    D_GGX,
    D_GTR1,
    G1,
    PI,
    _normalize,
    fresnel_dielectric_cos,
    ggx_vndf_reflection_bounded_pdf,
    reflect,
    sample_ggx_vndf,
    sample_ggx_vndf_bounded,
    schlick_weight,
)

DELTA_PDF = 1e6  # pseudo-pdf of specular delta lobes


def eval_oren_diffuse(V, N, L, roughness, base_color):
    """Oren-Nayar with the reference's normalization (ShadeRef.cpp:403);
    sampled uniformly over the hemisphere → pdf 1/(2π)."""
    sigma = roughness
    div = 1.0 / (PI + ((3.0 * PI - 4.0) / 6.0) * sigma)
    a = div
    b = sigma * div
    nl = torch.clamp_min(dot(N, L, False), 0.0)
    nv = torch.clamp_min(dot(N, V, False), 0.0)
    t = dot(L, V, False) - nl * nv
    den = torch.maximum(nl, nv) + 1e-37
    # where both cosines vanish the quotient's partial in den (-t/den²)
    # overflows and times a zero upstream gradient becomes NaN: no
    # gradient reaches den there (the value is unchanged)
    den = torch.where(den > 1e-18, den, den.detach())
    t = torch.where(t > 0.0, t / den, t)
    f_cos = (nl * (a + b * t))[..., None] * base_color
    pdf = torch.full_like(nl, 0.5 / PI)
    return f_cos, pdf


def sample_uniform_hemisphere(T, B, N, rand):
    phi = 2.0 * PI * rand[..., 1]
    sp, cp = torch.sin(phi), torch.cos(phi)
    z = rand[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    v_ts = torch.stack([r * cp, r * sp, z], dim=-1)
    return world_from_tangent(T, B, N, v_ts)


def sample_cosine_hemisphere(T, B, N, rand):
    phi = 2.0 * PI * rand[..., 1]
    sp, cp = torch.sin(phi), torch.cos(phi)
    r = torch.sqrt(rand[..., 0])
    z = torch.sqrt(torch.clamp_min(1.0 - rand[..., 0], 0.0))
    v_ts = torch.stack([r * cp, r * sp, z], dim=-1)
    return world_from_tangent(T, B, N, v_ts)


def eval_principled_diffuse(V, N, L, roughness, base_color, sheen_color):
    """Burley diffuse retro-reflection + sheen (ShadeRef.cpp:385-421, 442);
    cosine-sampled → pdf N·L/π; f_cos folds in the N·L/π factor."""
    n_dot_l = dot(N, L, False)
    n_dot_v = dot(N, V, False)
    H = _normalize(L + V)
    H = torch.where(dot(V, H) < 0.0, -H, H)
    l_dot_h = dot(L, H, False)
    FL = schlick_weight(n_dot_l)
    FV = schlick_weight(n_dot_v)
    Fd90 = 0.5 + 2.0 * l_dot_h * l_dot_h * roughness
    Fd = (1.0 + (Fd90 - 1.0) * FL) * (1.0 + (Fd90 - 1.0) * FV)
    Fd = torch.where(n_dot_l > 0.0, Fd, 0.0)
    FH = PI * schlick_weight(l_dot_h)
    diff_col = base_color * Fd[..., None] + FH[..., None] * sheen_color
    f_cos = torch.clamp_min(n_dot_l, 0.0)[..., None] * diff_col / PI
    pdf = torch.clamp_min(n_dot_l, 0.0) / PI
    return f_cos, pdf


# --------------------------------------------------------------------------
# GGX specular reflection
# --------------------------------------------------------------------------

def eval_ggx_specular_ts(view_ts, h_ts, refl_ts, alpha, spec_ior, spec_F0,
                         col, col90):
    """All-tangent-space GGX reflection (ShadeRef.cpp:490-512)."""
    D = D_GGX(h_ts, alpha)
    G = G1(view_ts, alpha) * G1(refl_ts, alpha)
    FH = (fresnel_dielectric_cos(dot(view_ts, h_ts, False), spec_ior)
          - spec_F0) / torch.clamp_min(1.0 - spec_F0, 1e-6)
    F = col + FH[..., None] * (col90 - col)
    denom = 4.0 * torch.abs(view_ts[..., 2] * refl_ts[..., 2])
    scale = torch.where(denom != 0.0,
                        D * G / torch.where(denom != 0.0, denom, 1.0), 0.0)
    f_cos = F * (scale * torch.clamp_min(refl_ts[..., 2], 0.0))[..., None]
    pdf = ggx_vndf_reflection_bounded_pdf(D, view_ts, alpha)
    return f_cos, pdf


def _benign_alpha(alpha, smooth):
    """Masked-smooth lanes evaluate with a harmless alpha so that no
    1/alpha² intermediate overflows in the backward pass."""
    return torch.where(smooth[..., None], 0.01, alpha)


def eval_ggx_specular(T, B, N, I, L, alpha, spec_ior, spec_F0, col, col90):
    smooth = alpha[..., 0] * alpha[..., 1] < 1e-7
    alpha = _benign_alpha(alpha, smooth)
    view_ts = tangent_from_world(T, B, N, -I)
    light_ts = tangent_from_world(T, B, N, L)
    H = _normalize(L - I)
    h_ts = tangent_from_world(T, B, N, H)
    f_cos, pdf = eval_ggx_specular_ts(
        view_ts, h_ts, light_ts, alpha, spec_ior, spec_F0, col, col90
    )
    return (torch.where(smooth[..., None], 0.0, f_cos),
            torch.where(smooth, 0.0, pdf))


def sample_ggx_specular(T, B, N, I, alpha, spec_ior, spec_F0, col, col90,
                        rand):
    """Bounded-VNDF sample; smooth surfaces degenerate to a mirror delta
    (ShadeRef.cpp:508-538)."""
    smooth = alpha[..., 0] * alpha[..., 1] < 1e-7
    alpha = _benign_alpha(alpha, smooth)
    view_ts = _normalize(tangent_from_world(T, B, N, -I))
    h_ts = sample_ggx_vndf_bounded(view_ts, alpha, rand)
    d_n_v = -dot(h_ts, view_ts, False)
    refl_ts = _normalize(reflect(-view_ts, h_ts, d_n_v))
    dir_rough = world_from_tangent(T, B, N, refl_ts)
    f_rough, pdf_rough = eval_ggx_specular_ts(
        view_ts, h_ts, refl_ts, alpha, spec_ior, spec_F0, col, col90
    )
    n_dot_i = dot(N, I, False)
    dir_mirror = reflect(I, N, n_dot_i)
    FH = (fresnel_dielectric_cos(dot(dir_mirror, N, False), spec_ior)
          - spec_F0) / torch.clamp_min(1.0 - spec_F0, 1e-6)
    f_mirror = (col + FH[..., None] * (col90 - col)) * DELTA_PDF
    return (
        torch.where(smooth[..., None], dir_mirror, dir_rough),
        torch.where(smooth[..., None], f_mirror, f_rough),
        torch.where(smooth, DELTA_PDF, pdf_rough),
    )


# --------------------------------------------------------------------------
# GGX refraction
# --------------------------------------------------------------------------

def eval_ggx_refraction_ts(view_ts, h_ts, refr_ts, alpha, eta, refr_col):
    """(ShadeRef.cpp:534-560); ``eta`` = n_outside / n_inside along the
    ray."""
    valid = (refr_ts[..., 2] < 0.0) & (view_ts[..., 2] > 0.0) & (
        alpha[..., 0] * alpha[..., 1] >= 1e-7
    )
    D = D_GGX(h_ts, alpha)
    G1o = G1(refr_ts, alpha)
    G1i = G1(view_ts, alpha)
    denom = dot(refr_ts, h_ts, False) + dot(view_ts, h_ts, False) * eta
    jacobian = safe_div_pos(
        torch.clamp_min(-dot(refr_ts, h_ts, False), 0.0), denom * denom
    )
    vh = torch.clamp_min(dot(view_ts, h_ts, False), 0.0)
    F = D * G1i * G1o * vh * jacobian / torch.clamp_min(view_ts[..., 2], 1e-7)
    pdf = D * G1o * vh * jacobian / torch.clamp_min(view_ts[..., 2], 1e-7)
    f_cos = torch.where(valid[..., None], F[..., None] * refr_col, 0.0)
    return f_cos, torch.where(valid, pdf, 0.0)


def eval_ggx_refraction(T, B, N, I, L, alpha, eta, refr_col):
    smooth = alpha[..., 0] * alpha[..., 1] < 1e-7
    alpha = _benign_alpha(alpha, smooth)
    view_ts = tangent_from_world(T, B, N, -I)
    light_ts = tangent_from_world(T, B, N, L)
    H = _normalize(L - I * eta[..., None])
    h_ts = tangent_from_world(T, B, N, H)
    f, pdf = eval_ggx_refraction_ts(view_ts, h_ts, light_ts, alpha, eta,
                                    refr_col)
    # delta lobes are excluded from NEE (ShadeRef.cpp:865-876)
    return (torch.where(smooth[..., None], 0.0, f),
            torch.where(smooth, 0.0, pdf))


def sample_ggx_refraction(T, B, N, I, alpha, eta, refr_col, rand):
    """(ShadeRef.cpp:562-595).  Returns (dir, f_cos, pdf); total internal
    reflection yields zero weight."""
    smooth = alpha[..., 0] * alpha[..., 1] < 1e-7
    alpha = _benign_alpha(alpha, smooth)
    # smooth (delta) path
    n_dot_i = dot(N, I, False)
    cosi = -n_dot_i
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    m = eta * cosi - torch.sqrt(torch.clamp_min(cost2, 1e-12))
    dir_delta = _normalize(eta[..., None] * I + m[..., None] * N)
    ok_delta = cost2 >= 0.0
    f_delta = torch.where(ok_delta[..., None], refr_col * DELTA_PDF, 0.0)

    # rough path
    view_ts = _normalize(tangent_from_world(T, B, N, -I))
    h_ts = sample_ggx_vndf(view_ts, alpha, rand)
    cosi_r = dot(view_ts, h_ts, False)
    cost2_r = 1.0 - eta * eta * (1.0 - cosi_r * cosi_r)
    m_r = eta * cosi_r - torch.sqrt(torch.clamp_min(cost2_r, 1e-12))
    refr_ts = _normalize(-eta[..., None] * view_ts + m_r[..., None] * h_ts)
    dir_rough = world_from_tangent(T, B, N, refr_ts)
    f_rough, pdf_rough = eval_ggx_refraction_ts(
        view_ts, h_ts, refr_ts, alpha, eta, refr_col
    )
    ok_rough = cost2_r >= 0.0
    f_rough = torch.where(ok_rough[..., None], f_rough, 0.0)

    return (
        torch.where(smooth[..., None], dir_delta, dir_rough),
        torch.where(smooth[..., None], f_delta, f_rough),
        torch.where(smooth, DELTA_PDF,
                    torch.where(ok_rough, pdf_rough, 0.0)),
    )


# --------------------------------------------------------------------------
# Clearcoat (GTR1)
# --------------------------------------------------------------------------

def eval_clearcoat_ts(view_ts, h_ts, refl_ts, coat_roughness2, coat_ior,
                      coat_F0):
    """(ShadeRef.cpp:597-617): GTR1 NDF, fixed 0.25²-alpha Smith masking."""
    D = D_GTR1(h_ts[..., 2], coat_roughness2)
    coat_alpha = torch.full(view_ts.shape[:-1] + (2,), 0.25 * 0.25,
                            dtype=view_ts.dtype, device=view_ts.device)
    G = G1(view_ts, coat_alpha) * G1(refl_ts, coat_alpha)
    FH = (fresnel_dielectric_cos(dot(refl_ts, h_ts, False), coat_ior)
          - coat_F0) / torch.clamp_min(1.0 - coat_F0, 1e-6)
    F = 0.04 + FH * (1.0 - 0.04)
    denom = 4.0 * torch.abs(view_ts[..., 2]) * torch.abs(refl_ts[..., 2])
    F = F * torch.where(denom != 0.0,
                        D * G / torch.where(denom != 0.0, denom, 1.0), 0.0)
    F = F * torch.clamp_min(refl_ts[..., 2], 0.0)
    alpha2 = torch.stack([coat_roughness2, coat_roughness2], dim=-1)
    pdf = ggx_vndf_reflection_bounded_pdf(D, view_ts, alpha2)
    return F, pdf


def eval_clearcoat(T, B, N, I, L, coat_roughness2, coat_ior, coat_F0):
    smooth = sqr(coat_roughness2) < 1e-7
    coat_roughness2 = torch.where(smooth, 0.01, coat_roughness2)
    view_ts = tangent_from_world(T, B, N, -I)
    light_ts = tangent_from_world(T, B, N, L)
    H = _normalize(L - I)
    h_ts = tangent_from_world(T, B, N, H)
    f, pdf = eval_clearcoat_ts(view_ts, h_ts, light_ts, coat_roughness2,
                               coat_ior, coat_F0)
    return torch.where(smooth, 0.0, f), torch.where(smooth, 0.0, pdf)


def sample_clearcoat(T, B, N, I, coat_roughness2, coat_ior, coat_F0, rand):
    """(ShadeRef.cpp:619-645); GGX-VNDF sampled though the NDF is GTR1, as
    in Cycles."""
    smooth = sqr(coat_roughness2) < 1e-7
    coat_roughness2 = torch.where(smooth, 0.01, coat_roughness2)
    view_ts = _normalize(tangent_from_world(T, B, N, -I))
    alpha2 = torch.stack([coat_roughness2, coat_roughness2], dim=-1)
    h_ts = sample_ggx_vndf_bounded(view_ts, alpha2, rand)
    d_n_v = -dot(h_ts, view_ts, False)
    refl_ts = _normalize(reflect(-view_ts, h_ts, d_n_v))
    dir_rough = world_from_tangent(T, B, N, refl_ts)
    f_rough, pdf_rough = eval_clearcoat_ts(
        view_ts, h_ts, refl_ts, coat_roughness2, coat_ior, coat_F0
    )
    n_dot_i = dot(N, I, False)
    dir_mirror = reflect(I, N, n_dot_i)
    FH = (fresnel_dielectric_cos(dot(dir_mirror, N, False), coat_ior)
          - coat_F0) / torch.clamp_min(1.0 - coat_F0, 1e-6)
    f_mirror = (0.04 + FH * (1.0 - 0.04)) * DELTA_PDF
    return (
        torch.where(smooth[..., None], dir_mirror, dir_rough),
        torch.where(smooth, f_mirror, f_rough),
        torch.where(smooth, DELTA_PDF, pdf_rough),
    )
