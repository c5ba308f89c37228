"""Microfacet building blocks: GGX distribution, Smith masking, bounded-VNDF
sampling, dielectric Fresnel.

The port of ``ray_tpu.render.bsdf.microfacet``, in its expression order.
Equations follow Heitz, "Sampling the GGX Distribution of Visible Normals"
(JCGT 2018); Dupuy & Benyoub, "Sampling Visible GGX Normals with Spherical
Caps" (arXiv 2306.05044); Eto & Tokuyoshi, "Bounded VNDF Sampling for
Smith-GGX Reflections" (SIGGRAPH Asia 2023).  Tangent space has +Z along
the shading normal; ``alpha`` is a 2-vector for anisotropy.
"""

from __future__ import annotations

import torch

from rtbench.ref.ops.linalg import safe_div_pos, saturate, sqr

PI = 3.14159265358979323846


def calc_alpha(roughness, anisotropy, regularize_alpha):
    """roughness² split into anisotropic (ax, ay), floored by the path-space
    regularization alpha (reference ShadeRef.cpp:12-19)."""
    roughness2 = sqr(roughness)
    aspect = torch.sqrt(1.0 - 0.9 * anisotropy)
    ax = torch.maximum(roughness2 / aspect, _as(regularize_alpha, roughness2))
    ay = torch.maximum(roughness2 * aspect, _as(regularize_alpha, roughness2))
    return torch.stack([ax, ay], dim=-1)


def _as(x, like):
    """A python float or a tensor, as a tensor broadcastable with ``like``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full_like(like, float(x))


def schlick_weight(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    return sqr(sqr(m)) * m


def fresnel_dielectric_cos(cosi, eta):
    """Exact dielectric Fresnel from cos(incident) and relative IOR (Cycles
    convention, reference ShadeRef.cpp:54-75)."""
    c = torch.abs(cosi)
    g2 = eta * eta - 1.0 + c * c
    g = torch.sqrt(torch.clamp_min(g2, 1e-12))
    A = (g - c) / torch.where(g + c != 0.0, g + c, 1.0)
    B = (c * (g + c) - 1.0) / torch.where(c * (g - c) + 1.0 != 0.0,
                                          c * (g - c) + 1.0, 1.0)
    result = 0.5 * A * A * (1.0 + B * B)
    return torch.where(g2 > 0.0, result, 1.0)  # total internal reflection


def D_GGX(h_ts, alpha):
    """Anisotropic GGX NDF of a tangent-space half vector; alpha is clamped
    away from zero inside the divisions so masked lanes keep finite
    partials."""
    hz = h_ts[..., 2]
    safe_hz = torch.where(hz != 0.0, hz, 1.0)
    a0 = torch.clamp_min(alpha[..., 0], 1e-9)
    a1 = torch.clamp_min(alpha[..., 1], 1e-9)
    sx = -h_ts[..., 0] / (safe_hz * a0)
    sy = -h_ts[..., 1] / (safe_hz * a1)
    s1 = 1.0 + sx * sx + sy * sy
    cos4 = torch.clamp_min(sqr(sqr(hz)), 1e-20)
    d = 1.0 / (sqr(s1) * PI * a0 * a1 * cos4)
    return torch.where(hz != 0.0, d, 0.0)


def G1(v_ts, alpha):
    """Smith masking term, Λ form, for anisotropic GGX."""
    a2 = alpha * alpha
    num = a2[..., 0] * sqr(v_ts[..., 0]) + a2[..., 1] * sqr(v_ts[..., 1])
    delta = (-1.0 + torch.sqrt(1.0 + safe_div_pos(num, sqr(v_ts[..., 2])))) * 0.5
    return 1.0 / (1.0 + delta)


def D_GTR1(n_dot_h, a):
    """Berry distribution for the clearcoat lobe; ``a`` is clamped to
    (1e-3, 1-1e-6) inside the log/divide so masked lanes stay finite."""
    a_c = torch.clamp(a, 1e-3, 0.999999)
    a2 = sqr(a_c)
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    d = (a2 - 1.0) / (PI * torch.log(a2) * t)
    return torch.where(a >= 1.0, 1.0 / PI, d)


def _sincos(phi):
    return torch.sin(phi), torch.cos(phi)


def sample_vndf_sph_cap(vh, rand):
    """Spherical-cap VNDF hemisphere sampling (Dupuy & Benyoub)."""
    phi = 2.0 * PI * rand[..., 0]
    z = (1.0 - rand[..., 1]) * (1.0 + vh[..., 2]) - vh[..., 2]
    sin_theta = torch.sqrt(torch.clamp(1.0 - z * z, 1e-12, 1.0))
    sp, cp = _sincos(phi)
    c = torch.stack([sin_theta * cp, sin_theta * sp, z], dim=-1)
    return c + vh


def sample_vndf_sph_cap_bounded(ve, vh, alpha, rand):
    """Bounded spherical-cap sampling (Eto & Tokuyoshi): shrinks the cap for
    reflection so no sampled normal reflects below the horizon."""
    phi = 2.0 * PI * rand[..., 0]
    a = saturate(torch.minimum(alpha[..., 0], alpha[..., 1]))
    s = 1.0 + torch.sqrt(sqr(ve[..., 0]) + sqr(ve[..., 1]))
    a2, s2 = a * a, s * s
    k = (1.0 - a2) * s2 / (s2 + a2 * sqr(ve[..., 2]))
    b = torch.where(ve[..., 2] > 0.0, k * vh[..., 2], vh[..., 2])
    z = (1.0 - rand[..., 1]) * (1.0 + b) - b
    sin_theta = torch.sqrt(torch.clamp(1.0 - z * z, 1e-12, 1.0))
    sp, cp = _sincos(phi)
    c = torch.stack([sin_theta * cp, sin_theta * sp, z], dim=-1)
    return c + vh


def _stretch(v, alpha):
    return torch.stack(
        [alpha[..., 0] * v[..., 0], alpha[..., 1] * v[..., 1], v[..., 2]],
        dim=-1)


def _normalize(v):
    return v / torch.sqrt(
        torch.clamp_min((v * v).sum(dim=-1, keepdim=True), 1e-30))


def _unstretch(nh, alpha):
    return _normalize(torch.stack(
        [alpha[..., 0] * nh[..., 0], alpha[..., 1] * nh[..., 1],
         torch.clamp_min(nh[..., 2], 0.0)], dim=-1))


def sample_ggx_vndf(ve_ts, alpha, rand):
    """VNDF sample with pdf D_v(Ne) = G1(Ve) max(0, Ve·Ne) D(Ne) / Ve.z."""
    vh = _normalize(_stretch(ve_ts, alpha))
    return _unstretch(sample_vndf_sph_cap(vh, rand), alpha)


def sample_ggx_vndf_bounded(ve_ts, alpha, rand):
    vh = _normalize(_stretch(ve_ts, alpha))
    return _unstretch(sample_vndf_sph_cap_bounded(ve_ts, vh, alpha, rand),
                      alpha)


def ggx_vndf_reflection_bounded_pdf(d, ve_ts, alpha):
    """Pdf of the bounded-VNDF reflection sampler for half-vector density
    ``d`` (Eto & Tokuyoshi eq. 18; reference ShadeRef.cpp:181-194)."""
    ai0 = alpha[..., 0] * ve_ts[..., 0]
    ai1 = alpha[..., 1] * ve_ts[..., 1]
    len2 = torch.clamp_min(ai0 * ai0 + ai1 * ai1, 1e-9)
    t = torch.sqrt(torch.clamp_min(len2 + sqr(ve_ts[..., 2]), 1e-18))
    a = saturate(torch.minimum(alpha[..., 0], alpha[..., 1]))
    s = 1.0 + torch.sqrt(sqr(ve_ts[..., 0]) + sqr(ve_ts[..., 1]))
    a2, s2 = a * a, s * s
    k = (1.0 - a2) * s2 / (s2 + a2 * sqr(ve_ts[..., 2]))
    pdf_above = d / (2.0 * (k * ve_ts[..., 2] + t))
    pdf_below = d * (t - ve_ts[..., 2]) / (2.0 * len2)
    return torch.where(ve_ts[..., 2] >= 0.0, pdf_above, pdf_below)


def reflect(i, n, dot_n_i):
    """Mirror reflect direction ``i`` about ``n`` given n·i."""
    return i - 2.0 * dot_n_i[..., None] * n
