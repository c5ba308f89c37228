"""BSDF lobe evaluate/sample pairs — the DIFFUSE node's lobe.

The port of the diffuse part of ``ray_tpu.render.bsdf.lobes``, with its
conventions: ``eval_*`` returns ``(f_cos, pdf)`` — BSDF × |cos| as an RGB
weight and the solid-angle pdf of the lobe's own sampler — and the ray
direction ``I`` points into the surface.  The principled diffuse, GGX
specular/refraction and clearcoat lobes are not ported yet (ROADMAP
Queue 1 item 29).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.linalg import dot, world_from_tangent
from ray_tpu_torch.render.bsdf.microfacet import PI

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
    t = torch.where(t > 0.0, t / (torch.maximum(nl, nv) + 1e-37), t)
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
