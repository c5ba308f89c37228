"""Vector math helpers shared by every stage.

The port of ``ray_tpu.ops.linalg``.  Vectors are tensors with a trailing
dimension of 3.  Three-component sums are written out left to right
(``x*x' + y*y' + z*z'``) so every device evaluates them in one order.  The
``safe_*`` helpers clamp inside the expression, so a masked lane never
carries an infinite partial into the backward pass.
"""

from __future__ import annotations

import torch

FLT_EPS = 1e-7
HIT_BIAS = 1e-5
MAX_DIST = 3.402823466e30


def dot(a, b, keepdims=True):
    d = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return d[..., None] if keepdims else d


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def length(v, keepdims=True):
    # 1e-30 floor keeps the sqrt derivative finite at exactly-zero vectors
    return torch.sqrt(torch.clamp_min(dot(v, v, keepdims=keepdims), 1e-30))


def normalize(v):
    return v / length(v)


def safe_normalize(v):
    l = length(v)
    ok = l > 0.0
    return torch.where(ok, v / torch.where(ok, l, torch.ones_like(l)), v)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 1e-30))


def safe_div(a, b):
    """a / b, and 3.4e38 where b is 0."""
    nz = b != 0.0
    return torch.where(nz, a / torch.where(nz, b, 1.0),
                       torch.tensor(3.4e38, dtype=torch.float32))


def safe_div_pos(a, b):
    if not isinstance(b, torch.Tensor):
        return a / max(b, FLT_EPS)
    return a / torch.clamp_min(b, FLT_EPS)


def safe_div_neg(a, b):
    return a / torch.clamp_max(b, -FLT_EPS)


def safe_invert(v):
    """Per-component 1/v with ±FLT_EPS clamping away from zero, for slab
    tests."""
    tiny = torch.where(v >= 0.0, FLT_EPS, -FLT_EPS)
    return 1.0 / torch.where(torch.abs(v) > FLT_EPS, v, tiny)


def sqr(x):
    return x * x


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def lum(c):
    """Rec.709 luminance."""
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


class _PowerHeuristic(torch.autograd.Function):
    """t / (b² + t), t = a², with its partial derivatives taken on the
    operands scaled by max(|a|, |b|): the plain quotient's backward
    over- or underflows (b² of a miss's infinite light pdf, den² of two
    tiny pdfs) into inf/inf or 0/0, which times the zero gradient of a lane
    the caller selects away is NaN.  Lanes with a zero or non-finite scale
    get no gradient.  The value is the plain quotient's, bit for bit."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        t = a * a
        return t / (b * b + t)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        s = torch.maximum(torch.abs(a), torch.abs(b))
        ok = (s > 0.0) & torch.isfinite(s)
        s = torch.where(ok, s, 1.0)
        ah, bh = a / s, b / s
        d = ah * ah + bh * bh
        d2s = torch.where(ok, d * d * s, 1.0)
        ga = torch.where(ok, 2.0 * ah * bh * bh / d2s, 0.0) * g
        gb = torch.where(ok, -2.0 * bh * ah * ah / d2s, 0.0) * g
        return ga, gb


def power_heuristic(a, b):
    """MIS power heuristic β=2 (reference internal/CoreRef.h:423); a
    backward free of the plain quotient's overflow (:class:`_PowerHeuristic`)."""
    a, b = torch.broadcast_tensors(a, b)
    return _PowerHeuristic.apply(a, b)


def world_from_tangent(T, B, N, v):
    return v[..., 0:1] * T + v[..., 1:2] * B + v[..., 2:3] * N


def tangent_from_world(T, B, N, v):
    return torch.stack(
        [dot(v, T, False), dot(v, B, False), dot(v, N, False)], dim=-1
    )


def orthonormal_basis(n):
    """Branchless tangent frame from a unit normal (Duff et al., JCGT
    2017)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1,
    )
    bt = torch.stack(
        [b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]],
        dim=-1,
    )
    return t, bt


def offset_ray(p, n):
    """Offset ray origin ``p`` off a surface with normal ``n`` robustly in
    floating point: integer ULP nudging far from the origin, small float
    offset near it (Wächter & Binder, Ray Tracing Gems).  The bit-level
    branch carries no gradient, as in ``ray_tpu``."""
    origin = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    int_scale = 128.0

    of_i = (int_scale * n.detach()).to(torch.int32)
    pd = p.detach().contiguous()
    p_i_bits = pd.view(torch.int32) + torch.where(pd < 0.0, -of_i, of_i)
    p_i = p_i_bits.view(torch.float32)
    return torch.where(torch.abs(p) < origin, p + float_scale * n, p_i)


def srgb_to_linear(c):
    return torch.where(
        c > 0.04045,
        torch.pow((torch.clamp_min(c, 0.04045) + 0.055) / 1.055, 2.4),
        c / 12.92)


def linear_to_srgb(c):
    c = torch.clamp_min(c, 0.0)
    return torch.where(
        c > 0.0031308,
        1.055 * torch.pow(torch.clamp_min(c, 0.0031308), 1.0 / 2.4) - 0.055,
        12.92 * c,
    )
