"""View transforms: linear radiance → display values in [0, 1].

The port of ``ray_tpu.render.tonemap``: the ten ``ViewTransform``s
(reference ``eViewTransform``, Types.h:70-83), the reversible tonemap of
the variance estimate (TonemapRef.h:7-13), the analytic AgX, AgX-punchy
and filmic curves, and the baked 48³ LUTs with trilinear lookup
(TonemapRef.cpp ``TonemapFilmic``).  The LUTs are a byte-for-byte copy of
``ray_tpu``'s, kept in ``ray_tpu_torch/data/tonemap_luts.npz``.

One difference from ``ray_tpu``: there a missing LUT file quietly selects
the analytic curve.  Here ``use_lut=True`` needs the file and raises
without it; only ``use_lut=False`` selects the analytic curves.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from ray_tpu_torch.ops.linalg import linear_to_srgb


class ViewTransform:
    """The ``eViewTransform`` set (reference Types.h:70-83)."""

    STANDARD = 0
    AGX = 1
    AGX_PUNCHY = 2
    FILMIC_VERY_LOW_CONTRAST = 3
    FILMIC_LOW_CONTRAST = 4
    FILMIC_MED_LOW_CONTRAST = 5
    FILMIC_MED_CONTRAST = 6
    FILMIC_MED_HIGH_CONTRAST = 7
    FILMIC_HIGH_CONTRAST = 8
    FILMIC_VERY_HIGH_CONTRAST = 9


def reversible_tonemap(c):
    """Range-compress for variance / denoise space: c / (1 + max(c))
    (reference TonemapRef.h:7)."""
    return c / (1.0 + c[..., :3].amax(dim=-1, keepdim=True))


def reversible_tonemap_invert(c):
    m = c[..., :3].amax(dim=-1, keepdim=True)
    return c / torch.clamp_min(1.0 - m, 1e-6)


def _mat3(m, v):
    """``m @ v`` over the last axis, each row's sum left to right."""
    return torch.stack([v[..., 0] * m[i][0] + v[..., 1] * m[i][1]
                        + v[..., 2] * m[i][2] for i in range(3)], dim=-1)


def _agx_default_contrast(x):
    """AgX sigmoid polynomial approximation (Benjamin Wrensch / Troy
    Sobotka's AgX, as used in Blender and three.js)."""
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
            + 0.4298 * x2 + 0.1191 * x - 0.00232)


# float32 values of ray_tpu's matrices
_AGX_IN = np.array([
    [0.842479062253094, 0.0784335999999992, 0.0792237451477643],
    [0.0423282422610123, 0.878468636469772, 0.0791661274605434],
    [0.0423756549057051, 0.0784336, 0.879142973793104],
], np.float32).tolist()
_AGX_OUT = np.array([
    [1.19687900512017, -0.0980208811401368, -0.0990297440797205],
    [-0.0528968517574562, 1.15190312990417, -0.0989611768448433],
    [-0.0529716355144438, -0.0980434501171241, 1.15107367264116],
], np.float32).tolist()


def tonemap_agx(c):
    """AgX 'base' look (log2 encoding + inset matrix + sigmoid)."""
    min_ev = -12.47393
    max_ev = 4.026069
    v = _mat3(_AGX_IN, torch.clamp_min(c, 1e-10))
    v = torch.clamp((torch.log2(v) - min_ev) / (max_ev - min_ev), 0.0, 1.0)
    v = _mat3(_AGX_OUT, _agx_default_contrast(v))
    return torch.clamp(v, 0.0, 1.0)


def tonemap_agx_punchy(c):
    """AgX + the 'punchy' look: ASC-CDL power 1.35 and saturation 1.4 in
    the AgX output space (Blender's AgX Punchy look)."""
    v = torch.pow(torch.clamp_min(tonemap_agx(c), 0.0), 1.35)
    luma = (v[..., 0] * 0.2126 + v[..., 1] * 0.7152
            + v[..., 2] * 0.0722)[..., None]
    return torch.clamp(luma + 1.4 * (v - luma), 0.0, 1.0)


# filmic-blender dynamic range: 16.5 stops, middle grey 0.18 at log 0.7558
_FILMIC_LOG_MIN = -12.473931188
_FILMIC_LOG_MAX = 4.026068812


def _filmic_log_encode(c):
    """Troy Sobotka's filmic-blender 'Log' base encoding: log2 of scene
    exposure over the 16.5-stop window, desaturated toward the top."""
    x = torch.clamp_min(c, 1e-10)
    lg = (torch.log2(x / 0.18) - _FILMIC_LOG_MIN) / (
        _FILMIC_LOG_MAX - _FILMIC_LOG_MIN)
    lg = torch.clamp(lg, 0.0, 1.0)
    m = lg.amax(dim=-1, keepdim=True)
    t = torch.clamp((m - 0.8) / 0.2, 0.0, 1.0) ** 2
    return lg + t * (m - lg) * 0.6


# per-look contrast strengths of the 7 Filmic looks (Very Low → Very High)
_FILMIC_CONTRAST = {3: 0.6, 4: 0.75, 5: 0.9, 6: 1.0, 7: 1.2, 8: 1.45, 9: 1.8}


def _contrast_s_curve(x, strength):
    """S-curve around the middle-grey pivot: identity at strength 1."""
    pivot = 0.7558  # filmic-log value of 0.18 middle grey
    lo = x / pivot
    hi = (x - pivot) / (1.0 - pivot)
    below = pivot * torch.pow(torch.clamp_min(lo, 1e-8), strength)
    above = pivot + (1.0 - pivot) * (
        1.0 - torch.pow(torch.clamp_min(1.0 - hi, 1e-8), strength))
    return torch.where(x < pivot, below, above)


def tonemap_filmic(c, contrast: float = 1.0):
    """Filmic view transform: filmic-log encode + per-look contrast."""
    lg = _filmic_log_encode(c)
    out = _contrast_s_curve(torch.clamp(lg, 0.0, 1.0), contrast)
    return torch.clamp(out, 0.0, 1.0)


# --- baked 48^3 view-transform LUTs ---------------------------------------

_LUT_DIMS = 48
LUT_PATH = (pathlib.Path(__file__).resolve().parent.parent / "data"
            / "tonemap_luts.npz")
_LUT_KEYS = {
    ViewTransform.AGX: "agx",
    ViewTransform.AGX_PUNCHY: "agx_punchy",
    ViewTransform.FILMIC_VERY_LOW_CONTRAST: "filmic_very_low_contrast",
    ViewTransform.FILMIC_LOW_CONTRAST: "filmic_low_contrast",
    ViewTransform.FILMIC_MED_LOW_CONTRAST: "filmic_med_low_contrast",
    ViewTransform.FILMIC_MED_CONTRAST: "filmic_med_contrast",
    ViewTransform.FILMIC_MED_HIGH_CONTRAST: "filmic_med_high_contrast",
    ViewTransform.FILMIC_HIGH_CONTRAST: "filmic_high_contrast",
    ViewTransform.FILMIC_VERY_HIGH_CONTRAST: "filmic_very_high_contrast",
}


@functools.lru_cache(maxsize=len(_LUT_KEYS))
def _load_lut(view_transform: int) -> np.ndarray:
    """One LUT unpacked to a (48, 48, 48, 3) float32 [z][y][x] table (x ←
    R): the reference's 10 bits a channel (FetchLUT).  Raises when the data
    file is missing."""
    with np.load(LUT_PATH) as z:
        packed = z[_LUT_KEYS[view_transform]].astype(np.uint32)
    rgb = np.stack([(packed >> s) & np.uint32(0x3FF) for s in (0, 10, 20)],
                   axis=-1).astype(np.float32) / 1023.0
    return rgb.reshape(_LUT_DIMS, _LUT_DIMS, _LUT_DIMS, 3)


def tonemap_lut(c, lut):
    """Trilinear 3-D LUT lookup over the c/(c+1) encoding (reference
    TonemapRef.cpp TonemapFilmic); piecewise trilinear, so differentiable
    in ``c``.  ``c``: (..., 3) linear RGB; ``lut``: (48, 48, 48, 3)."""
    enc = c / (c + 1.0)
    uv = torch.clamp(enc, 0.0, 1.0) * (_LUT_DIMS - 1)
    i0 = torch.clamp(uv.to(torch.int32), 0, _LUT_DIMS - 1)
    f = uv - i0
    i1 = torch.clamp_max(i0 + 1, _LUT_DIMS - 1)
    ix0, iy0, iz0 = (i0[..., k].long() for k in range(3))
    ix1, iy1, iz1 = (i1[..., k].long() for k in range(3))
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = lut[iz0, iy0, ix0] * (1 - fx) + lut[iz0, iy0, ix1] * fx
    c01 = lut[iz0, iy1, ix0] * (1 - fx) + lut[iz0, iy1, ix1] * fx
    c10 = lut[iz1, iy0, ix0] * (1 - fx) + lut[iz1, iy0, ix1] * fx
    c11 = lut[iz1, iy1, ix0] * (1 - fx) + lut[iz1, iy1, ix1] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def apply_view_transform(c, view_transform: int, exposure: float = 0.0,
                         gamma: float = 1.0, use_lut: bool = True):
    """Exposure (``c · 2^exposure``), the view transform (its LUT when
    ``use_lut`` and the transform has one, else the analytic curve; the
    standard transform is sRGB), then ``pow(·, 1/gamma)`` when gamma is not
    1, clipped to [0, 1] (reference Tonemap, TonemapRef.h:40-46)."""
    scale = torch.exp2(torch.tensor(float(exposure), dtype=torch.float32))
    c = c * scale.to(c.device)
    if use_lut and view_transform in _LUT_KEYS:
        lut = torch.from_numpy(_load_lut(view_transform)).to(c.device)
        out = tonemap_lut(c, lut)
    elif view_transform == ViewTransform.AGX:
        out = tonemap_agx(c)
    elif view_transform == ViewTransform.AGX_PUNCHY:
        out = tonemap_agx_punchy(c)
    elif view_transform in _FILMIC_CONTRAST:
        out = tonemap_filmic(c, _FILMIC_CONTRAST[view_transform])
    else:
        out = linear_to_srgb(torch.clamp(c, 0.0, 1.0))
    if float(gamma) != 1.0:
        out = torch.pow(torch.clamp(out, 0.0, 1.0),
                        1.0 / max(float(gamma), 1e-6))
    return torch.clamp(out, 0.0, 1.0)
