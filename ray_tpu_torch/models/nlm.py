"""Joint non-local-means denoiser.

The port of ``ray_tpu.models.nlm`` (reference NLM filter,
internal/DenoiseRef.h:6-10 and DenoiseRef.cpp: 7x7 search window, 3x3
patches, variance-weighted distance, guided by the base-color and
depth-normal feature buffers; driver pre-pass RendererCPU.h:661-787).
Plain PyTorch, as ``ray_tpu`` writes it in ``jnp``: the 49 window offsets
unroll into shifted-image arithmetic, about 40 elementwise ops an offset,
run once an image.  Images are (H, W, C) float32 tensors on any device.
"""

from __future__ import annotations

import torch


def _shift2d(img, dy: int, dx: int):
    """``img`` (H, W, C) shifted by (dy, dx) with edge clamp:
    ``out[y, x] = img[clamp(y + dy), clamp(x + dx)]``."""
    H, W = img.shape[:2]
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img.index_select(0, ys).index_select(1, xs)


def _box3(img):
    """3x3 box sum via two separable passes."""
    s = _shift2d(img, -1, 0) + img + _shift2d(img, 1, 0)
    return _shift2d(s, 0, -1) + s + _shift2d(s, 0, 1)


GAUSS_WEIGHTS = (0.2270270270, 0.1945945946, 0.1216216216, 0.0540540541,
                 0.0162162162)


def _channel_sum(x):
    """Sum over the last axis of size 3 or 4, in index order (``ray_tpu``'s
    reduction order)."""
    s = x[..., 0:1]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c:c + 1]
    return s


def filter_variance(variance):
    """The driver's variance pre-pass (RendererCPU.h:688-735): a 9-tap Gauss
    blur horizontally then vertically, each pass floored by the centre
    value (a max-blur: hot pixels never lose variance)."""
    def pass_1d(v, axis):
        res = v * GAUSS_WEIGHTS[0]
        for i in range(1, 5):
            off = [0, 0]
            off[axis] = i
            res = res + _shift2d(v, *off) * GAUSS_WEIGHTS[i]
            off[axis] = -i
            res = res + _shift2d(v, *off) * GAUSS_WEIGHTS[i]
        return torch.maximum(res, v)

    return pass_1d(pass_1d(variance, 1), 0)


def nlm_denoise(
    color,
    variance,
    base_color=None,
    depth_normal=None,
    window: int = 3,
    alpha: float = 1.0,
    damping: float = 0.45,
    feature0_weight: float = 64.0,
    feature1_weight: float = 32.0,
):
    """Filter ``color`` (H, W, 3) with per-pixel ``variance`` (H, W, 3):
    the reference's JointNLMFilter (DenoiseRef.cpp:10-90, driver
    parameters RendererCPU.h:766)::

      patch distance = 0.25 N^2 sum_patch sum_ch ((dc)^2 - alpha (v_i +
                       min(v_i, v_j))) / (1e-4 + damping^2 (v_i + v_j)),
      w = exp(-max(0, pd)),
      feature distance = 0.25 sum_ch max(w0 dbase^2, w1 ddn^2),
      w = min(w, exp(-max(0, min(1e4, fd)))).
    """
    k2 = damping * damping
    accum = torch.zeros_like(color)
    wsum = torch.zeros(color.shape[:2] + (1,), dtype=color.dtype,
                       device=color.device)
    n_patch = 9.0  # 3x3

    if base_color is not None and depth_normal is not None:
        # channel-align the two 4-vectors (reference color_rgba_t): base
        # color rgb + a constant alpha (difference 0), depth-normal xyz + depth
        f0 = torch.cat([base_color, torch.zeros_like(base_color[..., :1])],
                       dim=-1)
        f1 = depth_normal
    else:
        f0 = f1 = None

    for dy in range(-window, window + 1):
        for dx in range(-window, window + 1):
            c_s = _shift2d(color, dy, dx)
            v_s = _shift2d(variance, dy, dx)
            d2 = (color - c_s) ** 2 - alpha * (
                variance + torch.minimum(variance, v_s))
            d2 = d2 / (1e-4 + k2 * (variance + v_s))
            pd = 0.25 * n_patch * _channel_sum(_box3(d2))
            w = torch.exp(-torch.clamp_min(pd, 0.0))

            if f0 is not None:
                fd = torch.maximum(
                    feature0_weight * (f0 - _shift2d(f0, dy, dx)) ** 2,
                    feature1_weight * (f1 - _shift2d(f1, dy, dx)) ** 2,
                )
                fpd = 0.25 * _channel_sum(fd)
                fw = torch.exp(-torch.clamp_min(torch.clamp_max(fpd, 1e4),
                                                0.0))
                w = torch.minimum(w, fw)

            accum = accum + w * c_s
            wsum = wsum + w

    return accum / torch.clamp_min(wsum, 1e-12)
