"""Environment importance-sampling tables.

A copy of ``ray_tpu.scene.env`` (numpy only).  The reference samples its
latlong environment through a luminance quadtree (internal/CoreRef.h:505
``Sample_EnvQTree`` / ``Evaluate_EnvQTree``; built in SceneCPU.cpp:1058);
``ray_tpu`` builds the classic marginal / conditional CDF over the latlong
luminance (sin-θ weighted) at finalize instead, and the render-time
inverse transform is a vectorised binary search
(:func:`ray_tpu_torch.render.light_sampling.sample_env_importance`).

Tables (numpy, host), float64 arithmetic stored as float32:
  marginal_cdf: (H,)  row CDF (last = 1)
  cond_cdf:     (H, W) per-row column CDF (last = 1)
  pdf:          (H, W) solid-angle pdf of sampling each texel's direction
"""

from __future__ import annotations

import numpy as np

PI = np.pi


def build_env_cdf(rgb: np.ndarray):
    """rgb: (H, W, 3+) float latlong map.  Returns (marginal_cdf, cond_cdf,
    pdf), byte-equal to ``ray_tpu``'s."""
    H, W = rgb.shape[:2]
    lum = (
        0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]
    ).astype(np.float64)
    theta = (np.arange(H) + 0.5) / H * PI
    w = lum * np.sin(theta)[:, None]
    w = np.maximum(w, 1e-12)

    row_sum = w.sum(axis=1)
    marginal = row_sum / row_sum.sum()
    marginal_cdf = np.cumsum(marginal)
    marginal_cdf[-1] = 1.0

    cond = w / row_sum[:, None]
    cond_cdf = np.cumsum(cond, axis=1)
    cond_cdf[:, -1] = 1.0

    # pdf over solid angle: P(texel) / Ω(texel), Ω = (2π/W)(π/H) sinθ
    p_texel = (w / w.sum()).astype(np.float64)
    omega = (2.0 * PI / W) * (PI / H) * np.sin(theta)[:, None]
    pdf = p_texel / np.maximum(omega, 1e-12)

    return (
        marginal_cdf.astype(np.float32),
        cond_cdf.astype(np.float32),
        pdf.astype(np.float32),
    )
