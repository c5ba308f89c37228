"""The NLM denoiser (``ray_tpu_torch.models.nlm``) and
``Renderer.denoise_image`` against ray_tpu's, on the CPU.

* ``filter_variance`` and ``nlm_denoise`` (the reference's defaults: 7x7
  window, 3x3 patch, alpha 1, damping 0.45, feature weights 64 / 32, with
  and without the feature buffers) on seeded 40x56 buffers: within 1e-5
  relative (atol 1e-7) — the same elementwise ops in the same order; only
  ``exp`` may differ by an ulp between XLA's CPU code and PyTorch's.
* ``denoise_image("nlm")`` and ``("unet")`` of a renderer whose buffers
  (full, half, base color, depth-normal) carry the same seeded values into
  both packages: NLM within 1e-5 relative, the UNet within 1e-5 of the
  image's largest value (the convolutions sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import nlm as jnlm
from ray_tpu.render.renderer import Renderer as JRenderer
from ray_tpu.render.renderer import RenderSettings as JRenderSettings
from ray_tpu_torch.models import nlm as tnlm
from ray_tpu_torch.render.renderer import Renderer, RenderSettings
import test_torch_scene  # noqa: F401  (one intra-op thread)

H, W = 40, 56


def _buffers(seed):
    g = np.random.default_rng(seed)
    y, x = np.mgrid[:H, :W]
    smooth = 1.0 + 0.8 * np.sin(x / 7.0)[..., None] * np.cos(y / 5.0)[
        ..., None] * np.array([1.0, 0.7, 0.4])
    # a noisy render: the full buffer and its half around a smooth image
    color = (smooth + 0.2 * g.standard_normal((H, W, 3))).astype(np.float32)
    half = (color + 0.2 * g.standard_normal((H, W, 3))).astype(np.float32)
    base = g.random((H, W, 3)).astype(np.float32)
    n = g.standard_normal((H, W, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    dn = np.concatenate([n, g.random((H, W, 1)) * 5], -1).astype(np.float32)
    return color, half, base, dn


def _close(port, ref, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def test_filter_variance_matches_ray_tpu():
    color, half, _, _ = _buffers(0)
    v = (0.5 * (color - half) ** 2).astype(np.float32)
    _close(tnlm.filter_variance(torch.from_numpy(v)).numpy(),
           np.asarray(jnlm.filter_variance(jnp.asarray(v))))


@pytest.mark.parametrize("features", [True, False])
def test_nlm_denoise_matches_ray_tpu(features):
    color, half, base, dn = _buffers(1)
    v = np.asarray(jnlm.filter_variance(jnp.asarray(
        0.5 * (color - half) ** 2)))
    kw_j = dict(base_color=jnp.asarray(base), depth_normal=jnp.asarray(dn))
    kw_t = dict(base_color=torch.from_numpy(base),
                depth_normal=torch.from_numpy(dn))
    ref = np.asarray(jnlm.nlm_denoise(jnp.asarray(color), jnp.asarray(v),
                                      **(kw_j if features else {})))
    out = tnlm.nlm_denoise(torch.from_numpy(color), torch.from_numpy(v.copy()),
                           **(kw_t if features else {})).numpy()
    _close(out, ref)
    # it filters: the output is smoother than the input
    assert np.abs(np.diff(out, axis=1)).mean() < np.abs(
        np.diff(color, axis=1)).mean()


def _carried(seed):
    color, half, base, dn = _buffers(seed)
    jr = JRenderer(JRenderSettings(W, H))
    tr = Renderer(RenderSettings(W, H), device="cpu")
    for name, a in (("full_buf", color), ("half_buf", half),
                    ("aux_base", base), ("aux_dn", dn)):
        flat = a.reshape(H * W, -1)
        setattr(jr, name, jnp.asarray(flat))
        setattr(tr, name, torch.from_numpy(flat.copy()))
    return jr, tr


def test_denoise_image_nlm_matches_ray_tpu():
    jr, tr = _carried(2)
    ref = np.asarray(jr.denoise_image("nlm"))
    out = tr.denoise_image("nlm")
    assert out.shape == (H, W, 3) and out.device.type == "cpu"
    _close(out.numpy(), ref)


def test_denoise_image_unet_matches_ray_tpu():
    jr, tr = _carried(3)
    ref = np.asarray(jr.denoise_image("unet"))
    out = tr.denoise_image("unet").numpy()
    assert out.shape == (H, W, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
