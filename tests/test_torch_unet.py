"""The UNet denoiser (``ray_tpu_torch.models.unet``) against
``ray_tpu.models.unet``, on the CPU.

* ``_pad_to`` (edge padding to multiples of 16) exact; ``hdr_transfer`` /
  ``hdr_transfer_inv`` within 2 / 5 ulps (``log1p`` / ``expm1`` round
  differently in XLA's CPU code and PyTorch's).
* The copied weights (``ray_tpu_torch/data/unet_hdr_alb_nrm.npz``) are the
  reference file byte for byte (sha256), and ``unet_params_from_flax``
  carries every array (HWIO kernels to OIHW); a file that does not fit the
  architecture raises (``ray_tpu`` falls back to random weights).
* ``UNetFilter.denoise`` on the same 32x48 inputs (and a 30x44 one, which
  pads): within 1e-5 of the output's largest value — the convolutions sum
  in another order than XLA's.
* One ``train_step`` (``torch.optim.Adam(lr=1e-3)`` against
  ``optax.adam(1e-3)``, whose defaults it shares) from the trained
  weights: the loss within 1e-5 relative, and of each layer's updated
  parameters >= 99.9% within 2e-6 of ray_tpu's and all within 2e-5 (the
  step moves each by up to 1e-3; Adam's first step, lr g / (|g| + eps),
  magnifies the gradients' rounding where |g| is near eps).
* ``use_trained=False`` draws from a seeded ``torch.Generator``: the same
  seed gives the same weights, and they are not flax's (a known
  difference, ROADMAP).
"""

import hashlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import unet as J
from ray_tpu_torch.models import unet as T
import test_torch_scene  # noqa: F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _inputs(h, w, seed=0, batch=None):
    g = np.random.default_rng(seed)
    shape = (h, w, 3) if batch is None else (batch, h, w, 3)
    color = (g.random(shape) ** 2 * 4).astype(np.float32)
    albedo = g.random(shape).astype(np.float32)
    n = g.standard_normal(shape)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return color, albedo, n


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max()


def test_transfer_and_pad_exact():
    """``_pad_to`` exact; the transfer curves within a few ulps: XLA's CPU
    ``log1p`` / ``expm1`` and PyTorch's are not correctly rounded, and
    differ by up to 2 / 5 ulps on this range (exact at 0 and past the
    clamp)."""
    x = np.linspace(-1.0, 50.0, 100_001, dtype=np.float32)
    fwd = T.hdr_transfer(torch.from_numpy(x)).numpy()
    ref = np.asarray(J.hdr_transfer(jnp.asarray(x)))
    assert _ulps(fwd, ref) <= 2
    np.testing.assert_array_equal(fwd[x <= 0], 0.0)
    inv = T.hdr_transfer_inv(torch.from_numpy(x / 10)).numpy()
    assert _ulps(inv, np.asarray(J.hdr_transfer_inv(jnp.asarray(x / 10)))) <= 5
    a = np.random.default_rng(1).random((1, 30, 44, 9)).astype(np.float32)
    out, hw = T._pad_to(torch.from_numpy(a), 16)
    ref, rhw = J._pad_to(jnp.asarray(a), 16)
    assert hw == rhw == (30, 44) and tuple(out.shape) == (1, 32, 48, 9)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_weights_are_the_reference_file():
    digest = [hashlib.sha256(p.read_bytes()).hexdigest() for p in (
        ROOT / "ray_tpu" / "models" / "weights" / "unet_hdr_alb_nrm.npz",
        T.WEIGHTS_PATH)]
    assert digest[0] == digest[1]
    f = T.UNetFilter(device="cpu")
    assert f.using_trained
    flat = T.load_trained_params()
    for key, flax_name in T._flax_names(f.model).items():
        a = flat[flax_name]
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(f.model.state_dict()[key].numpy(), a)
    bad = dict(flat)
    bad["params/Conv_0/kernel"] = bad["params/Conv_0/kernel"][..., :2]
    with pytest.raises(ValueError, match="shape"):
        T.unet_params_from_flax(bad)
    del bad["params/Conv_0/kernel"]
    with pytest.raises(ValueError, match="lack"):
        T.unet_params_from_flax(bad)


@pytest.mark.parametrize("hw", [(32, 48), (30, 44)])
def test_denoise_matches_ray_tpu(hw):
    c, a, n = _inputs(*hw)
    ref = np.asarray(J.UNetFilter().denoise(jnp.asarray(c), jnp.asarray(a),
                                            jnp.asarray(n)))
    out = T.UNetFilter(device="cpu").denoise(
        torch.from_numpy(c), torch.from_numpy(a), torch.from_numpy(n)).numpy()
    assert out.shape == hw + (3,)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_train_step_matches_ray_tpu():
    import optax

    noisy, albedo, normal = _inputs(32, 48, seed=2, batch=1)
    target = (noisy * 0.8).astype(np.float32)
    jf = J.UNetFilter()
    opt = optax.adam(1e-3)
    j_loss, _ = jf.train_step(opt.init(jf.params), opt,
                              *(jnp.asarray(x) for x in (noisy, albedo,
                                                         normal, target)))
    tf = T.UNetFilter(device="cpu")
    t_opt = torch.optim.Adam(tf.model.parameters(), lr=1e-3)
    t_loss, state = tf.train_step(None, t_opt,
                                  *(torch.from_numpy(x) for x in (
                                      noisy, albedo, normal, target)))
    assert isinstance(state, dict) and state["state"]
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    flat = {k: np.asarray(v) for k, v in _flat(jf.params).items()}
    moved = 0.0
    for key, flax_name in T._flax_names(tf.model).items():
        ref = flat[flax_name]
        if ref.ndim == 4:
            ref = ref.transpose(3, 2, 0, 1)
        out = tf.model.state_dict()[key].numpy()
        # Adam's first step is lr g / (|g| + eps): where |g| is near eps
        # it magnifies the gradients' summation-order differences
        err = np.abs(out - ref)
        assert (err <= 2e-6).mean() >= 0.999 and err.max() <= 2e-5, (
            key, err.max(), (err > 2e-6).mean())
        moved = max(moved, float(np.abs(
            out - T.load_trained_params()[flax_name].transpose(
                *((3, 2, 0, 1) if ref.ndim == 4 else (0,)))).max()))
    assert moved > 5e-4   # the step moved the weights


def test_filter_runs_where_it_lives():
    """CUDA by default (raising without it); tensors on another device than
    the filter's raise instead of being copied across."""
    if torch.cuda.is_available():
        assert T.UNetFilter(use_trained=False).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.UNetFilter(use_trained=False)
    f = T.UNetFilter(use_trained=False, device="cpu")
    c = torch.zeros(16, 16, 3)
    away = torch.zeros(16, 16, 3, device="meta")
    with pytest.raises(ValueError, match="albedo is on meta"):
        f.denoise(c, away, c)
    opt = torch.optim.Adam(f.model.parameters())
    with pytest.raises(ValueError, match="target is on meta"):
        f.train_step(None, opt, c[None], c[None], c[None], away[None])


def _flat(params, prefix=""):
    out = {}
    for k, v in params.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = v
    return out


def test_random_init_is_seeded_and_not_flax():
    a = T.UNetFilter(seed=3, use_trained=False, device="cpu")
    b = T.UNetFilter(seed=3, use_trained=False, device="cpu")
    c = T.UNetFilter(seed=4, use_trained=False, device="cpu")
    assert not a.using_trained
    w = [f.model.state_dict()["blocks.0.weight"] for f in (a, b, c)]
    assert torch.equal(w[0], w[1]) and not torch.equal(w[0], w[2])
    # the variance of flax's LeCun-normal init (1 / fan_in), other numbers
    assert abs(float(w[0].var()) * 81 - 1.0) < 0.2
    flax_w = np.asarray(J.UNetFilter(seed=3, use_trained=False).params[
        "params"]["ConvBlock_0"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
    assert not np.allclose(w[0].numpy(), flax_w)
