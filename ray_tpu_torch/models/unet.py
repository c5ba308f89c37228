"""UNet denoiser: the OIDN-style network of ``ray_tpu.models.unet``.

The reference embeds Intel OIDN's "hdr_alb_nrm" UNet
(internal/UNetFilter.cpp:98-293); ``ray_tpu`` writes it as a flax module
and ships weights it trained itself (``scripts/train_unet.py``).  Here it
is an ``nn.Module`` of ``Conv2d`` layers (3x3, padding 1, ReLU after each
but the last), 2x2 max-pools and nearest 2x upsampling, with the same
widths and skip order, and ``ray_tpu``'s weights, copied byte for byte
into ``ray_tpu_torch/data/unet_hdr_alb_nrm.npz`` and loaded with
:func:`unet_params_from_flax`.

Architecture (9 -> 3 channels: color, albedo, normal): encoder 32, 32, then
one block each of 48 / 64 / 80 after a pool, bottom 96 x 2 after a fourth
pool; the decoder upsamples, concatenates [h, skip] and runs two blocks
of 112 / 96 / 64 / 32; then a block of 16 and a 3x3 convolution to 3.

The public functions keep ``ray_tpu``'s layout, channels last (N, H, W, C).
The convolutions are cuDNN's on the card, as they are XLA's in
``ray_tpu``: no Pallas kernel stands behind them.  The filter turns TF32
off for its own calls (PyTorch lets cuDNN convolutions use TF32 by
default, which keeps about three decimal digits).
"""

from __future__ import annotations

import contextlib
import pathlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.utils.device import resolve_device

WEIGHTS_PATH = (pathlib.Path(__file__).resolve().parent.parent / "data"
                / "unet_hdr_alb_nrm.npz")


def hdr_transfer(c):
    """Range-compressing transfer for HDR inputs (``ray_tpu``'s log1p
    variant of OIDN's PU curve; exactly invertible)."""
    return torch.log1p(torch.clamp_min(c, 0.0))


def hdr_transfer_inv(c):
    return torch.expm1(torch.clamp_min(c, 0.0))


class UNetDenoiser(nn.Module):
    """(N, H, W, 9) -> (N, H, W, 3), H and W multiples of 16."""

    def __init__(self, enc_widths=(32, 48, 64, 80), bottom_width: int = 96,
                 dec_widths=(112, 96, 64, 32)):
        super().__init__()
        self.enc_widths = tuple(enc_widths)
        self.dec_widths = tuple(dec_widths)

        def conv(c_in, c_out):
            return nn.Conv2d(c_in, c_out, 3, padding=1)

        # in flax's creation order: ConvBlock_0 .. ConvBlock_15, then Conv_0
        blocks = [conv(9, enc_widths[0]), conv(enc_widths[0], enc_widths[0])]
        c = enc_widths[0]
        for w in enc_widths[1:]:
            blocks.append(conv(c, w))
            c = w
        blocks += [conv(c, bottom_width), conv(bottom_width, bottom_width)]
        c = bottom_width
        # the skips are each encoder width's last output
        for w, s in zip(dec_widths, reversed(enc_widths)):
            blocks += [conv(c + s, w), conv(w, w)]
            c = w
        blocks.append(conv(c, 16))
        self.blocks = nn.ModuleList(blocks)
        self.out = conv(16, 3)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        b = iter(self.blocks)
        h = F.relu(next(b)(h))
        h = F.relu(next(b)(h))
        skips = []
        for _ in self.enc_widths[1:]:
            skips.append(h)
            h = F.relu(next(b)(F.max_pool2d(h, 2)))
        skips.append(h)
        h = F.max_pool2d(h, 2)
        h = F.relu(next(b)(h))
        h = F.relu(next(b)(h))
        for skip in reversed(skips):
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h = torch.cat([h, skip], dim=1)
            h = F.relu(next(b)(h))
            h = F.relu(next(b)(h))
        h = F.relu(next(b)(h))
        return self.out(h).permute(0, 2, 3, 1)


def _flax_names(model: UNetDenoiser):
    """state_dict key -> flax flat name, for every parameter."""
    names = {}
    for i in range(len(model.blocks)):
        for leaf, flax_leaf in (("weight", "kernel"), ("bias", "bias")):
            names[f"blocks.{i}.{leaf}"] = (
                f"params/ConvBlock_{i}/Conv_0/{flax_leaf}")
    for leaf, flax_leaf in (("weight", "kernel"), ("bias", "bias")):
        names[f"out.{leaf}"] = f"params/Conv_0/{flax_leaf}"
    return names


def unet_params_from_flax(flat, model: UNetDenoiser | None = None) -> dict:
    """``ray_tpu``'s flat parameters (``"params/ConvBlock_i/Conv_0/kernel"``
    HWIO and ``".../bias"``, as numpy arrays) as a ``state_dict`` of
    ``model`` (OIHW kernels).  Raises ``ValueError`` on a missing, extra
    or misshapen array."""
    model = model if model is not None else UNetDenoiser()
    names = _flax_names(model)
    want = model.state_dict()
    extra = set(flat) - set(names.values())
    if extra:
        raise ValueError(f"unknown UNet parameters: {sorted(extra)}")
    out = {}
    for key, flax_name in names.items():
        if flax_name not in flat:
            raise ValueError(f"the UNet parameters lack {flax_name}")
        a = np.asarray(flat[flax_name], np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        if tuple(a.shape) != tuple(want[key].shape):
            raise ValueError(f"{flax_name} has shape {a.shape} for "
                             f"{tuple(want[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_trained_params() -> dict:
    """The trained weights as ``ray_tpu``'s flat arrays."""
    with np.load(WEIGHTS_PATH) as z:
        return {k: z[k] for k in z.files}


def _pad_to(x, mult: int):
    """Edge-pad (N, H, W, C) up to multiples of ``mult``; returns the
    padded tensor and the original (H, W)."""
    h, w = x.shape[1:3]
    ph, pw = (-h) % mult, (-w) % mult
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                  mode="replicate").permute(0, 2, 3, 1)
    return x, (h, w)


@contextlib.contextmanager
def _full_float32(device):
    """TF32 off for cuDNN and matmuls on the card, restored after."""
    if torch.device(device).type != "cuda":
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class UNetFilter:
    """Driver-facing wrapper (``ray_tpu``'s ``UNetFilter``): init, denoise,
    train.

    ``use_trained`` loads the copied weights; a file that does not fit the
    architecture raises (``ray_tpu`` prints and falls back to random
    weights).  ``use_trained=False`` initialises from a
    ``torch.Generator`` seeded with ``seed``: LeCun-normal kernels and zero
    biases, flax's scheme, but not flax's numbers.  ``device`` (keyword
    only): where the network lives, CUDA by default (``resolve_device``);
    ``denoise`` and ``train_step`` take their tensors there and raise on
    tensors elsewhere."""

    def __init__(self, seed: int = 0, use_trained: bool = True,
                 verbose: bool = False, *, device=None):
        self.device = torch.empty(0, device=resolve_device(device)).device
        self.model = UNetDenoiser()
        self.using_trained = False
        if use_trained:
            self.model.load_state_dict(
                unet_params_from_flax(load_trained_params(), self.model))
            self.using_trained = True
            if verbose:
                print(f"UNetFilter: loaded trained weights ({WEIGHTS_PATH})")
        else:
            g = torch.Generator().manual_seed(int(seed))
            with torch.no_grad():
                for m in self.model.modules():
                    if isinstance(m, nn.Conv2d):
                        fan_in = m.weight[0].numel()
                        m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                                       * (1.0 / fan_in) ** 0.5)
                        m.bias.zero_()
        self.model.to(self.device)

    def _check_device(self, **tensors):
        for name, t in tensors.items():
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the filter on "
                                 f"{self.device}")

    def _inputs(self, color, albedo, normal):
        self._check_device(color=color, albedo=albedo, normal=normal)
        return torch.cat([hdr_transfer(color), albedo, normal * 0.5 + 0.5],
                         dim=-1)

    def denoise(self, color, albedo, normal):
        """color / albedo / normal (H, W, 3) -> filtered (H, W, 3)."""
        x = self._inputs(color, albedo, normal)[None]
        x, (h, w) = _pad_to(x, 16)
        with torch.no_grad(), _full_float32(self.device):
            y = self.model(x)
        return hdr_transfer_inv(y[0, :h, :w])

    def train_step(self, opt_state, optimizer, noisy, albedo, normal,
                   target):
        """One optimizer step fitting the filter on (noisy -> target) pairs,
        (N, H, W, 3) each.  ``optimizer``: a ``torch.optim`` optimizer over
        ``self.model.parameters()`` — ``torch.optim.Adam(params, lr)`` has
        optax's ``adam`` defaults; ``opt_state``: its ``state_dict()`` to
        resume from, or None for its current state.  Returns (loss,
        ``optimizer.state_dict()``)."""
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
        self._check_device(target=target)
        with _full_float32(self.device):
            y = self.model(self._inputs(noisy, albedo, normal))
            loss = torch.mean(torch.abs(y - hdr_transfer(target)))
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
        return loss.detach(), optimizer.state_dict()
