"""Textures: host-side packing and per-ray sampling.

The port of ``ray_tpu.scene.textures``.  Every uncompressed texture lives
in one flat float32 RGBA texel table with per-mip records (offset, width,
height, format, block offset, block width); mip chains are built host-side
with a 2x2 box filter, and sRGB inputs are linearised at pack time.  The
texel table keeps ``ray_tpu``'s transposed (4, N) layout, so a scene's
tables are ``ray_tpu``'s bit for bit and texel values are differentiable
leaves.

Compressed textures (BC1/BC4/BC5/RGBE) are left out: no configuration
of the benchmark uses one, and ``add(..., compress=...)`` raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_MIP_LEVELS = 12  # reference internal/Constants.inl:92


def _srgb_to_linear_np(c):
    return np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _downsample2x(img: np.ndarray) -> np.ndarray:
    h, w, c = img.shape
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    img = img[: nh * 2, : nw * 2]
    if h >= 2 and w >= 2:
        return 0.25 * (
            img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2]
        )
    if h >= 2:
        return 0.5 * (img[0::2] + img[1::2])
    if w >= 2:
        return 0.5 * (img[:, 0::2] + img[:, 1::2])
    return img


@dataclasses.dataclass
class TexturePacker:
    """Accumulates textures; :meth:`pack` emits the flat tables + records."""

    texels: list = dataclasses.field(default_factory=list)
    records: list = dataclasses.field(default_factory=list)  # (offset, w, h, fmt, boff, bw) per (tex, mip)
    num_mips: list = dataclasses.field(default_factory=list)
    _offset: int = 0

    def add(self, image: np.ndarray, srgb: bool = False,
            generate_mips: bool = True, compress=False) -> int:
        """Add an image (H, W, C float in [0,1] or uint8); returns texture
        id.  Uncompressed only."""
        if compress:
            raise ValueError("the reference packs no compressed texture")
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] < 4:
            pad = np.ones(img.shape[:2] + (4 - img.shape[2],), np.float32)
            img = np.concatenate([img, pad], axis=2)
        if srgb:
            img = np.concatenate(
                [_srgb_to_linear_np(img[..., :3]), img[..., 3:4]], axis=2
            )
        tex_id = len(self.num_mips)
        mips = [img]
        if generate_mips:
            while mips[-1].shape[0] > 1 or mips[-1].shape[1] > 1:
                if len(mips) >= NUM_MIP_LEVELS:
                    break
                mips.append(_downsample2x(mips[-1]))
        for m in mips:
            h, w = m.shape[:2]
            self.records.append((self._offset, w, h, 0, 0, 0))
            self.texels.append(m.reshape(-1, 4))
            self._offset += w * h
        self.num_mips.append(len(mips))
        return tex_id

    def pack(self) -> dict:
        """Returns numpy dict: transposed texel table ``texels_t`` (4, N),
        ``tex_offset``/``tex_w``/``tex_h``/``tex_fmt``/``tex_boff``/
        ``tex_bw`` indexed by mip-record id, ``tex_mip0``/``tex_mips``
        indexed by texture id."""
        if not self.texels:
            texels = np.zeros((1, 4), np.float32)
            records = [(0, 1, 1, 0, 0, 0)]
            mip0, nmips = [0], [1]
        else:
            texels = np.concatenate(self.texels, axis=0).astype(np.float32)
            records = self.records
            mip0 = np.cumsum([0] + self.num_mips[:-1]).tolist()
            nmips = self.num_mips
        rec = np.asarray(records, np.int64)
        out = {
            "texels_t": np.ascontiguousarray(texels.T),
            "tex_offset": rec[:, 0].astype(np.int32),
            "tex_w": rec[:, 1].astype(np.int32),
            "tex_h": rec[:, 2].astype(np.int32),
            "tex_fmt": rec[:, 3].astype(np.int32),
            "tex_boff": rec[:, 4].astype(np.int32),
            "tex_bw": rec[:, 5].astype(np.int32),
            "tex_mip0": np.asarray(mip0, np.int32),
            "tex_mips": np.asarray(nmips, np.int32),
        }
        return out


def texture_lod(tex, tex_id, lam):
    """Per-texture mip level from the ray-cone LOD λ (reference
    get_texture_lod, internal/CoreRef.cpp:2838): λ plus 0.5·log2(w·h) of
    the texture's top level, minus 1 so that bilinear filtering always has
    4 texels; clamped to the texture's mips.  Detached."""
    safe_id = torch.clamp_min(tex_id, 0).long()
    mip0 = tex["tex_mip0"][safe_id].long()
    w = tex["tex_w"][mip0].to(torch.float32)
    h = tex["tex_h"][mip0].to(torch.float32)
    lod = lam + 0.5 * torch.log2(torch.clamp_min(w * h, 1.0)) - 1.0
    top = (tex["tex_mips"][safe_id] - 1).to(torch.float32)
    return torch.minimum(torch.clamp_min(lod, 0.0), top).detach()


def sample_bilinear(tex, tex_id, uv, lod=None, rand=None):
    """Texture fetch, vectorised over rays.

    ``tex_id``: (R,) i32 (< 0 reads white); ``uv``: (R, 2) with wrap-around
    addressing; ``lod``: (R,) mip level or None for level 0.  ``rand``:
    optional (R, 2) — stochastic filtering, one nearest tap at the jittered
    UV (its expectation is the 4-tap bilinear filter, used when ``rand`` is
    None).  Returns (R, 4) RGBA, differentiable w.r.t.
    ``tex["texels_t"]``."""
    safe_id = torch.clamp_min(tex_id, 0).long()
    mip0 = tex["tex_mip0"][safe_id]
    if lod is None:
        rec = mip0
    else:
        top = tex["tex_mips"][safe_id] - 1
        rec = mip0 + torch.minimum(torch.clamp_min(lod.to(torch.int32), 0), top)
    rec = rec.long()
    # tex_offset is texel-linear and can pass 2^24: an integer gather
    off = tex["tex_offset"][rec]
    w = tex["tex_w"][rec]
    h = tex["tex_h"][rec]

    u = uv[..., 0] * w.to(torch.float32) - 0.5
    v = uv[..., 1] * h.to(torch.float32) - 0.5
    texels_t = tex["texels_t"]

    def texel(xf, yf):
        # floor-mod (jnp.mod): negative texel indices wrap around
        xi = torch.remainder(xf.to(torch.int32), w)
        yi = torch.remainder(yf.to(torch.int32), h)
        idx = off + yi * w + xi
        return texels_t.index_select(1, idx.long())  # (4, R)

    if rand is not None:
        out = texel(torch.floor(u + rand[..., 0]), torch.floor(v + rand[..., 1]))
    else:
        x0 = torch.floor(u)
        y0 = torch.floor(v)
        fu = u - x0
        fv = v - y0
        c00, c10 = texel(x0, y0), texel(x0 + 1, y0)
        c01, c11 = texel(x0, y0 + 1), texel(x0 + 1, y0 + 1)
        out = (
            c00 * (1 - fu) * (1 - fv)
            + c10 * fu * (1 - fv)
            + c01 * (1 - fu) * fv
            + c11 * fu * fv
        )
    out = torch.where(tex_id[None, :] >= 0, out, torch.ones_like(out))
    return out.T
