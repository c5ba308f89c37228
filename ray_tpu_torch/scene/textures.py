"""Textures: host-side packing and per-ray sampling.

The port of ``ray_tpu.scene.textures``.  Every uncompressed texture lives
in one flat float32 RGBA texel table with per-mip records (offset, width,
height, format, block offset, block width); mip chains are built host-side
with a 2x2 box filter, and sRGB inputs are linearised at pack time.  The
texel table keeps ``ray_tpu``'s transposed (4, N) layout, so a scene's
tables are ``ray_tpu``'s bit for bit and texel values are differentiable
leaves.

``add(..., compress=...)`` stores a texture's mips compressed, with
``ray_tpu``'s numpy encoders (copied here): ``"bc1"`` (or ``True``) — two
RGB endpoints and 16 2-bit indices a 4x4 block; ``"bc4"`` — one channel,
two endpoints and 16 3-bit indices over two words; ``"bc5"`` — two BC4
payloads (normal-map XY, z rebuilt by ``apply_normal_map``); ``"rgbe"`` —
one shared-exponent word a texel (environment maps).  Blocks are rows of
the (8, B) float32 table ``blocks_t``, RGBE words the (1, N) ``rgbe_t``;
index words ride as float32 bit patterns and are read back with
``Tensor.view(torch.int32)``.  The decode in :func:`sample_bilinear` runs
only when the pack holds such a table, and compressed texels carry no
gradient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_MIP_LEVELS = 12  # reference internal/Constants.inl:92
ANISO_TAPS = 4       # taps along the footprint's major axis (aniso filter)


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
    blocks: list = dataclasses.field(default_factory=list)
    rgbe: list = dataclasses.field(default_factory=list)
    _offset: int = 0
    _boffset: int = 0
    _roffset: int = 0

    def add(self, image: np.ndarray, srgb: bool = False,
            generate_mips: bool = True, compress=False) -> int:
        """Add an image (H, W, C float in [0,1] or uint8); returns texture
        id.  ``compress``: False | "bc1"/True | "bc4" | "bc5" | "rgbe"
        (module docstring)."""
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
        fmt_code = {False: 0, True: 1, "bc1": 1, "bc4": 2, "bc5": 3,
                    "rgbe": 4}[compress]
        for m in mips:
            h, w = m.shape[:2]
            if fmt_code == 4:
                words = _encode_rgbe(m)  # (h*w,) f32-bitcast words
                self.records.append(
                    (self._offset, w, h, 4, self._roffset, 0))
                self.rgbe.append(words)
                self._roffset += w * h
                self.blocks.append(None)
                self.texels.append(np.zeros((1, 4), np.float32))
                self._offset += 1
            elif fmt_code:
                if fmt_code == 1:
                    blk, bw, bh = _encode_blocks(m)
                elif fmt_code == 2:
                    blk, bw, bh = _encode_blocks_bc4(m[..., 0])
                else:
                    blk, bw, bh = _encode_blocks_bc5(m)
                self.records.append(
                    (self._offset, w, h, fmt_code, self._boffset, bw))
                self.blocks.append(blk)
                self._boffset += bw * bh
                # 1-texel raw placeholder keeps the raw offsets valid
                self.texels.append(np.zeros((1, 4), np.float32))
                self._offset += 1
            else:
                self.records.append((self._offset, w, h, 0, 0, 0))
                self.blocks.append(None)
                self.texels.append(m.reshape(-1, 4))
                self._offset += w * h
        self.num_mips.append(len(mips))
        return tex_id

    def get_image(self, tex_id: int, mip: int = 0) -> "np.ndarray":
        """Mip level ``mip`` of texture ``tex_id`` as (H, W, 4) float32 —
        the packed, linearised texels, decoded from its blocks or RGBE
        words when compressed; what finalize builds the environment's
        importance tables from (``ray_tpu``'s ``get_image``)."""
        rec = int(np.cumsum([0] + self.num_mips[:-1])[tex_id]) + mip
        off, w, h, fmt, boff, bw = self.records[rec]
        if fmt in (1, 2, 3):
            return _decode_blocks_np(self.blocks[rec], w, h, fmt)
        if fmt == 4:
            # rgbe blobs are stored in add() order; find this record's blob
            k = sum(1 for r in self.records[:rec] if r[3] == 4)
            return _decode_rgbe_np(self.rgbe[k], w, h)
        return self.texels[rec].reshape(h, w, 4)

    def pack(self) -> dict:
        """Returns numpy dict: transposed texel table ``texels_t`` (4, N),
        ``tex_offset``/``tex_w``/``tex_h``/``tex_fmt``/``tex_boff``/
        ``tex_bw`` indexed by mip-record id, ``tex_mip0``/``tex_mips``
        indexed by texture id, and only when a texture is stored so, the
        block table ``blocks_t`` (8, B) and the RGBE words ``rgbe_t``
        (1, N) (their presence switches the decode on)."""
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
        used = [b for b in self.blocks if b is not None]
        if used:
            blocks = np.concatenate(used, axis=0)
            out["blocks_t"] = np.ascontiguousarray(blocks.T)
        if self.rgbe:
            out["rgbe_t"] = np.concatenate(self.rgbe)[None, :]
        return out


BLOCK_COLS = 8  # uniform block-row width across BC1/BC4/BC5


def _block_tiles(img2d: np.ndarray):
    """(H, W) or (H, W, C) → (bh*bw, 16[, C]) 4×4 tiles with edge-replicated
    padding so partial blocks don't skew endpoints."""
    h, w = img2d.shape[:2]
    bw, bh = (w + 3) // 4, (h + 3) // 4
    shape = (bh * 4, bw * 4) + img2d.shape[2:]
    padded = np.zeros(shape, np.float32)
    padded[:h, :w] = img2d
    if h < bh * 4:
        padded[h:, :w] = padded[h - 1:h, :w]
    if w < bw * 4:
        padded[:, w:] = padded[:, w - 1:w]
    if img2d.ndim == 2:
        tiles = padded.reshape(bh, 4, bw, 4).transpose(0, 2, 1, 3)
        return tiles.reshape(bh * bw, 16), bw, bh
    c = img2d.shape[2]
    tiles = padded.reshape(bh, 4, bw, 4, c).transpose(0, 2, 1, 3, 4)
    return tiles.reshape(bh * bw, 16, c), bw, bh


def _encode_blocks(img: np.ndarray):
    """BC1-style encode of (H, W, 4) → (bw*bh, 8) f32 block rows:
    [min_rgb(3) | max_rgb(3) | idx_word bitcast | 0].  Each texel stores a
    2-bit position along the min→max diagonal (vectorized numpy)."""
    blocks, bw, bh = _block_tiles(img[..., :3])
    cmin = blocks.min(axis=1)
    cmax = blocks.max(axis=1)
    axis = cmax - cmin
    denom = np.maximum((axis * axis).sum(axis=1, keepdims=True), 1e-12)
    t = ((blocks - cmin[:, None]) * axis[:, None]).sum(axis=2) / denom
    q = np.clip(np.round(t * 3.0), 0, 3).astype(np.uint32)       # (B, 16)
    word = np.zeros(blocks.shape[0], np.uint32)
    for k in range(16):
        word |= q[:, k] << np.uint32(2 * k)
    pad = np.zeros((blocks.shape[0], 1), np.float32)
    return (
        np.concatenate(
            [cmin, cmax, word[:, None].view(np.float32), pad], axis=1
        ).astype(np.float32),
        bw, bh,
    )


def _bc4_payload(chan_tiles: np.ndarray):
    """(B, 16) channel tiles → (e0, e1, word_lo, word_hi): two scalar
    endpoints + 16 × 3-bit indices split over two u32 words (texels 0-9 /
    10-15), the BC4 scheme (TextureUtils.h:89) in f32 block rows."""
    e0 = chan_tiles.min(axis=1)
    e1 = chan_tiles.max(axis=1)
    denom = np.maximum(e1 - e0, 1e-12)
    q = np.clip(
        np.round((chan_tiles - e0[:, None]) / denom[:, None] * 7.0), 0, 7
    ).astype(np.uint32)
    lo = np.zeros(chan_tiles.shape[0], np.uint32)
    hi = np.zeros(chan_tiles.shape[0], np.uint32)
    for k in range(10):
        lo |= q[:, k] << np.uint32(3 * k)
    for k in range(10, 16):
        hi |= q[:, k] << np.uint32(3 * (k - 10))
    return e0, e1, lo.view(np.float32), hi.view(np.float32)


def _encode_blocks_bc4(chan: np.ndarray):
    """Single-channel BC4: rows [e0, e1, w_lo, w_hi, 0, 0, 0, 0]."""
    tiles, bw, bh = _block_tiles(chan)
    e0, e1, lo, hi = _bc4_payload(tiles)
    z = np.zeros_like(e0)
    return (
        np.stack([e0, e1, lo, hi, z, z, z, z], axis=1).astype(np.float32),
        bw, bh,
    )


def _encode_blocks_bc5(img: np.ndarray):
    """Dual-channel BC5 (two BC4 payloads — normal-map XY):
    rows [e0x, e1x, wx_lo, wx_hi, e0y, e1y, wy_lo, wy_hi]."""
    tx, bw, bh = _block_tiles(img[..., 0])
    ty, _, _ = _block_tiles(img[..., 1])
    e0x, e1x, lx, hx = _bc4_payload(tx)
    e0y, e1y, ly, hy = _bc4_payload(ty)
    return (
        np.stack([e0x, e1x, lx, hx, e0y, e1y, ly, hy], axis=1).astype(
            np.float32),
        bw, bh,
    )


def _encode_rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) → (H*W,) f32-bitcast packed RGBE words using the
    reference's quantization (rgb_to_rgbe, SceneCommon.cpp:7-17):
    mantissas = rgb * frexp(max)/max * 256, exponent biased by 128."""
    rgb = np.maximum(img[..., :3].reshape(-1, 3), 0.0)
    mx = rgb.max(axis=1)
    m, e = np.frexp(mx)
    factor = np.where(mx >= 1e-32, m * 256.0 / np.maximum(mx, 1e-32), 0.0)
    q = np.clip(rgb * factor[:, None], 0.0, 255.0).astype(np.uint32)
    eq = np.where(mx >= 1e-32, e + 128, 0).astype(np.uint32)
    word = q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (eq << 24)
    return word.view(np.float32)


def _decode_rgbe_np(words: np.ndarray, w: int, h: int) -> np.ndarray:
    u = words.view(np.uint32)
    r = (u & 255).astype(np.float32)
    g = ((u >> 8) & 255).astype(np.float32)
    b = ((u >> 16) & 255).astype(np.float32)
    e = ((u >> 24) & 255).astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 128 - 8), 0.0).astype(
        np.float32)
    out = np.ones((h * w, 4), np.float32)
    out[:, 0] = r * scale
    out[:, 1] = g * scale
    out[:, 2] = b * scale
    return out.reshape(h, w, 4)


def _decode_blocks_np(blk: np.ndarray, w: int, h: int,
                      fmt: int = 1) -> np.ndarray:
    """Inverse of the block encoders (host-side, for get_image/tests)."""
    bw = (w + 3) // 4
    out = np.ones((h, w, 4), np.float32)
    if fmt == 1:
        cmin, cmax = blk[:, 0:3], blk[:, 3:6]
        word = np.ascontiguousarray(blk[:, 6]).view(np.uint32)
        for y in range(h):
            for x in range(w):
                b = (y // 4) * bw + (x // 4)
                sub = (y % 4) * 4 + (x % 4)
                t = ((word[b] >> np.uint32(2 * sub)) & 3) / 3.0
                out[y, x, :3] = cmin[b] + (cmax[b] - cmin[b]) * t
        return out

    def bc4_at(cols, b, sub):
        e0, e1 = blk[b, cols], blk[b, cols + 1]
        lo = np.ascontiguousarray(blk[:, cols + 2]).view(np.uint32)[b]
        hi = np.ascontiguousarray(blk[:, cols + 3]).view(np.uint32)[b]
        q = (lo >> np.uint32(3 * sub)) & 7 if sub < 10 else (
            (hi >> np.uint32(3 * (sub - 10))) & 7)
        return e0 + (e1 - e0) * (q / 7.0)

    for y in range(h):
        for x in range(w):
            b = (y // 4) * bw + (x // 4)
            sub = (y % 4) * 4 + (x % 4)
            v = bc4_at(0, b, sub)
            if fmt == 2:
                out[y, x, :3] = v
            else:
                out[y, x, 0] = v
                out[y, x, 1] = bc4_at(4, b, sub)
                out[y, x, 2] = 0.5
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


def sample_bilinear(tex, tex_id, uv, lod=None, rand=None, aniso_duv=None,
                    aniso_rand=None):
    """Texture fetch, vectorised over rays.

    ``tex_id``: (R,) i32 (< 0 reads white); ``uv``: (R, 2) with wrap-around
    addressing; ``lod``: (R,) mip level or None for level 0.  ``rand``:
    optional (R, 2) — stochastic filtering, one nearest tap at the jittered
    UV (its expectation is the 4-tap bilinear filter, used when ``rand`` is
    None).  ``aniso_duv``/``aniso_rand``: ``ANISO_TAPS`` such taps along
    the footprint's major axis.  Returns (R, 4) RGBA, differentiable
    w.r.t. ``tex["texels_t"]``."""
    if aniso_duv is not None and aniso_rand is not None:
        outs = []
        for k in range(ANISO_TAPS):
            frac = (k + aniso_rand) / ANISO_TAPS - 0.5
            outs.append(sample_bilinear(
                tex, tex_id, uv + aniso_duv * frac[..., None], lod, rand=rand))
        return sum(outs) / ANISO_TAPS
    compressed = "blocks_t" in tex  # any BC1/BC4/BC5 texture packed
    has_rgbe = "rgbe_t" in tex      # any RGBE texture packed
    decode = compressed or has_rgbe
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
    if decode:
        fmt = tex["tex_fmt"][rec]
        boff = tex["tex_boff"][rec]
        bw = tex["tex_bw"][rec]

    u = uv[..., 0] * w.to(torch.float32) - 0.5
    v = uv[..., 1] * h.to(torch.float32) - 0.5
    texels_t = tex["texels_t"]

    def texel(xf, yf):
        # floor-mod (jnp.mod): negative texel indices wrap around
        xi = torch.remainder(xf.to(torch.int32), w)
        yi = torch.remainder(yf.to(torch.int32), h)
        idx = off + yi * w + xi
        if not decode:
            return texels_t.index_select(1, idx.long())  # (4, R)
        # a compressed record's raw slot is one placeholder texel: its
        # lanes' indices (and the other tables' for other formats) are
        # clamped into range and their values replaced below, as
        # ray_tpu's out-of-range takes are
        out = texels_t.index_select(
            1, torch.clamp(idx, max=texels_t.shape[1] - 1).long())
        if compressed:
            blocks_t = tex["blocks_t"]
            b = boff + (yi >> 2) * bw + (xi >> 2)
            blk = blocks_t.index_select(
                1, torch.clamp(b, max=blocks_t.shape[1] - 1).long())  # (8, R)
            sub = (yi & 3) * 4 + (xi & 3)
            ones = torch.ones_like(blk[0])[None, :]
            # BC1: lerp the RGB endpoints by the 2-bit index
            word = blk[6].view(torch.int32)
            t = ((word >> (2 * sub)) & 3).to(torch.float32) * (1.0 / 3.0)
            rgb = blk[0:3] + (blk[3:6] - blk[0:3]) * t[None, :]
            bc1 = torch.cat([rgb, ones], dim=0)
            out = torch.where(fmt[None, :] == 1, bc1, out)

            # BC4/BC5: 3-bit indices over two words per channel (the
            # shift of the word not taken is clamped into range)
            def bc4(cols):
                lo = blk[cols + 2].view(torch.int32)
                hi = blk[cols + 3].view(torch.int32)
                q = torch.where(
                    sub < 10,
                    (lo >> torch.clamp(3 * sub, max=27)) & 7,
                    (hi >> torch.clamp(3 * (sub - 10), min=0)) & 7,
                ).to(torch.float32) * (1.0 / 7.0)
                return blk[cols] + (blk[cols + 1] - blk[cols]) * q

            v0 = bc4(0)[None, :]
            bc4_dec = torch.cat([v0, v0, v0, ones], dim=0)
            out = torch.where(fmt[None, :] == 2, bc4_dec, out)
            v1 = bc4(4)[None, :]
            bc5_dec = torch.cat([v0, v1, 0.5 * ones, ones], dim=0)
            out = torch.where(fmt[None, :] == 3, bc5_dec, out)
        if has_rgbe:
            # shared-exponent HDR (rgbe_to_rgb: rgb · 2^(e-136))
            words = tex["rgbe_t"][0]
            word = words.index_select(0, torch.clamp(
                boff + yi * w + xi, max=words.shape[0] - 1).long()).view(
                    torch.int32)
            e = (word >> 24) & 255
            scale = torch.where(
                e > 0, torch.exp2((e - 136).to(torch.float32)), 0.0)
            rgbe = torch.stack([
                (word & 255).to(torch.float32) * scale,
                ((word >> 8) & 255).to(torch.float32) * scale,
                ((word >> 16) & 255).to(torch.float32) * scale,
                torch.ones_like(scale),
            ], dim=0)
            out = torch.where(fmt[None, :] == 4, rgbe, out)
        return out

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
