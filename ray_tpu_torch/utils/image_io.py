"""Minimal image IO: TGA (the reference samples' output format,
samples/00_basic/main.cpp WriteTGA) and PFM (the reference's debug dump,
internal/RendererCPU.h:26 WritePFM).

A copy of ``ray_tpu.utils.image_io`` (numpy only): the writers take a
numpy array or a tensor (on any device) and write the same bytes as
``ray_tpu``'s; the readers return numpy arrays.
"""

from __future__ import annotations

import struct

import numpy as np


def _as_numpy(img) -> np.ndarray:
    """numpy array, or a tensor's values (detached, on the host)."""
    if hasattr(img, "detach"):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def write_tga(path: str, img) -> None:
    """Write (H, W, 3|4) float [0,1] or uint8 as an uncompressed TGA."""
    img = _as_numpy(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
        c = 3
    bpp = 32 if c == 4 else 24
    header = struct.pack(
        "<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, bpp, 0x20
    )
    bgr = img[..., [2, 1, 0]] if c >= 3 else img
    if c == 4:
        bgr = np.concatenate([bgr[..., :3], img[..., 3:4]], axis=2)
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(bgr).tobytes())


def _decode_tga_rle(raw: bytes, n_px: int, c: int) -> np.ndarray:
    """Decode TGA type-10 RLE packets into an (n_px, c) uint8 array."""
    out = np.empty((n_px, c), np.uint8)
    pos = 0
    px = 0
    buf = np.frombuffer(raw, np.uint8)
    while px < n_px:
        hdr = int(buf[pos])  # python int: uint8 arithmetic would overflow
        pos += 1
        count = (hdr & 0x7F) + 1
        if hdr & 0x80:  # run-length packet: one pixel repeated
            out[px:px + count] = buf[pos:pos + c]
            pos += c
        else:  # raw packet
            out[px:px + count] = buf[pos:pos + count * c].reshape(count, c)
            pos += count * c
        px += count
    return out


def read_tga(path: str) -> np.ndarray:
    """Read a true-color TGA — uncompressed (type 2) or RLE (type 10, the
    reference's WriteTGA output, internal/TextureUtils.cpp).  Returns
    (H, W, C) uint8 RGB(A)."""
    with open(path, "rb") as f:
        hdr = f.read(18)
        idlen, _, imgtype = hdr[0], hdr[1], hdr[2]
        assert imgtype in (2, 10), "only true-color TGA (raw or RLE)"
        w, h = struct.unpack("<HH", hdr[12:16])
        bpp, desc = hdr[16], hdr[17]
        f.read(idlen)
        c = bpp // 8
        if imgtype == 10:
            data = _decode_tga_rle(f.read(), h * w, c).reshape(h, w, c)
        else:
            data = np.frombuffer(f.read(w * h * c), np.uint8).reshape(h, w, c)
    rgb = data[..., [2, 1, 0]] if c >= 3 else data
    if c == 4:
        rgb = np.concatenate([rgb[..., :3], data[..., 3:4]], axis=2)
    if not (desc & 0x20):  # bottom-up origin
        rgb = rgb[::-1]
    return rgb


def write_pfm(path: str, img) -> None:
    """Write (H, W, 3) or (H, W) float32 as PFM (reference WritePFM,
    internal/RendererCPU.h:26)."""
    img = np.asarray(_as_numpy(img), np.float32)
    color = img.ndim == 3 and img.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.ascontiguousarray(img[::-1]).tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM written by :func:`write_pfm` (either byte order)."""
    with open(path, "rb") as f:
        kind = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(
            f.read(), "<f4" if scale < 0 else ">f4"
        )
    if kind == b"PF":
        return data.reshape(h, w, 3)[::-1].copy()
    return data.reshape(h, w)[::-1].copy()
