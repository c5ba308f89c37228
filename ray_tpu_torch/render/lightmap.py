"""Geo-camera / lightmap-baking ray source.

The port of ``ray_tpu.render.lightmap`` (the reference's
``SampleMeshInTextureSpace``, internal/CoreRef.cpp:1555-1653): the
"camera" is a mesh's UV unwrap, and every lightmap texel covered by a
triangle gets one ray.  The UV triangles are rasterized once on the host
with ``ray_tpu``'s numpy float32 operations, so the rays, the coverage mask
and the covering triangles are ``ray_tpu``'s bit for bit; only the
:class:`PrimaryRays` batch moves to the device.  Each ray starts a hair
above its texel's surface point looking down the inverted normal, so the
integrator traces and shades it like a camera ray: the first hit is the
texel's surface.

Typical use: bake with ``PassSettings(lighting_only=True,
output_sh=True)`` for SH lightmaps, or plain radiance for flat lightmaps.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.render.raygen import PrimaryRays
from ray_tpu_torch.utils.device import resolve_device

_BIAS = 1e-3


def _host(x):
    """A tensor or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def rasterize_uv_rays(vertices, normals, uvs, tri_vidx, width, height,
                      prim_lo=0, prim_hi=None, *, device=None):
    """Rasterize UV-space triangles onto a (height, width) texel grid.

    ``vertices``, ``normals``, ``uvs`` and ``tri_vidx`` are a finalized
    scene's tables (tensors or numpy arrays; the work is numpy on the
    host).  ``prim_lo`` / ``prim_hi`` restrict it to one triangle range
    (the reference bakes one mesh at a time, CoreRef.cpp:1579; a finalized
    scene keeps its triangles in BVH leaf order).  Returns ``(rays, mask,
    prim)``: a PrimaryRays batch of height * width rays (uncovered texels
    get dead rays), the (R,) bool coverage mask and the (R,) int32 covering
    triangle, all on ``device`` (CUDA unless named).

    First-covering-triangle-wins, matching the reference's
    ``out_inter.v >= 0 → skip`` rule (CoreRef.cpp:1625).
    """
    dev = resolve_device(device)
    vertices = np.asarray(_host(vertices), np.float32)
    normals = np.asarray(_host(normals), np.float32)
    uvs = np.asarray(_host(uvs), np.float32)
    tri_vidx = np.asarray(_host(tri_vidx), np.int32)
    if prim_hi is None:
        prim_hi = tri_vidx.shape[0]

    R = width * height
    ro = np.zeros((R, 3), np.float32)
    rd = np.zeros((R, 3), np.float32)
    rd[:, 1] = 1.0
    covered = np.zeros((R,), bool)
    prim_out = np.full((R,), -1, np.int32)

    size = np.array([width, height], np.float32)
    for tri in range(prim_lo, prim_hi):
        i0, i1, i2 = tri_vidx[tri]
        # v flip matches the reference (t[1] → 1 - t[1], CoreRef.cpp:1585)
        t0 = np.array([uvs[i0, 0], 1.0 - uvs[i0, 1]]) * size
        t1 = np.array([uvs[i1, 0], 1.0 - uvs[i1, 1]]) * size
        t2 = np.array([uvs[i2, 0], 1.0 - uvs[i2, 1]]) * size

        bb_min = np.floor(np.minimum(np.minimum(t0, t1), t2)).astype(int)
        bb_max = np.round(np.maximum(np.maximum(t0, t1), t2)).astype(int)
        bb_min = np.maximum(bb_min, 0)
        bb_max = np.minimum(bb_max, [width - 1, height - 1])
        if (bb_max < bb_min).any():
            continue

        d01 = t0 - t1
        d12 = t1 - t2
        d20 = t2 - t0
        area = d01[0] * d20[1] - d20[0] * d01[1]
        if area < 1e-7:
            continue
        inv_area = 1.0 / area

        xs = np.arange(bb_min[0], bb_max[0] + 1)
        ys = np.arange(bb_min[1], bb_max[1] + 1)
        gx, gy = np.meshgrid(xs, ys)
        fx = gx.astype(np.float32)
        fy = gy.astype(np.float32)
        # edge functions (CoreRef.cpp:1633-1637)
        u = d01[0] * (fy - t0[1]) - d01[1] * (fx - t0[0])
        v = d12[0] * (fy - t1[1]) - d12[1] * (fx - t1[0])
        w = d20[0] * (fy - t2[1]) - d20[1] * (fx - t2[0])
        inside = (u >= -1e-7) & (v >= -1e-7) & (w >= -1e-7)
        if not inside.any():
            continue

        lin = (gy * width + gx)[inside]
        fresh = ~covered[lin]
        lin = lin[fresh]
        if lin.size == 0:
            continue
        bu = (u[inside][fresh] * inv_area).astype(np.float32)
        bv = (v[inside][fresh] * inv_area).astype(np.float32)
        bw = 1.0 - bu - bv
        # barycentric convention: u at v2's corner, v at v0's, w at v1's
        p = (
            bv[:, None] * vertices[i0]
            + bw[:, None] * vertices[i1]
            + bu[:, None] * vertices[i2]
        )
        n = (
            bv[:, None] * normals[i0]
            + bw[:, None] * normals[i1]
            + bu[:, None] * normals[i2]
        )
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        ro[lin] = p + n * _BIAS
        rd[lin] = -n
        covered[lin] = True
        prim_out[lin] = tri

    px = np.tile(np.arange(width, dtype=np.int32), height)
    py = np.repeat(np.arange(height, dtype=np.int32), width)
    rays = PrimaryRays(
        ro=torch.from_numpy(ro).to(dev),
        rd=torch.from_numpy(rd).to(dev),
        t_max=torch.full((R,), 8.0 * _BIAS, dtype=torch.float32, device=dev),
        px=torch.from_numpy(px).to(dev),
        py=torch.from_numpy(py).to(dev),
        cone_spread=torch.zeros((), dtype=torch.float32, device=dev),
    )
    return rays, torch.from_numpy(covered).to(dev), \
        torch.from_numpy(prim_out).to(dev)


def bake_lightmap(scene, width, height, settings, iterations=16,
                  rand_seed=0, prim_lo=0, prim_hi=None):
    """Render ``iterations`` samples of a lightmap for the (flatten-mode)
    scene's UV unwrap, on the scene's device.  Returns a dict of numpy
    arrays: 'color' (H,W,3), 'mask' (H,W) and — when
    ``settings.output_sh`` — 'shl1' (H,W,4,3)."""
    from ray_tpu_torch.render.integrator import render_tile

    device = scene.device
    rays, mask, _prim = rasterize_uv_rays(
        scene.vertices, scene.normals, scene.uvs, scene.tri_vidx,
        width, height, prim_lo, prim_hi, device=device,
    )
    acc = torch.zeros((height * width, 3), dtype=torch.float32, device=device)
    sh = torch.zeros((height * width, 4, 3), dtype=torch.float32,
                     device=device)
    for it in range(1, iterations + 1):
        out = render_tile(
            scene, None, None, 0, 0, it, rand_seed,
            width=width, height=height, tile_w=width, tile_h=height,
            settings=settings, use_filter_table=False,
            pixel_mask=mask, rays=rays,
        )
        acc = acc + out["color"]
        if settings.output_sh:
            sh = sh + out["shl1"]
    result = {
        "color": (acc / iterations).cpu().numpy().reshape(height, width, 3),
        "mask": mask.cpu().numpy().reshape(height, width),
    }
    if settings.output_sh:
        result["shl1"] = (sh / iterations).cpu().numpy().reshape(
            height, width, 4, 3)
    return result
