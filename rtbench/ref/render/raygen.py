"""Primary ray generation.

The port of ``ray_tpu.render.raygen``: per-pixel scrambled filter sample,
optional importance-sampled pixel filter table, thin-lens DOF with n-gon
bokeh and lens rotation/anamorphic ratio, sensor shift, and clip start/end
along the view direction (internal/CoreRef.cpp:1429-1553 in the reference
renderer).  Emits SoA ray tensors for one tile on ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtbench.ref.ops import rng
from rtbench.ref.ops.linalg import dot, normalize
from rtbench.ref.render.bsdf.microfacet import PI
from rtbench.ref.utils.device import resolve_device


class PrimaryRays(NamedTuple):
    ro: torch.Tensor           # (R, 3)
    rd: torch.Tensor           # (R, 3)
    t_max: torch.Tensor        # (R,)
    px: torch.Tensor           # (R,) i32 absolute pixel x
    py: torch.Tensor           # (R,) i32
    cone_spread: torch.Tensor  # () f32


def _lookup_filter_table(table, x):
    n = table.shape[0]
    xf = x * (n - 1)
    i0 = torch.clamp(xf.to(torch.int32), 0, n - 1)
    i1 = torch.clamp_max(i0 + 1, n - 1)
    t = xf - i0.to(torch.float32)
    return table[i0] * (1.0 - t) + table[i1] * t


def generate_primary_rays(
    cam,
    filter_table,
    x0,
    y0,
    iteration,
    rand_seed,
    *,
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    use_filter_table: bool,
    device=None,
) -> PrimaryRays:
    """Generate rays for the tile at (x0, y0) of size (tile_w, tile_h).
    ``cam`` is a :class:`~ray_tpu_torch.scene.camera.Camera`;
    ``filter_table`` a (n,) tensor or numpy array (read only when
    ``use_filter_table``).  ``device=None`` means CUDA, and raises when
    there is none."""
    dev = resolve_device(device)

    px = int(x0) + torch.arange(tile_w, dtype=torch.int32, device=dev)[None, :] \
        .expand(tile_h, tile_w).reshape(-1)
    py = int(y0) + torch.arange(tile_h, dtype=torch.int32, device=dev)[:, None] \
        .expand(tile_h, tile_w).reshape(-1)
    return rays_at(cam, filter_table, px, py, (int(iteration) - 1) & 0xFFFFFFFF,
                   rand_seed, width=width, height=height,
                   use_filter_table=use_filter_table)


def rays_at(cam, filter_table, px, py, sample, rand_seed, *, width: int,
            height: int, use_filter_table: bool) -> PrimaryRays:
    """The primary rays of any lanes: (R,) i32 ``px`` / ``py`` on the
    render device, ``sample`` the 0-based sample index (an int, or (R,)
    int64 for a sample of its own in each lane)."""
    dev = px.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    seed = rng.pixel_seed(px, py, rand_seed)
    rx, ry = rng.scrambled_2d_rand(rng.RAND_DIM_FILTER, seed, sample)
    if use_filter_table:
        table = f32(filter_table)
        rx = _lookup_filter_table(table, rx)
        ry = _lookup_filter_table(table, ry)
    fx = px.to(torch.float32) + rx
    fy = py.to(torch.float32) + ry

    fov, focus_distance = f32(cam.fov), f32(cam.focus_distance)
    origin0, side, up, fwd = f32(cam.origin), f32(cam.side), f32(cam.up), f32(cam.fwd)
    shift = f32(cam.shift)
    k = f32(width) / f32(height)
    temp = torch.tan(0.5 * fov * PI / 180.0)
    fov_k = temp * focus_distance
    spread_angle = torch.atan(2.0 * temp / f32(height))

    # thin-lens offset (CoreRef.cpp:1493-1520)
    lx, ly = rng.scrambled_2d_rand(rng.RAND_DIM_LENS, seed, sample)
    ox = 2.0 * lx - 1.0
    oy = 2.0 * ly - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    one = torch.ones_like(ox)
    theta = torch.where(
        use_x,
        0.25 * PI * (oy / torch.where(use_x, ox, one)),
        0.5 * PI - 0.25 * PI * (ox / torch.where(use_x, one, oy)),
    )
    if cam.lens_blades:
        # n-gon bokeh radius factor
        nb = float(cam.lens_blades)
        t2 = theta + 0.5 * PI  # reference ngon_rad convention
        rad = torch.cos(f32(PI / nb)) / torch.cos(
            t2 - (2.0 * PI / nb) * torch.floor((nb * t2 + PI) / (2.0 * PI))
        )
        r = r * rad
    theta = theta + f32(cam.lens_rotation)
    zero = (ox == 0.0) & (oy == 0.0)
    off_x = torch.where(zero, 0.0, 0.5 * r * torch.cos(theta) / f32(cam.lens_ratio))
    off_y = torch.where(zero, 0.0, 0.5 * r * torch.sin(theta))
    fstop = f32(cam.fstop)
    coc = 0.5 * torch.where(
        fstop > 0.0, f32(cam.focal_length) / torch.clamp_min(fstop, 1e-6), 0.0)
    off_x = off_x * coc * f32(cam.sensor_height)
    off_y = off_y * coc * f32(cam.sensor_height)

    origin = origin0[None, :] + side[None, :] * off_x[:, None] + up[None, :] * off_y[:, None]

    # pixel position on the focus plane (CoreRef.cpp:1441-1448)
    p_x = 2.0 * fov_k * (fx / f32(width) + shift[0] / k) - fov_k
    p_y = 2.0 * fov_k * (-fy / f32(height) + shift[1]) + fov_k
    p = (
        origin0[None, :]
        + (k * p_x)[:, None] * side[None, :]
        + p_y[:, None] * up[None, :]
        + focus_distance * fwd[None, :]
    )
    if cam.cam_type == 1:
        # orthographic: parallel rays through the image plane at the origin
        origin = p - focus_distance * fwd[None, :]
        d = fwd[None, :].expand_as(origin)
        spread_angle = f32(0.0)
    else:
        d = normalize(p - origin)

    d_dot_fwd = dot(d, fwd[None, :], False)
    clip_start = f32(cam.clip_start) / torch.clamp_min(d_dot_fwd, 1e-6)
    ro = origin + d * clip_start[:, None]
    t_max = f32(cam.clip_end) / torch.clamp_min(d_dot_fwd, 1e-6) - clip_start
    t_max = torch.clamp_max(t_max, 3.0e30)

    return PrimaryRays(
        ro=ro, rd=d.contiguous(), t_max=t_max, px=px, py=py,
        cone_spread=spread_angle,
    )
