"""Camera model (host-side numpy).

The port of ``ray_tpu.scene.camera``: the same construction
(internal/Core.cpp:1321-1366 in the reference renderer) and the same
pixel-filter importance table.  :class:`Camera` is a plain frozen dataclass
of numpy float32 scalars and vec3s; ``render.raygen`` moves what it needs
to the render device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


class CamType:
    """eCamType (Types.h:62).  GEO has no camera object."""

    PERSP = 0
    ORTHO = 1


class PixelFilter:
    BOX = 0
    GAUSSIAN = 1
    BLACKMAN_HARRIS = 2


@dataclasses.dataclass(frozen=True)
class Camera:
    """Frozen camera parameters (float32 numpy scalars and vec3s)."""

    origin: np.ndarray
    fwd: np.ndarray
    side: np.ndarray
    up: np.ndarray
    shift: np.ndarray        # sensor shift (2,)
    fov: np.ndarray          # vertical fov, degrees
    focus_distance: np.ndarray
    focal_length: np.ndarray
    fstop: np.ndarray
    sensor_height: np.ndarray
    exposure: np.ndarray     # 2^exposure multiplier applied at resolve
    gamma: np.ndarray        # output pow(c, 1/gamma) after the view transform
    lens_rotation: np.ndarray
    lens_ratio: np.ndarray
    clip_start: np.ndarray
    clip_end: np.ndarray
    lens_blades: int
    filter: int
    filter_width: float
    cam_type: int = 0


def make_camera(
    origin,
    look_at=None,
    fwd=None,
    up=(0.0, 1.0, 0.0),
    fov: float = 45.0,
    focal_len: float = None,
    shift=(0.0, 0.0),
    sensor_height: float = 0.036,
    exposure: float = 0.0,
    gamma: float = 1.0,
    focus_distance: float = 1.0,
    fstop: float = 0.0,
    lens_rotation: float = 0.0,
    lens_ratio: float = 1.0,
    lens_blades: int = 0,
    clip_start: float = 0.0,
    clip_end: float = 3.402823466e30,
    filter: int = PixelFilter.BOX,
    filter_width: float = 1.5,
    cam_type: int = 0,
) -> Camera:
    """Build a perspective camera.

    Orthonormalization follows internal/Core.cpp:1328-1340: a degenerate
    ``up`` is replaced by X or Y depending on how vertical ``fwd`` is, then
    side = normalize(fwd × up), up = side × fwd.
    """
    o = np.asarray(origin, dtype=np.float32)
    if fwd is None:
        if look_at is None:
            raise ValueError("provide either look_at or fwd")
        fwd = np.asarray(look_at, dtype=np.float32) - o
    f = np.asarray(fwd, dtype=np.float32)
    f = f / np.linalg.norm(f)
    u = np.asarray(up, dtype=np.float32)
    if float(u @ u) < 1e-7:
        u = (
            np.array([1.0, 0.0, 0.0], np.float32)
            if abs(float(f[1])) >= 0.999
            else np.array([0.0, 1.0, 0.0], np.float32)
        )
    s = np.cross(f, u)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)

    if focal_len is not None:
        fov = math.degrees(
            2.0 * math.atan(0.5 * sensor_height / float(focal_len))
        )
    focus_distance = max(float(focus_distance), 0.0)
    focal_length = 0.5 * sensor_height / math.tan(0.5 * math.radians(float(fov)))

    def f32(x):
        return np.float32(x)

    return Camera(
        origin=o,
        fwd=f,
        side=s.astype(np.float32),
        up=u.astype(np.float32),
        shift=np.asarray(shift, dtype=np.float32),
        fov=f32(fov),
        focus_distance=f32(focus_distance),
        focal_length=f32(focal_length),
        fstop=f32(fstop),
        sensor_height=f32(sensor_height),
        exposure=f32(exposure),
        gamma=f32(gamma),
        lens_rotation=f32(lens_rotation),
        lens_ratio=f32(lens_ratio),
        clip_start=f32(clip_start),
        clip_end=f32(clip_end),
        lens_blades=int(lens_blades),
        filter=int(filter),
        filter_width=float(filter_width),
        cam_type=int(cam_type),
    )


def build_filter_table(filter: int, width: float, size: int = 1024) -> np.ndarray:
    """Importance table for pixel-filter sampling: the filter's CDF inverted
    onto ``size`` uniformly spaced quantiles, as offsets in pixel units
    (internal/Core.h:339-349 in the reference renderer)."""
    if filter == PixelFilter.BOX:
        return np.linspace(0.0, 1.0, size, dtype=np.float32)

    n = 1024
    x = (np.arange(n, dtype=np.float64) + 0.5) / n * width - 0.5 * width
    if filter == PixelFilter.GAUSSIAN:
        v = x * 6.0 / width
        y = np.exp(-2.0 * v * v)
    elif filter == PixelFilter.BLACKMAN_HARRIS:
        v = 2.0 * np.pi * (x / width + 0.5)
        y = (
            0.35875
            - 0.48829 * np.cos(v)
            + 0.14128 * np.cos(2.0 * v)
            - 0.01168 * np.cos(3.0 * v)
        )
    else:
        raise ValueError(f"unknown filter {filter}")
    y = np.maximum(y, 0.0)
    cdf = np.concatenate([[0.0], np.cumsum(y)])
    cdf /= cdf[-1]
    q = np.linspace(0.0, 1.0, size)
    idx = np.searchsorted(cdf, q, side="right") - 1
    idx = np.clip(idx, 0, n - 1)
    denom = np.maximum(cdf[idx + 1] - cdf[idx], 1e-12)
    frac = (q - cdf[idx]) / denom
    xs = (idx + frac) / n * width - 0.5 * width
    # offsets centered: add 0.5 so the mean lands mid-pixel like Box
    return (xs + 0.5).astype(np.float32)
