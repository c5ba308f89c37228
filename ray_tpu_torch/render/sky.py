"""Differentiable physical sky / atmosphere.

The port of ``ray_tpu.render.sky``, function for function: a
Hillaire-2020-style model — Rayleigh + Mie + ozone atmosphere, a
numerically integrated transmittance LUT, an isotropic multiple-scattering
LUT and a single-scattering ray march for the sky radiance — plus the
procedural extras (volumetric cumulus clouds, cirrus, a moon disc and
stars) and the latlong bake that ``Scene.set_physical_sky`` turns into an
environment map.  Every function is PyTorch ops on the device of its
inputs, so the sky is differentiable w.r.t. every float parameter of
:class:`AtmosphereParams` that is passed in as a tensor with
``requires_grad``.

``ray_tpu``'s ``jax.vmap`` over the multiscatter LUT's 64 directions is a
leading batch dimension here, and its ``lax.fori_loop`` cloud march a
Python loop.  The noise hash is uint32 arithmetic in ``ray_tpu``; PyTorch's
``uint32`` has no shifts or multiplies on the CPU, so the words live in
int64 tensors kept in [0, 2^32) (``ray_tpu_torch.ops.rng``'s helpers), and
a negative lattice coordinate wraps exactly as ``astype(uint32)`` does.

The planet is 6,371 km in float32 as in ``ray_tpu``: near the horizon
``r*r - Rg*Rg`` cancels to a few thousand ulps of ``r*r``, so there the
last bits depend on how a backend rounds or contracts the products.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.ops.rng import _mul32, _u32
from ray_tpu_torch.ops.rng import hash_u32 as _hash_u32
from ray_tpu_torch.utils.device import resolve_device

# LUT sizes (reference internal/Constants.inl:150-152)
TRANSMITTANCE_LUT_W = 256
TRANSMITTANCE_LUT_H = 64
MULTISCATTER_LUT_RES = 32


@dataclasses.dataclass(frozen=True)
class AtmosphereParams:
    """Atmosphere parameters (defaults: Earth, reference SceneBase.h:314).
    A field may be a Python float, a tuple or a tensor; a tensor with
    ``requires_grad`` carries its gradient through the bake."""

    planet_radius: Any = 6371000.0
    viewpoint_height: Any = 700.0
    atmosphere_height: Any = 100000.0
    rayleigh_height: Any = 8000.0
    mie_height: Any = 1200.0
    ozone_height_center: Any = 25000.0
    ozone_half_width: Any = 15000.0
    atmosphere_density: Any = 1.0
    rayleigh_scattering: Any = (5.802e-6, 13.558e-6, 33.1e-6)
    mie_scattering: Any = (3.996e-6, 3.996e-6, 3.996e-6)
    mie_extinction: Any = (4.44e-6, 4.44e-6, 4.44e-6)
    ozone_absorption: Any = (0.65e-6, 1.881e-6, 0.085e-6)
    ground_albedo: Any = (0.05, 0.05, 0.05)
    # celestial bodies and cloud layers (SceneBase.h:320-336), procedural
    clouds_height_beg: Any = 2000.0
    clouds_height_end: Any = 2500.0
    clouds_variety: Any = 0.5
    clouds_density: Any = 0.5
    clouds_offset_x: Any = 0.0
    clouds_offset_z: Any = 0.0
    cirrus_clouds_amount: Any = 0.5
    cirrus_clouds_height: Any = 6000.0
    stars_brightness: Any = 1.0
    moon_radius: Any = 1737400.0
    moon_distance: Any = 100000000.0
    moon_dir: Any = (0.707, 0.707, 0.0)

    def torch_params(self, *, device=None) -> "AtmosphereParams":
        """Every field as a float32 tensor on ``device`` (``ray_tpu``'s
        ``jnp_params``).  A tensor field keeps its autograd graph."""
        def conv(x):
            if isinstance(x, torch.Tensor):
                return x.to(device=device, dtype=torch.float32)
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return dataclasses.replace(self, **{
            f.name: conv(getattr(self, f.name))
            for f in dataclasses.fields(self)})


SUN_ILLUMINANCE = 1.0  # radiance scale; callers multiply by sun color/power
_PI = np.pi


def _densities(p: AtmosphereParams, h):
    """(rayleigh, mie, ozone) relative densities at altitude h (meters)."""
    h = torch.clamp_min(h, 0.0)
    d_r = torch.exp(-h / p.rayleigh_height)
    d_m = torch.exp(-h / p.mie_height)
    d_o = torch.clamp_min(
        1.0 - torch.abs(h - p.ozone_height_center) / p.ozone_half_width, 0.0)
    return (d_r * p.atmosphere_density, d_m * p.atmosphere_density,
            d_o * p.atmosphere_density)


def _extinction(p: AtmosphereParams, h):
    d_r, d_m, d_o = _densities(p, h)
    return (d_r[..., None] * p.rayleigh_scattering
            + d_m[..., None] * p.mie_extinction
            + d_o[..., None] * p.ozone_absorption)


def _sqrt(x):
    """float32 ``sqrt`` rounded correctly, as XLA's and CUDA's are.
    PyTorch's vectorised CPU ``sqrt`` is an ulp off on ~1% of inputs, and
    at planet scale (r ≈ 6.37e6 m, an ulp 0.5 m) an ulp of a height moves
    the Mie density exp(-h / 1200 m) by 4e-4; the float64 root rounds to
    the correct float32 one (53 ≥ 2·24 + 2 bits)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def _ray_sphere_far(r, mu, radius):
    """Distance to the sphere of ``radius`` from height r along cos-angle
    mu (far intersection; NaN-safe)."""
    disc = r * r * (mu * mu - 1.0) + radius * radius
    return torch.clamp_min(-r * mu + _sqrt(torch.clamp_min(disc, 0.0)),
                           0.0)


def _ray_sphere_near(r, mu, radius):
    disc = r * r * (mu * mu - 1.0) + radius * radius
    ok = disc >= 0.0
    t = -r * mu - _sqrt(torch.clamp_min(disc, 0.0))
    return torch.where(ok & (t > 0.0), t, math.inf)


def transmittance_integral(p: AtmosphereParams, r, mu, steps: int = 40):
    """Optical-depth integral from (r, mu) to the top of the atmosphere."""
    r_top = p.planet_radius + p.atmosphere_height
    t_max = _ray_sphere_far(r, mu, r_top)
    dt = t_max / steps
    step_idx = (torch.arange(steps, dtype=torch.float32, device=dt.device)
                + 0.5).reshape((steps,) + (1,) * dt.dim())
    ts = step_idx * dt[None, ...]
    # height along the ray: |o + t·d| with o = (0, r), d at angle mu
    r1 = r[None, ...]
    h = _sqrt(torch.clamp_min(
        r1 * r1 + ts * ts + 2.0 * r1 * ts * mu[None, ...], 1.0)
    ) - p.planet_radius
    ext = _extinction(p, h)  # (steps, ..., 3)
    tau = torch.sum(ext * dt[None, ..., None], dim=0)
    return torch.exp(-tau)


def build_transmittance_lut(p: AtmosphereParams):
    """(H, W, 3) transmittance LUT over the Bruneton (rho, d) mapping."""
    dev = p.planet_radius.device
    Rg = p.planet_radius
    Rt = p.planet_radius + p.atmosphere_height
    H = _sqrt(torch.clamp_min(Rt * Rt - Rg * Rg, 0.0))
    u = (torch.arange(TRANSMITTANCE_LUT_W, dtype=torch.float32, device=dev)
         + 0.5) / TRANSMITTANCE_LUT_W
    v = (torch.arange(TRANSMITTANCE_LUT_H, dtype=torch.float32, device=dev)
         + 0.5) / TRANSMITTANCE_LUT_H
    uu, vv = torch.meshgrid(u, v, indexing="xy")  # (H, W)
    rho = vv * H
    r = _sqrt(rho * rho + Rg * Rg)
    d_min = Rt - r
    d_max = rho + H
    d = d_min + uu * (d_max - d_min)
    mu = torch.where(
        d > 0.0,
        torch.clamp((H * H - rho * rho - d * d) / (2.0 * r * d + 1e-9),
                    -1.0, 1.0),
        1.0,
    )
    return transmittance_integral(p, r, mu)


def _bilinear(lut, x, y, w, h):
    """``lut`` (h, w, 3) at continuous texel coordinates (x, y), the taps
    clamped to the table as ``ray_tpu`` clamps them."""
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    return (
        lut[y0, x0] * (1 - fx) * (1 - fy)
        + lut[y0, x0 + 1] * fx * (1 - fy)
        + lut[y0 + 1, x0] * (1 - fx) * fy
        + lut[y0 + 1, x0 + 1] * fx * fy
    )


def lookup_transmittance(p: AtmosphereParams, lut, r, mu):
    """Bilinear LUT fetch with the same mapping as the bake."""
    Rg = p.planet_radius
    Rt = p.planet_radius + p.atmosphere_height
    H = _sqrt(torch.clamp_min(Rt * Rt - Rg * Rg, 0.0))
    rho = _sqrt(torch.clamp_min(r * r - Rg * Rg, 0.0))
    d = _ray_sphere_far(r, mu, Rt)
    d_min = Rt - r
    d_max = rho + H
    u = torch.clamp((d - d_min) / torch.clamp_min(d_max - d_min, 1e-9),
                    0.0, 1.0)
    v = torch.clamp(rho / torch.clamp_min(H, 1e-9), 0.0, 1.0)
    return _bilinear(lut, u * (TRANSMITTANCE_LUT_W - 1),
                     v * (TRANSMITTANCE_LUT_H - 1),
                     TRANSMITTANCE_LUT_W, TRANSMITTANCE_LUT_H)


def _phase_rayleigh(c):
    return 3.0 / (16.0 * _PI) * (1.0 + c * c)


def _phase_mie(c, g=0.8):
    gg = g * g
    denom = torch.clamp_min(1.0 + gg - 2.0 * g * c, 1e-6)
    return (3.0 / (8.0 * _PI)) * (1.0 - gg) * (1.0 + c * c) / (
        (2.0 + gg) * denom * _sqrt(denom)
    )


def _fibonacci_dirs(n: int) -> np.ndarray:
    """``n`` Fibonacci-sphere directions (n, 3) float32."""
    i = np.arange(n)
    golden = (1.0 + 5.0**0.5) / 2.0
    phi = 2.0 * np.pi * (i / golden % 1.0)
    cos_t = 1.0 - 2.0 * (i + 0.5) / n
    sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
    return np.stack([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)],
                    -1).astype(np.float32)


def build_multiscatter_lut(p: AtmosphereParams, trans_lut,
                           dir_samples: int = 64):
    """Hillaire's isotropic multiple-scattering LUT Ψ_ms over
    (sun_cos, altitude) — (RES, RES, 3).  ``ray_tpu`` maps the march over
    the directions with ``jax.vmap``; here they are a leading dimension."""
    dev = trans_lut.device
    Rg = p.planet_radius
    u = (torch.arange(MULTISCATTER_LUT_RES, dtype=torch.float32, device=dev)
         + 0.5) / MULTISCATTER_LUT_RES
    sun_cos = u * 2.0 - 1.0                         # (RES,)
    alt = u * p.atmosphere_height                   # (RES,)
    mu_s, r = torch.meshgrid(sun_cos, Rg + alt, indexing="xy")  # (RES, RES)

    dirs = torch.from_numpy(_fibonacci_dirs(dir_samples)).to(dev)  # (D, 3)
    sun_dir_y = mu_s  # sun in the (x=0) plane: dir = (sqrt(1-mu²), mu, 0)
    sun_dir_x = _sqrt(torch.clamp_min(1.0 - mu_s * mu_s, 0.0))

    shape = (dir_samples,) + tuple(r.shape)
    d0 = dirs[:, 0, None, None]
    d1 = dirs[:, 1, None, None]
    mu_v = d1.expand(shape)
    cos_sun = d0 * sun_dir_x + d1 * sun_dir_y
    Ls, fmss = _march_single(p, trans_lut, r.expand(shape), mu_v, cos_sun,
                             sun_mu0=mu_s, steps=20, with_fms=True)
    L2 = torch.mean(Ls, dim=0)
    f_ms = torch.mean(fmss, dim=0)
    return L2 / torch.clamp_min(1.0 - f_ms, 1e-3)


def _march_single(p, trans_lut, r, mu_v, cos_sun, sun_mu0, steps,
                  with_fms=False, psi_lookup=None):
    """Shared single-scattering march used by the MS-LUT bake and the sky
    radiance evaluation.

    ``mu_v``: view cos vs local up at the start; ``cos_sun``: cos between
    view and sun directions; ``sun_mu0``: sun cos vs up at the start.  The
    per-sample sun elevation is exact:
    mu_sun(t) = (r·sun_mu0 + t·cos_sun) / r(t).
    """
    Rg = p.planet_radius
    Rt = p.planet_radius + p.atmosphere_height
    t_ground = _ray_sphere_near(r, mu_v, Rg)
    t_top = _ray_sphere_far(r, mu_v, Rt)
    t_max = torch.minimum(
        torch.where(torch.isfinite(t_ground), t_ground, t_top), t_top)
    dt = t_max / steps

    sig_r = p.rayleigh_scattering
    sig_m = p.mie_scattering

    p_r = _phase_rayleigh(cos_sun)
    p_m = _phase_mie(cos_sun)

    zeros = torch.zeros(tuple(r.shape) + (3,), dtype=torch.float32,
                        device=r.device)
    L = zeros
    f_ms = zeros
    T_acc = torch.ones_like(zeros)

    for k in range(steps):
        t = (k + 0.5) * dt
        r_at = _sqrt(
            torch.clamp_min(r * r + t * t + 2.0 * r * t * mu_v, 1.0))
        h = r_at - Rg
        mu_sun_at = torch.clamp((r * sun_mu0 + t * cos_sun) / r_at, -1.0, 1.0)
        d_r, d_m, d_o = _densities(p, h)
        scat = d_r[..., None] * sig_r + d_m[..., None] * sig_m
        ext = _extinction(p, h)
        T_sun = lookup_transmittance(p, trans_lut, r_at, mu_sun_at)
        # shadowed by the planet below the local horizon
        horizon = -_sqrt(torch.clamp_min(r_at * r_at - Rg * Rg, 0.0)) / r_at
        T_sun = torch.where((mu_sun_at > horizon)[..., None], T_sun, 0.0)

        step_T = torch.exp(-ext * dt[..., None])
        # analytic in-step integration (Hillaire): S·(1-e^{-ext·dt})/ext
        s_int = (1.0 - step_T) / torch.clamp_min(ext, 1e-12)
        phase_scat = (
            d_r[..., None] * sig_r * p_r[..., None]
            + d_m[..., None] * sig_m * p_m[..., None]
        )
        L = L + T_acc * T_sun * phase_scat * s_int
        if psi_lookup is not None:
            psi = psi_lookup(r_at, mu_sun_at)
            L = L + T_acc * psi * scat * s_int
        if with_fms:
            f_ms = f_ms + T_acc * scat * s_int
        T_acc = T_acc * step_T

    # ground bounce (single lambertian event)
    hit_ground = torch.isfinite(t_ground) & (t_ground <= t_top)
    mu_sun_g = torch.clamp(
        (r * sun_mu0 + t_max * cos_sun) / torch.clamp_min(Rg, 1.0), -1.0, 1.0)
    T_sun_g = lookup_transmittance(p, trans_lut, Rg.expand(r.shape), mu_sun_g)
    ground = (T_acc * T_sun_g * torch.clamp_min(mu_sun_g, 0.0)[..., None]
              * p.ground_albedo / _PI)
    L = L + torch.where(hit_ground[..., None], ground, 0.0)
    return L, f_ms


def lookup_multiscatter(p: AtmosphereParams, ms_lut, r, mu_sun):
    u = torch.clamp((mu_sun + 1.0) * 0.5, 0.0, 1.0)
    v = torch.clamp((r - p.planet_radius) / p.atmosphere_height, 0.0, 1.0)
    return _bilinear(ms_lut, u * (MULTISCATTER_LUT_RES - 1),
                     v * (MULTISCATTER_LUT_RES - 1),
                     MULTISCATTER_LUT_RES, MULTISCATTER_LUT_RES)


def sky_radiance(p: AtmosphereParams, trans_lut, ms_lut, view_dir, sun_dir,
                 sun_color, steps: int = 24, sun_angular_radius: float = 0.00465,
                 include_sun_disk: bool = True):
    """Sky radiance along world-space ``view_dir`` (..., 3) for a viewer at
    ``viewpoint_height`` — single scattering + multiscatter + sun disk
    (the reference's ``IntegrateScattering``, AtmosphereRef.h:17)."""
    r0 = p.planet_radius + p.viewpoint_height
    mu_v = view_dir[..., 1]
    r = r0.expand(mu_v.shape)

    sun_mu0 = sun_dir[1]
    cos_sun = torch.clamp(
        _dot3(view_dir, sun_dir),
        -1.0, 1.0,
    )
    L, _ = _march_single(
        p, trans_lut, r, mu_v, cos_sun, sun_mu0=sun_mu0, steps=steps,
        psi_lookup=lambda r_at, mu_s2: lookup_multiscatter(p, ms_lut, r_at,
                                                           mu_s2),
    )
    L = L * sun_color

    if not include_sun_disk:
        return L
    # the sun disk through the transmittance (a bake with a separate
    # directional sun leaves it out)
    in_disk = cos_sun > np.cos(sun_angular_radius)
    T_view = lookup_transmittance(p, trans_lut, r, torch.clamp(mu_v, -1.0, 1.0))
    hits_ground = torch.isfinite(_ray_sphere_near(r, mu_v, p.planet_radius))
    disk_rad = sun_color / (_PI * sun_angular_radius**2)
    L = L + torch.where(
        (in_disk & (~hits_ground))[..., None], T_view * disk_rad, 0.0)
    return L


# ---------------------------------------------------------------------------
# Celestial bodies and clouds: procedural hash-lattice fbm noise instead of
# the reference's precomputed 3-D noise textures.
# ---------------------------------------------------------------------------


def _lattice(ix, iy, iz, seed):
    """Hash lattice point (int32 coordinates) → float in [0, 1)."""
    h = _hash_u32(
        _mul32(_u32(ix), 0x9E3779B1)
        ^ _mul32(_u32(iy), 0x85EBCA77)
        ^ _mul32(_u32(iz), 0xC2B2AE3D)
        ^ _u32(seed)
    )
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _smooth(t):
    return t * t * (3.0 - 2.0 * t)


def value_noise3(pos, seed=0):
    """Trilinear value noise on an integer lattice, pos (..., 3) → [0, 1)."""
    pf = torch.floor(pos)
    ix = pf[..., 0].to(torch.int32)
    iy = pf[..., 1].to(torch.int32)
    iz = pf[..., 2].to(torch.int32)
    f = _smooth(pos - pf)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    def lerp(a, b, t):
        return a + (b - a) * t

    n000 = _lattice(ix, iy, iz, seed)
    n100 = _lattice(ix + 1, iy, iz, seed)
    n010 = _lattice(ix, iy + 1, iz, seed)
    n110 = _lattice(ix + 1, iy + 1, iz, seed)
    n001 = _lattice(ix, iy, iz + 1, seed)
    n101 = _lattice(ix + 1, iy, iz + 1, seed)
    n011 = _lattice(ix, iy + 1, iz + 1, seed)
    n111 = _lattice(ix + 1, iy + 1, iz + 1, seed)
    return lerp(
        lerp(lerp(n000, n100, fx), lerp(n010, n110, fx), fy),
        lerp(lerp(n001, n101, fx), lerp(n011, n111, fx), fy),
        fz,
    )


def fbm3(pos, octaves=4, seed=0, gain=0.5, lacunarity=2.0):
    total = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=pos.device)
    amp = 1.0
    norm = 0.0
    q = pos
    for o in range(octaves):
        total = total + amp * value_noise3(q, seed + o * 131)
        norm += amp
        amp *= gain
        q = q * lacunarity
    return total / norm


def _dot3(a, b):
    """Sum over the last axis of 3, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm3(v):
    return _sqrt(_dot3(v, v))


def moon_radiance(p: AtmosphereParams, view_dir, sun_dir):
    """Lambert-shaded moon disk with procedural crater albedo (the
    reference's AtmosphereRef.cpp moon branch).  Returns (..., 3) radiance
    and the disk mask."""
    moon_dir = p.moon_dir[:3]
    moon_dir = moon_dir / torch.clamp_min(_norm3(moon_dir), 1e-9)
    cos_m = torch.clamp(_dot3(view_dir, moon_dir), -1.0, 1.0)
    ang_r = torch.atan2(p.moon_radius, p.moon_distance)
    cos_r = torch.cos(ang_r)
    in_disk = cos_m > cos_r
    # local frame around moon_dir
    dev = view_dir.device
    a = torch.where(torch.abs(moon_dir[1]) < 0.99,
                    torch.tensor([0.0, 1.0, 0.0], device=dev),
                    torch.tensor([1.0, 0.0, 0.0], device=dev))
    t1 = torch.linalg.cross(moon_dir, a)
    t1 = t1 / torch.clamp_min(_norm3(t1), 1e-9)
    t2 = torch.linalg.cross(moon_dir, t1)
    du = _dot3(view_dir, t1)
    dv = _dot3(view_dir, t2)
    sin_r = torch.clamp_min(torch.sin(ang_r), 1e-9)
    # normalized disk coordinates in [-1, 1]
    x = du / sin_r
    y = dv / sin_r
    z2 = torch.clamp_min(1.0 - x * x - y * y, 0.0)
    z = _sqrt(z2)
    # moon surface normal in world space (sphere facing the viewer)
    n = x[..., None] * t1 + y[..., None] * t2 - z[..., None] * moon_dir
    phase = torch.clamp_min(_dot3(n, sun_dir), 0.0)
    crater = 0.6 + 0.4 * fbm3(torch.stack([x, y, z], dim=-1) * 6.0,
                              octaves=4, seed=17)
    albedo = 0.12 * crater
    rad = (albedo * phase)[..., None] * torch.ones(3, device=dev)
    return torch.where(in_disk[..., None], rad, 0.0), in_disk


def stars_radiance(p: AtmosphereParams, view_dir):
    """Procedural star field: one candidate star per lat-long grid cell
    (hash position/intensity), brightness from ``stars_brightness``
    (SceneBase.h:333)."""
    N_U, N_V = 512, 256
    theta = torch.arccos(torch.clamp(view_dir[..., 1], -1.0, 1.0))
    phi = torch.atan2(view_dir[..., 2], view_dir[..., 0])
    u = (phi / (2.0 * _PI) + 0.5) * N_U
    v = (theta / _PI) * N_V
    iu = torch.floor(u).to(torch.int32)
    iv = torch.floor(v).to(torch.int32)
    zero = torch.zeros_like(iu)
    sx = _lattice(iu, iv, zero, 101)
    sy = _lattice(iu, iv, zero, 211)
    mag = _lattice(iu, iv, zero, 307)
    # the star's position within the cell; a tight gaussian falloff
    ex = u - iu.to(torch.float32) - sx
    ey = v - iv.to(torch.float32) - sy
    d2 = ex * ex + ey * ey
    core = torch.exp(-d2 * 60.0)
    # few cells hold a visible star; power-law magnitudes (x⁴ as (x²)²,
    # as jax's integer_pow computes it)
    lit = mag > 0.92
    i1 = torch.where(lit, (mag - 0.92) / 0.08, 0.0)
    i2 = i1 * i1
    intensity = i2 * i2
    rad = (p.stars_brightness * 0.05 * intensity * core)[..., None]
    return rad * torch.ones(3, device=view_dir.device)


def cirrus_coverage(p: AtmosphereParams, view_dir, r):
    """Coverage of the thin high-altitude cirrus layer along the view ray
    (cirrus_clouds_amount/height, SceneBase.h:328-329)."""
    mu = view_dir[..., 1]
    r_top = p.planet_radius + p.cirrus_clouds_height
    t = _ray_sphere_far(r, mu, r_top)
    hits = torch.isfinite(t) & (mu > 0.02)
    pos = view_dir * torch.where(hits, t, 0.0)[..., None]
    uv = torch.stack(
        [pos[..., 0] + p.clouds_offset_x, torch.zeros_like(mu),
         pos[..., 2] + p.clouds_offset_z], dim=-1
    ) * (1.0 / 8000.0)
    n = fbm3(uv, octaves=5, seed=53)
    cov = torch.clamp((n - (1.0 - p.cirrus_clouds_amount * 0.7)) * 3.0,
                      0.0, 1.0)
    # fade toward the horizon
    cov = cov * torch.clamp((mu - 0.02) * 8.0, 0.0, 1.0)
    return torch.where(hits, cov * 0.4, 0.0)


def _hg_phase(c, g):
    g2 = g * g
    return (1.0 - g2) / (4.0 * _PI * torch.pow(1.0 + g2 - 2.0 * g * c, 1.5))


def clouds_march(p: AtmosphereParams, trans_lut, view_dir, sun_dir, sun_color,
                 steps: int = 16, light_steps: int = 3):
    """Volumetric cumulus layer between clouds_height_beg/end
    (SceneBase.h:320-327): fbm density, Beer extinction, a short sun-ward
    light march, HG phase.  Returns (in-scattered radiance,
    transmittance).  ``ray_tpu``'s ``lax.fori_loop`` over the steps is a
    Python loop."""
    mu = view_dir[..., 1]
    r0 = p.planet_radius + p.viewpoint_height
    r = r0.expand(mu.shape)
    t_beg = _ray_sphere_far(r, mu, p.planet_radius + p.clouds_height_beg)
    t_end = _ray_sphere_far(r, mu, p.planet_radius + p.clouds_height_end)
    valid = torch.isfinite(t_beg) & torch.isfinite(t_end) & (mu > 0.02)
    t_beg = torch.where(valid, t_beg, 0.0)
    t_end = torch.where(valid, torch.minimum(t_end, t_beg + 30000.0), 0.0)
    seg = (t_end - t_beg) / steps

    thick = torch.clamp_min(p.clouds_height_end - p.clouds_height_beg, 1.0)
    freq = 1.0 / 1600.0
    offset = torch.stack([p.clouds_offset_x, torch.zeros_like(p.clouds_offset_x),
                          p.clouds_offset_z])

    def density(pos):
        # height above ground, flat-shell approximation
        h01 = torch.clamp(
            (p.viewpoint_height + pos[..., 1] - p.clouds_height_beg) / thick,
            0.0, 1.0)
        base = fbm3((pos + offset) * freq, octaves=4, seed=7)
        detail = fbm3((pos + offset) * (freq * 3.7), octaves=3, seed=91)
        cover = p.clouds_density * 0.8
        d = torch.clamp(
            (base - (1.0 - cover) - p.clouds_variety * 0.25 * detail) * 4.0,
            0.0, 1.0)
        # round tops/bottoms
        return d * _smooth(torch.clamp(h01 * 4.0, 0.0, 1.0)) * _smooth(
            torch.clamp((1.0 - h01) * 2.5, 0.0, 1.0))

    sigma_t = 0.006  # extinction per meter at density 1
    cos_sun = torch.clamp(_dot3(view_dir, sun_dir), -1.0, 1.0)
    phase = 0.7 * _hg_phase(cos_sun, 0.55) + 0.3 * _hg_phase(cos_sun, -0.15)
    sun_T_top = lookup_transmittance(
        p, trans_lut, r, torch.clamp(sun_dir[1], -1.0, 1.0).expand(mu.shape))
    amb = 0.1 + 0.2 * torch.clamp(sun_dir[1], 0.0, 1.0)

    L = torch.zeros(tuple(view_dir.shape[:-1]) + (3,), dtype=torch.float32,
                    device=view_dir.device)
    T = torch.ones(mu.shape, dtype=torch.float32, device=view_dir.device)
    for i in range(steps):
        t = t_beg + (i + 0.5) * seg
        pos = view_dir * t[..., None]
        d = torch.where(valid, density(pos), 0.0)
        ext = torch.exp(-d * sigma_t * seg)
        # short light march toward the sun
        lt = torch.ones_like(T)
        for j in range(light_steps):
            lpos = pos + sun_dir * ((j + 0.5) * thick / light_steps)
            lt = lt * torch.exp(
                -density(lpos) * sigma_t * (thick / light_steps))
        S = (phase * lt)[..., None] * sun_T_top * sun_color + amb
        L = L + T[..., None] * (1.0 - ext)[..., None] * S
        T = T * ext
    return L, torch.where(valid, T, 1.0)


def sky_radiance_full(p: AtmosphereParams, trans_lut, ms_lut, view_dir,
                      sun_dir, sun_color, steps: int = 24,
                      include_sun_disk: bool = True, moon: bool = True,
                      stars: bool = True, cirrus: bool = True,
                      clouds: bool = True, cloud_steps: int = 16):
    """Full sky: atmosphere + sun disk + moon + stars + cirrus + volumetric
    clouds, composited far-to-near (the reference's detailed-sky path,
    AtmosphereRef.cpp IntegrateScattering with clouds/moon/stars)."""
    r0 = p.planet_radius + p.viewpoint_height
    mu_v = view_dir[..., 1]
    r = r0.expand(mu_v.shape)
    hits_ground = torch.isfinite(_ray_sphere_near(r, mu_v, p.planet_radius))
    T_view = lookup_transmittance(p, trans_lut, r, torch.clamp(mu_v, -1.0, 1.0))

    # far field behind the atmosphere
    far = torch.zeros(tuple(view_dir.shape[:-1]) + (3,), dtype=torch.float32,
                      device=view_dir.device)
    if include_sun_disk:
        sun_ar = 0.00465
        cos_sun = torch.clamp(_dot3(view_dir, sun_dir), -1.0, 1.0)
        in_disk = cos_sun > np.cos(sun_ar)
        far = far + torch.where(in_disk[..., None],
                                sun_color / (_PI * sun_ar**2), 0.0)
    if moon:
        m_rad, _ = moon_radiance(p, view_dir, sun_dir)
        far = far + m_rad
    if stars:
        far = far + stars_radiance(p, view_dir)

    if cirrus:
        cov = cirrus_coverage(p, view_dir, r)
        sun_T = lookup_transmittance(
            p, trans_lut, r,
            torch.clamp(sun_dir[1], -1.0, 1.0).expand(mu_v.shape))
        cirrus_col = sun_T * sun_color * (0.25 / _PI) + 0.05
        far = far * (1.0 - cov[..., None]) + cov[..., None] * cirrus_col

    # atmosphere in-scattering
    L_in = sky_radiance(p, trans_lut, ms_lut, view_dir, sun_dir, sun_color,
                        steps=steps, include_sun_disk=False)
    L = L_in + torch.where(hits_ground[..., None], 0.0, T_view * far)

    if clouds:
        Lc, Tc = clouds_march(p, trans_lut, view_dir, sun_dir, sun_color,
                              steps=cloud_steps)
        L = Lc + Tc[..., None] * L
    return L


def _as_f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def bake_sky_env(p: AtmosphereParams, sun_dir, sun_color, width=256, height=128,
                 steps: int = 24, include_sun_disk: bool = True,
                 full: bool = False, **features):
    """Bake the sky to a latlong environment image (H, W, 3) — the analogue
    of ``CalcSkyEnvTexture`` (SceneCommon.h:25).  ``full=True`` adds moon,
    stars, cirrus and volumetric clouds (the other keywords go to
    :func:`sky_radiance_full`).  Runs on ``features["device"]`` if given,
    else on the device of ``sun_dir`` or ``sun_color`` if a tensor, else on
    CUDA; the parameters move there."""
    device = features.pop("device", None)
    if device is None:
        device = next((v.device for v in (sun_dir, sun_color)
                       if isinstance(v, torch.Tensor)), None)
    device = resolve_device(device)
    p = p.torch_params(device=device)
    sun_dir = _as_f32(sun_dir, device)
    sun_dir = sun_dir / _norm3(sun_dir)
    sun_color = _as_f32(sun_color, device)
    trans_lut = build_transmittance_lut(p)
    ms_lut = build_multiscatter_lut(p, trans_lut)

    v = (torch.arange(height, dtype=torch.float32, device=device)
         + 0.5) / height
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    theta = vv * _PI
    phi = uu * 2.0 * _PI
    # sin and cos rounded correctly from float64 (PyTorch's float32 ones
    # are an ulp off on ~5% of inputs on the CPU, XLA's on ~1%): an ulp of
    # a direction below the horizon moves its texel by ~1e-4
    sin_t, cos_t = (f(theta.double()).float() for f in (torch.sin, torch.cos))
    sin_p, cos_p = (f(phi.double()).float() for f in (torch.sin, torch.cos))
    d = torch.stack([sin_t * cos_p, cos_t, sin_t * sin_p], dim=-1)
    if full:
        return sky_radiance_full(
            p, trans_lut, ms_lut, d, sun_dir, sun_color, steps=steps,
            include_sun_disk=include_sun_disk, **features)
    return sky_radiance(p, trans_lut, ms_lut, d, sun_dir, sun_color,
                        steps=steps, include_sun_disk=include_sun_disk)
