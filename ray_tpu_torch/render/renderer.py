"""Progressive renderer driver.

The port of ``ray_tpu.render.renderer`` (reference ``RendererBase`` /
``Cpu::Renderer``, RendererBase.h:133-253, RendererCPU.h:193): it owns the
accumulation buffers, advances one sample ("iteration") a
:meth:`Renderer.render_sample` call over the whole frame as one tile,
keeps the incremental average in dual full / half buffers for
variance-driven adaptive sampling (RendererCPU.h:607-658) and resolves
tonemapped pixels.  Progressive state is {buffers, iteration}; ``clear()``
restarts it.

Buffers live on the renderer's device (CUDA unless the caller names
another) and the images come back as tensors there.  Sampling runs under
``torch.no_grad()``: like ``ray_tpu``'s, this driver renders and does not
differentiate (``render_tile`` does).  With ``use_spatial_cache`` each
sample of :meth:`Renderer.render` runs the cache loop of ``ray_tpu``
(update pass at 1/``cache_downsample`` resolution → resolve → query
render, :mod:`.radcache`); :meth:`Renderer.denoise_image` runs the NLM
(:mod:`ray_tpu_torch.models.nlm`) or UNet (:mod:`ray_tpu_torch.models.unet`)
denoiser on the renderer's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.render import radcache
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.render.tonemap import (
    ViewTransform,
    apply_view_transform,
    reversible_tonemap,
    reversible_tonemap_invert,
)
from ray_tpu_torch.scene.camera import Camera, PixelFilter, build_filter_table
from ray_tpu_torch.utils import trace
from ray_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Analogue of ``settings_t`` (RendererBase.h:52) plus the adaptive-
    sampling knobs the reference keeps on the camera (SceneBase.h:301-306
    ``min_samples`` / ``variance_threshold``)."""

    width: int = 256
    height: int = 256
    min_samples: int = 16
    variance_threshold: float = 0.0   # 0 = adaptive sampling off
    use_spatial_cache: bool = False   # settings_t.use_spatial_cache
    cache_entries: int = 1 << 20
    # update-pass resolution divisor (RAD_CACHE_DOWNSAMPLING_FACTOR = 4 in
    # the reference; tiny renders need 1)
    cache_downsample: int = 4
    # per-sample wall-clock stats (stats_t, RendererBase.h:230-242); each
    # timed sample synchronises the device
    collect_stats: bool = False


@dataclasses.dataclass
class RegionContext:
    """Tile + progressive iteration state (RendererBase.h:78)."""

    x: int = 0
    y: int = 0
    w: int = 0
    h: int = 0
    iteration: int = 0


def _accumulate(full_buf, half_buf, counts, sample, mask):
    """Per-pixel incremental average (pixels advance only while their mask
    is on); odd samples also feed the half buffer (RendererCPU.h:607-627)
    for the dual-buffer variance estimate."""
    new_counts = counts + mask.to(torch.int32)
    it_f = torch.clamp_min(new_counts, 1).to(torch.float32)
    new_full = torch.where(mask[:, None],
                           full_buf + (sample - full_buf) / it_f[:, None],
                           full_buf)
    odd = (new_counts % 2) == 1
    half_it = torch.ceil(it_f * 0.5)
    new_half = torch.where((mask & odd)[:, None],
                           half_buf + (sample - half_buf) / half_it[:, None],
                           half_buf)
    return new_full, new_half, new_counts


def _variance_mask(full_buf, half_buf, threshold: float):
    """Per-pixel convergence test in reversible-tonemap space
    (RendererCPU.h:629-658): True where the pixel still needs samples."""
    d = torch.abs(reversible_tonemap(full_buf) - reversible_tonemap(half_buf))
    return d.amax(dim=-1) > threshold


class Renderer:
    """Progressive path-tracing renderer over a finalized ``SceneFlat``."""

    _STATE_KEYS = ("full_buf", "half_buf", "aux_base", "aux_dn",
                   "sample_counts", "active_px")

    def __init__(self, settings: RenderSettings,
                 pass_settings: PassSettings = PassSettings(), *,
                 device=None):
        self.settings = settings
        self.pass_settings = pass_settings
        # a tensor's device: CUDA carries its index, as a scene's does
        self.device = torch.empty(0, device=resolve_device(device)).device
        self.iteration = 0
        n = settings.height * settings.width

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.full_buf = zeros(n, 3)
        self.half_buf = zeros(n, 3)
        self.aux_base = zeros(n, 3)
        self.aux_dn = zeros(n, 4)
        self.sample_counts = zeros(n, dtype=torch.int32)
        self.active_px = torch.ones((n,), dtype=torch.bool, device=self.device)
        self.stats = {"time_render_us": 0.0, "time_cache_update_us": 0.0,
                      "time_cache_resolve_us": 0.0, "time_denoise_us": 0.0,
                      "rays_traced": 0, "samples": 0}
        self.cache = None            # spatial radiance cache state
        self.cache_iteration = 0     # RegionContext.cache_iteration
        self._unet = None

    def get_stats(self) -> dict:
        """RendererBase::GetStats (RendererBase.h:244)."""
        return dict(self.stats)

    def reset_stats(self):
        for k in self.stats:
            self.stats[k] = 0.0 if k.startswith("time") else 0

    def clear(self):
        self.iteration = 0
        self.full_buf = torch.zeros_like(self.full_buf)
        self.half_buf = torch.zeros_like(self.half_buf)
        self.sample_counts = torch.zeros_like(self.sample_counts)
        self.active_px = torch.ones_like(self.active_px)

    def _check_scene(self, scene):
        if scene.device != self.device:
            raise ValueError(f"the scene is on {scene.device}, the renderer "
                             f"on {self.device}")

    def _timed(self, key, t0):
        """Charge the time since ``t0`` to ``stats[key]`` (synchronising
        the device first)."""
        if self.settings.collect_stats:
            if self.device.type == "cuda":
                with trace.sync("stats"):
                    torch.cuda.synchronize(self.device)
            self.stats[key] += (time.perf_counter() - t0) * 1e6

    def update_spatial_cache(self, scene, cam: Camera, rand_seed: int = 0):
        """The cache-feeding pass (RendererCPU.h:1010-1163
        UpdateSpatialCache) at 1/``cache_downsample`` resolution: box
        filter, no depth of field, ``cache_mode="update"``.  Returns
        ``render_tile``'s output; the new state is ``self.cache``."""
        self._check_scene(scene)
        if self.cache is None:
            self.cache = radcache.make_cache(
                self.settings.cache_entries, np.asarray(cam.origin),
                device=self.device)
        self.cache_iteration += 1
        f = self.settings.cache_downsample
        w4 = max(self.settings.width // f, 1)
        h4 = max(self.settings.height // f, 1)
        cam_u = dataclasses.replace(cam, fstop=np.float32(0.0),
                                    filter=int(PixelFilter.BOX))
        t0 = time.perf_counter()
        with torch.no_grad():
            out = render_tile(
                scene, cam_u, build_filter_table(cam_u.filter,
                                                 cam_u.filter_width),
                0, 0, self.cache_iteration, rand_seed, width=w4, height=h4,
                tile_w=w4, tile_h=h4, settings=self.pass_settings,
                use_filter_table=False, cache=self.cache,
                cache_mode="update")
        self.cache = out["cache"]
        self._timed("time_cache_update_us", t0)
        return out

    def resolve_spatial_cache(self):
        """Merge this frame's samples into the resolved radiance and age
        the entries (RendererCPU.h:1165-1212)."""
        if self.cache is None:
            raise ValueError("no cache to resolve")
        t0 = time.perf_counter()
        self.cache = radcache.resolve(self.cache)
        self._timed("time_cache_resolve_us", t0)

    def render_sample(self, scene, cam: Camera, rand_seed: int = 0):
        """Advance one progressive sample over the full frame; returns
        ``render_tile``'s output for it.  With ``use_spatial_cache`` and a
        cache, the sample queries it."""
        self._check_scene(scene)
        self.iteration += 1
        adaptive = self.settings.variance_threshold > 0.0
        mask = self.active_px if adaptive else torch.ones_like(self.active_px)
        use_cache = self.settings.use_spatial_cache and self.cache is not None
        w, h = self.settings.width, self.settings.height
        t0 = time.perf_counter()
        with torch.no_grad():
            out = render_tile(
                scene, cam, build_filter_table(cam.filter, cam.filter_width),
                0, 0, self.iteration, rand_seed, width=w, height=h,
                tile_w=w, tile_h=h, settings=self.pass_settings,
                use_filter_table=cam.filter != PixelFilter.BOX,
                pixel_mask=mask, cache=self.cache if use_cache else None,
                cache_mode="query" if use_cache else "off")
            with trace.span("rt.accumulate"):
                self.full_buf, self.half_buf, self.sample_counts = \
                    _accumulate(self.full_buf, self.half_buf,
                                self.sample_counts, out["color"], mask)
                it = self.iteration
                self.aux_base = self.aux_base + (out["base_color"]
                                                 - self.aux_base) / it
                self.aux_dn = (self.aux_dn
                               + (out["depth_normal"] - self.aux_dn) / it)
                if adaptive and it >= self.settings.min_samples:
                    self.active_px = self.active_px & _variance_mask(
                        self.full_buf, self.half_buf,
                        self.settings.variance_threshold)
        self.stats["samples"] += 1
        if self.settings.collect_stats:
            with trace.sync("stats"):
                self.stats["rays_traced"] += int(out["rays_traced"])
            self.stats["time_render_us"] += (time.perf_counter() - t0) * 1e6
        return out

    def render(self, scene, cam: Camera, samples: int, rand_seed: int = 0):
        """``samples`` progressive samples; returns :meth:`radiance_image`.
        With ``use_spatial_cache`` each sample runs the reference test
        driver's loop: update → resolve → query render."""
        for _ in range(samples):
            if self.settings.use_spatial_cache:
                self.update_spatial_cache(scene, cam, rand_seed)
                self.resolve_spatial_cache()
            self.render_sample(scene, cam, rand_seed)
        return self.radiance_image()

    def radiance_image(self) -> torch.Tensor:
        h, w = self.settings.height, self.settings.width
        return self.full_buf.reshape(h, w, 3)

    def pixels(self, cam: Optional[Camera] = None,
               view_transform: int = ViewTransform.STANDARD) -> torch.Tensor:
        """Tonemapped float image in [0, 1] (the camera's exposure and
        gamma)."""
        exposure = float(cam.exposure) if cam is not None else 0.0
        gamma = float(cam.gamma) if cam is not None else 1.0
        img = apply_view_transform(self.full_buf, view_transform, exposure,
                                   gamma)
        return img.reshape(self.settings.height, self.settings.width, 3)

    def variance_image(self) -> torch.Tensor:
        """Half-buffer variance proxy (RendererCPU.h:629-658)."""
        v = torch.abs(self.full_buf - self.half_buf)
        return v.reshape(self.settings.height, self.settings.width, 3)

    def save_state(self, path: str):
        """Progressive render state (buffers + iteration, and the spatial
        cache) to ``.npz``, in ``ray_tpu``'s layout."""
        data = {k: getattr(self, k).cpu().numpy() for k in self._STATE_KEYS}
        data["iteration"] = np.int64(self.iteration)
        data["cache_iteration"] = np.int64(self.cache_iteration)
        if self.cache is not None:
            for f, v in self.cache.to_numpy().items():
                data[f"cache_{f}"] = v
        np.savez_compressed(path, **data)

    def load_state(self, path: str):
        """Resume from :meth:`save_state` output (the port's or
        ``ray_tpu``'s); shapes must match the settings."""
        with np.load(path) as d:
            cache = None
            if "cache_key_lo" in d:
                cache = radcache.cache_from_numpy(
                    {f.name: d[f"cache_{f.name}"] for f in
                     dataclasses.fields(radcache.CacheState)},
                    device=self.device)
            arrays = {}
            for k in self._STATE_KEYS:
                cur = getattr(self, k)
                if tuple(d[k].shape) != tuple(cur.shape):
                    raise ValueError(f"{k} has shape {d[k].shape} in {path}, "
                                     f"the renderer {tuple(cur.shape)}")
                arrays[k] = torch.from_numpy(d[k]).to(cur.device, cur.dtype)
            iteration = int(d["iteration"])
            cache_iteration = int(d["cache_iteration"])
        for k, v in arrays.items():
            setattr(self, k, v)
        self.iteration = iteration
        self.cache_iteration = cache_iteration
        self.cache = cache

    def denoise_image(self, mode: str = "nlm") -> torch.Tensor:
        """Denoise the accumulated radiance (RendererBase::DenoiseImage,
        RendererBase.h:246-253) on the renderer's device: ``"nlm"`` the
        joint non-local means guided by the AUX buffers, ``"unet"`` the
        OIDN-style network.  Returns (H, W, 3)."""
        from ray_tpu_torch.models import nlm, unet

        h, w = self.settings.height, self.settings.width
        color = self.full_buf.reshape(h, w, 3)
        base = self.aux_base.reshape(h, w, 3)
        dn = self.aux_dn.reshape(h, w, 4)
        t0 = time.perf_counter()
        with torch.no_grad():
            if mode == "nlm":
                # the reference pipeline (RendererCPU.h:629-658 variance +
                # :661-787 pre-pass): dual-buffer variance 0.5 (rt(2f - h)
                # - rt(h))^2, Gauss-max blurred, NLM in reversible-tonemap
                # space
                half = self.half_buf.reshape(h, w, 3)
                p1 = reversible_tonemap(torch.clamp_min(2.0 * color - half,
                                                        0.0))
                p2 = reversible_tonemap(half)
                variance = nlm.filter_variance(0.5 * (p1 - p2) ** 2)
                out = reversible_tonemap_invert(nlm.nlm_denoise(
                    reversible_tonemap(color), variance, base_color=base,
                    depth_normal=dn))
            elif mode == "unet":
                if self._unet is None:
                    self._unet = unet.UNetFilter(device=self.device)
                out = self._unet.denoise(color, base, dn[..., :3])
            else:
                raise ValueError(mode)
        self._timed("time_denoise_us", t0)
        return out
