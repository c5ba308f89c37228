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
differentiate (``render_tile`` does).  The spatial radiance cache and the
denoisers are not ported and raise, naming their ROADMAP items.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._roadmap import not_ported
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.render.tonemap import (
    ViewTransform,
    apply_view_transform,
    reversible_tonemap,
)
from ray_tpu_torch.scene.camera import Camera, PixelFilter, build_filter_table
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
    use_spatial_cache: bool = False   # not ported: ROADMAP Queue 1 item 24
    cache_entries: int = 1 << 20
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

    def update_spatial_cache(self, scene, cam: Camera, rand_seed: int = 0):
        raise not_ported("the spatial radiance cache (update pass)",
                         "Queue 1 item 24")

    def resolve_spatial_cache(self):
        raise not_ported("the spatial radiance cache (resolve pass)",
                         "Queue 1 item 24")

    def render_sample(self, scene, cam: Camera, rand_seed: int = 0):
        """Advance one progressive sample over the full frame; returns
        ``render_tile``'s output for it."""
        if scene.device != self.device:
            raise ValueError(f"the scene is on {scene.device}, the renderer "
                             f"on {self.device}")
        if self.settings.use_spatial_cache:
            self.update_spatial_cache(scene, cam, rand_seed)
        self.iteration += 1
        adaptive = self.settings.variance_threshold > 0.0
        mask = self.active_px if adaptive else torch.ones_like(self.active_px)
        w, h = self.settings.width, self.settings.height
        t0 = time.perf_counter()
        with torch.no_grad():
            out = render_tile(
                scene, cam, build_filter_table(cam.filter, cam.filter_width),
                0, 0, self.iteration, rand_seed, width=w, height=h,
                tile_w=w, tile_h=h, settings=self.pass_settings,
                use_filter_table=cam.filter != PixelFilter.BOX,
                pixel_mask=mask)
            self.full_buf, self.half_buf, self.sample_counts = _accumulate(
                self.full_buf, self.half_buf, self.sample_counts,
                out["color"], mask)
            it = self.iteration
            self.aux_base = self.aux_base + (out["base_color"]
                                             - self.aux_base) / it
            self.aux_dn = self.aux_dn + (out["depth_normal"] - self.aux_dn) / it
            if adaptive and it >= self.settings.min_samples:
                self.active_px = self.active_px & _variance_mask(
                    self.full_buf, self.half_buf,
                    self.settings.variance_threshold)
        self.stats["samples"] += 1
        if self.settings.collect_stats:
            self.stats["rays_traced"] += int(out["rays_traced"])  # syncs
            self.stats["time_render_us"] += (time.perf_counter() - t0) * 1e6
        return out

    def render(self, scene, cam: Camera, samples: int, rand_seed: int = 0):
        """``samples`` progressive samples; returns :meth:`radiance_image`."""
        for _ in range(samples):
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
        """Progressive render state (buffers + iteration) to ``.npz``."""
        data = {k: getattr(self, k).cpu().numpy() for k in self._STATE_KEYS}
        data["iteration"] = np.int64(self.iteration)
        data["cache_iteration"] = np.int64(0)
        np.savez_compressed(path, **data)

    def load_state(self, path: str):
        """Resume from :meth:`save_state` output; shapes must match the
        settings.  A state that carries a spatial cache raises."""
        with np.load(path) as d:
            if "cache_key_lo" in d:
                raise not_ported("a saved spatial radiance cache",
                                 "Queue 1 item 24")
            arrays = {}
            for k in self._STATE_KEYS:
                cur = getattr(self, k)
                if tuple(d[k].shape) != tuple(cur.shape):
                    raise ValueError(f"{k} has shape {d[k].shape} in {path}, "
                                     f"the renderer {tuple(cur.shape)}")
                arrays[k] = torch.from_numpy(d[k]).to(cur.device, cur.dtype)
            iteration = int(d["iteration"])
        for k, v in arrays.items():
            setattr(self, k, v)
        self.iteration = iteration

    def denoise_image(self, mode: str = "nlm"):
        if mode == "nlm":
            raise not_ported("the NLM denoiser", "Queue 1 item 26")
        if mode == "unet":
            raise not_ported("the UNet denoiser", "Queue 1 item 27")
        raise ValueError(mode)
