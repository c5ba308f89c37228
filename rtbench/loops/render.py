"""Progressive rendering: ``create_renderer`` and
``Renderer.render_sample`` over the whole frame, iterations 1, 2, ...,
each sample synchronised, as a viewer that shows every sample waits for
it.

The traffic mix gives ``warmup_samples``, ``trace_seconds``,
``check_pixels`` and ``check_block_lanes``; the configuration gives the
frame, ``pass_settings`` and ``render_settings`` (the rest of
``RenderSettings``).

The check: a sample is a pure function of (pixel, iteration, dimension,
seed), so the reference renders the check pixels (drawn from the seed) at
every iteration the window completed, in one batch of lanes, and
accumulates them as the renderer does.  Numbers:

* ``pixel_gap_max``: the largest over the check pixels of the largest
  channel's gap between the renderer's accumulated radiance and the
  reference's, over the reference's value plus a hundredth of the pixels'
  mean (traversal, shading, light sampling and the RNG of every sample);
* ``hit_gap_max``: the same for the accumulated normal and depth at each
  sample's primary hit (``Renderer.aux_dn``): the traversal's hits;
* ``frame_rays_gap``: the reference's ``rays_traced`` of the whole frame
  at the window's last iteration against the program's, exact (every
  timed ray's traversal, shading decision and termination).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import check, window

# render settings whose samples the check cannot recompute pixel by pixel:
# adaptive sampling skips pixels, the cache ends paths on the program's state
FOLLOWED = {"variance_threshold": 0.0, "use_spatial_cache": False}


def check_pixels(seed: int, width: int, height: int, count: int):
    """The pixels the check recomputes, drawn from the seed."""
    g = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 1])
    n = width * height
    return np.sort(g.choice(n, size=min(count, n), replace=False))


def render_settings(run) -> dict:
    rs = dict(run.cell.config.get("render_settings", {}))
    for k, plain in FOLLOWED.items():
        if rs.get(k, plain) != plain:
            raise ValueError(f"the render loop's check does not follow "
                             f"{k}={rs[k]!r}: such a cell needs a loop of "
                             f"its own")
    return rs


def run(run):
    import ray_tpu_torch as rt
    from ray_tpu_torch.render.integrator import PassSettings

    from rtbench.harness import scene_api

    cfg, tr = run.cell.config, run.cell.traffic
    sc, cam = run.cell.scene_module().scene(scene_api("ray_tpu_torch"))
    scene = window.finalize(run, sc)
    chain = ("gpu",) if run.device.type == "cuda" else ("cpu",)
    renderer = rt.create_renderer(
        rt.RenderSettings(width=run.width, height=run.height,
                          **render_settings(run)),
        PassSettings(**cfg["pass_settings"]), enabled_types=chain)
    for _ in range(int(tr["warmup_samples"])):
        renderer.render_sample(scene, cam, run.seed)
    renderer.clear()

    win = window.Window(run)
    rays = []
    while True:
        s0 = time.perf_counter()
        out = renderer.render_sample(scene, cam, run.seed)
        window.sync(run.device)
        s1 = time.perf_counter()
        rays.append(out["rays_traced"])
        if win.done(s0, s1):
            break
    run.rays = int(torch.stack(rays).sum())

    pix = check_pixels(run.seed, run.width, run.height,
                       int(tr["check_pixels"]))
    idx = torch.as_tensor(pix, device=run.device)
    got = {"acc": renderer.full_buf[idx].cpu(),
           "dn": renderer.aux_dn[idx].cpu(), "frame_rays": int(rays[-1])}
    del renderer, scene, out, rays
    window.free(run.device)
    t0 = time.perf_counter()
    ref = reference(run, pix, run.units)
    run.checks.update(compare(run, got, ref))
    run.readings.update(pix=pix, ref=ref)
    run.readings["check_s"] = time.perf_counter() - t0


def reference(run, pix, n_iter: int, control: bool = False) -> dict:
    """The reference's accumulated radiance and primary-hit normal and
    depth at pixels ``pix`` after iterations 1..n_iter, and the whole
    frame's ``rays_traced`` at iteration n_iter.  ``control``: the path
    state in bfloat16."""
    from rtbench.ref.render.integrator import render_tile
    from rtbench.ref.render.raygen import rays_at

    dev, w, h = run.device, run.width, run.height
    scene, cam = check.ref_scene(run)
    ps = check.ref_settings(run, control)
    table, use_table = check.filter_table(cam)
    p = torch.as_tensor(pix, dtype=torch.int64, device=dev)
    n_pix = p.shape[0]
    px = (p % w).to(torch.int32).repeat(n_iter)
    py = (p // w).to(torch.int32).repeat(n_iter)
    its = torch.arange(1, n_iter + 1, dtype=torch.int64,
                       device=dev).repeat_interleave(n_pix)
    block = int(run.cell.traffic["check_block_lanes"])
    colors, dns = [], []
    with torch.no_grad():
        for s in range(0, px.shape[0], block):
            sl = slice(s, s + block)
            n = px[sl].shape[0]
            rays = rays_at(cam, table, px[sl], py[sl], its[sl] - 1, run.seed,
                           width=w, height=h, use_filter_table=use_table)
            out = render_tile(scene, None, table, 0, 0, its[sl], run.seed,
                              width=w, height=h, tile_w=n, tile_h=1,
                              settings=ps, use_filter_table=use_table,
                              rays=rays)
            colors.append(out["color"])
            dns.append(out["depth_normal"])
        acc = check.accumulate(torch.cat(colors), n_pix)
        dn = check.accumulate(torch.cat(dns), n_pix)
        t0 = time.perf_counter()
        frame_rays = int(render_tile(
            scene, cam, table, 0, 0, n_iter, run.seed, width=w, height=h,
            tile_w=w, tile_h=h, settings=ps,
            use_filter_table=use_table)["rays_traced"])
        frame_s = time.perf_counter() - t0
    return {"acc": acc.cpu(), "dn": dn.cpu(), "frame_rays": frame_rays,
            "frame_s": frame_s}


def compare(run, got, ref) -> dict:
    return {
        "pixel_gap_max": check.limited(
            run, "pixel_gap_max",
            float(check.pixel_gaps(got["acc"], ref["acc"]).max())),
        "hit_gap_max": check.limited(
            run, "hit_gap_max",
            float(check.pixel_gaps(got["dn"], ref["dn"]).max())),
        "frame_rays_gap": check.limited(
            run, "frame_rays_gap", abs(got["frame_rays"] - ref["frame_rays"])),
    }


def control(run) -> dict:
    """The check's numbers with the control (the reference, its path state
    in bfloat16) in the program's place, after a sound ``run``."""
    ctl = reference(run, run.readings["pix"], run.units, control=True)
    return compare(run, ctl, run.readings["ref"])
