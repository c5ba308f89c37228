"""Inverse rendering.  Each step renders the whole frame with
``render_tile`` at iteration k under autograd, takes ``bench.py``'s L2
loss to a target image, back-propagates to every float material column and
``env_col`` and takes one ``torch.optim.Adam`` step.  Set-up renders the
target from material colours drawn from the seed, drives the first steps
(those the reference follows) through the window's own step, and hands the
same optimiser to the window.

The traffic mix gives ``lr``, ``first_steps``, ``trace_seconds`` and
``target_rand_seed_xor``; the configuration gives the frame and
``pass_settings``.

The check: the reference follows the first steps from its own leaves, with
Adam written out.  Numbers: ``loss_gap`` (each step's loss, relative),
``rays_gap`` (the first step's forward ``rays_traced``, exact: the only
step whose inputs both sides share bit for bit, since the program's
material gradients add atomically and a later step's parameters may
differ from the reference's in a last bit, which can flip a Russian
roulette), ``grad_gap``
(the first gradient as Adam holds it, by the worst leaf) and ``step_gap``
(the parameters' change after the first steps, by the worst leaf).  A
leaf's gap is the gap between the two norms over the reference's norm of
that leaf or of the median leaf, whichever is larger; leaves whose
reference gradient is under a thousandth of the median nonzero leaf's are
left out.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rtbench import check, window, yardstick


class Trainer:
    """The optimised object: the scene's float material columns and
    ``env_col`` as leaves, their Adam state and the target image."""

    def __init__(self, run, scene, cam, render_tile, table, use_table):
        self.run, self.scene, self.cam = run, scene, cam
        self.render_tile, self.table, self.use_table = (render_tile, table,
                                                        use_table)
        self.leaves = {k: v.detach().clone().requires_grad_(True)
                       for k, v in scene.materials.items()
                       if v.is_floating_point()}
        self.leaves["env_col"] = scene.env_col.detach().clone() \
            .requires_grad_(True)
        self.opt = torch.optim.Adam(list(self.leaves.values()),
                                    lr=float(run.cell.traffic["lr"]))
        self.target = None

    def _render(self, scene, iteration, rand_seed, settings):
        r = self.run
        return self.render_tile(
            scene, self.cam, self.table, 0, 0, iteration, rand_seed,
            width=r.width, height=r.height, tile_w=r.width, tile_h=r.height,
            settings=settings, use_filter_table=self.use_table)

    def set_target(self, base_color, settings):
        mats = dict(self.scene.materials)
        mats["base_color"] = base_color
        with torch.no_grad():
            self.target = self._render(
                dataclasses.replace(self.scene, materials=mats), 1,
                target_seed(self.run), settings)["color"]

    def step(self, iteration, settings, spans=None):
        mats = {**self.scene.materials,
                **{k: v for k, v in self.leaves.items() if k != "env_col"}}
        sc = dataclasses.replace(self.scene, materials=mats,
                                 env_col=self.leaves["env_col"])
        out = self._render(sc, iteration, self.run.seed, settings)
        loss = yardstick.bench_loss(out["color"], self.target,
                                    self.run.height, self.run.width)
        self.opt.zero_grad(set_to_none=True)
        if spans is not None:
            window.sync(self.run.device)
            with spans("backward"):
                loss.backward()
                window.sync(self.run.device)
        else:
            loss.backward()
        self.opt.step()
        return loss.detach(), out["rays_traced"]


def target_seed(run) -> int:
    return (run.seed ^ int(run.cell.traffic["target_rand_seed_xor"])) \
        & 0xFFFFFFFF


def target_colors(run, n_materials: int) -> np.ndarray:
    """The target's material colours, drawn from the seed."""
    g = np.random.default_rng([int(run.seed) & 0xFFFFFFFF,
                               int(run.seed) >> 32, 2])
    return g.uniform(0.05, 0.95, size=(n_materials, 3)).astype(np.float32)


def run(run):
    from ray_tpu_torch.render.integrator import PassSettings, render_tile
    from ray_tpu_torch.scene.camera import PixelFilter, build_filter_table

    from rtbench.harness import scene_api

    cfg, tr = run.cell.config, run.cell.traffic
    sc, cam = run.cell.scene_module().scene(scene_api("ray_tpu_torch"))
    scene = window.finalize(run, sc)
    ps = PassSettings(**cfg["pass_settings"])
    table = build_filter_table(cam.filter, cam.filter_width)
    t = Trainer(run, scene, cam, render_tile, table,
                cam.filter != PixelFilter.BOX)
    n_mat = scene.materials["base_color"].shape[0]
    t.set_target(torch.as_tensor(target_colors(run, n_mat),
                                 device=run.device), ps)

    # the first steps: what the reference follows
    first = int(tr["first_steps"])
    p0 = {k: v.detach().clone() for k, v in t.leaves.items()}
    losses, first_rays, g1 = [], [], None
    beta1 = t.opt.defaults["betas"][0]
    for k in range(1, first + 1):
        loss, rays = t.step(k, ps)
        losses.append(loss)
        first_rays.append(rays)
        if k == 1:
            # a leaf the loss does not reach has no gradient and no state
            g1 = {n: (t.opt.state[p]["exp_avg"].detach() / (1.0 - beta1)
                      if p in t.opt.state else torch.zeros_like(p.detach()))
                  for n, p in t.leaves.items()}
    p3 = {k: v.detach().clone() for k, v in t.leaves.items()}
    got = {"loss": [float(x) for x in losses],
           "rays": [int(x) for x in first_rays],
           "g1": {k: v.cpu() for k, v in g1.items()},
           "p0": {k: v.cpu() for k, v in p0.items()},
           "p3": {k: v.cpu() for k, v in p3.items()}}

    win = window.Window(run)
    rays = []
    k = first
    while True:
        k += 1
        s0 = time.perf_counter()
        _, r = t.step(k, ps, win.spans)
        window.sync(run.device)
        s1 = time.perf_counter()
        rays.append(r)
        if win.done(s0, s1):
            break
    run.rays = int(torch.stack(rays).sum())

    del t, scene, rays, p0, p3, g1
    window.free(run.device)
    t0 = time.perf_counter()
    ref = reference(run, first)
    run.checks.update(compare(run, got, ref))
    run.readings.update(ref=ref, got_rays=got["rays"])
    run.readings["check_s"] = time.perf_counter() - t0


def reference(run, first: int, control: bool = False) -> dict:
    """The reference's first ``first`` steps: losses, forward rays, the
    first gradient and the leaves before and after, with Adam written
    out."""
    from rtbench.ref.render.integrator import render_tile

    dev, w, h = run.device, run.width, run.height
    scene, cam = check.ref_scene(run)
    ps = check.ref_settings(run, control)
    table, use_table = check.filter_table(cam)

    def frame(sc, iteration, rand_seed):
        return render_tile(sc, cam, table, 0, 0, iteration, rand_seed,
                           width=w, height=h, tile_w=w, tile_h=h,
                           settings=ps, use_filter_table=use_table)

    mats = dict(scene.materials)
    mats["base_color"] = torch.as_tensor(
        target_colors(run, mats["base_color"].shape[0]), device=dev)
    with torch.no_grad():
        target = frame(dataclasses.replace(scene, materials=mats), 1,
                       target_seed(run))["color"]
    leaves = {k: v.detach().clone() for k, v in scene.materials.items()
              if v.is_floating_point()}
    leaves["env_col"] = scene.env_col.detach().clone()
    p0 = {k: v.cpu().clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    lr = float(run.cell.traffic["lr"])
    b1, b2 = check.ADAM_BETAS
    losses, rays, g1 = [], [], None
    for k in range(1, first + 1):
        params = {n: t.requires_grad_(True) for n, t in leaves.items()}
        sc = dataclasses.replace(
            scene, materials={**scene.materials,
                              **{n: t for n, t in params.items()
                                 if n != "env_col"}},
            env_col=params["env_col"])
        out = frame(sc, k, run.seed)
        loss = yardstick.bench_loss(out["color"], target, h, w)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        rays.append(int(out["rays_traced"]))
        grads = {n: (torch.zeros_like(params[n]) if g is None else g)
                 for n, g in zip(names, grads)}
        if k == 1:
            g1 = {n: g.cpu() for n, g in grads.items()}
        with torch.no_grad():
            for n in names:
                g = grads[n]
                m[n] = b1 * m[n] + (1 - b1) * g
                v2[n] = b2 * v2[n] + (1 - b2) * g * g
                mh = m[n] / (1 - b1 ** k)
                vh = v2[n] / (1 - b2 ** k)
                leaves[n] = (params[n] - lr * mh / (vh.sqrt() + check.ADAM_EPS)) \
                    .detach()
    return {"loss": losses, "rays": rays, "g1": g1, "p0": p0,
            "p3": {k: v.cpu() for k, v in leaves.items()}}


def compare(run, got: dict, ref: dict) -> dict:
    leaves = check.counted_leaves(ref["g1"])
    d_got = {k: got["p3"][k] - got["p0"][k] for k in leaves}
    d_ref = {k: ref["p3"][k] - ref["p0"][k] for k in leaves}
    return {
        "loss_gap": check.limited(run, "loss_gap", max(
            abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))),
        "rays_gap": check.limited(run, "rays_gap",
                                  abs(got["rays"][0] - ref["rays"][0])),
        "grad_gap": check.limited(run, "grad_gap", check.worst_leaf_gap(
            got["g1"], ref["g1"], leaves)),
        "step_gap": check.limited(run, "step_gap", check.worst_leaf_gap(
            d_got, d_ref, leaves)),
    }


def control(run) -> dict:
    """The check's numbers with the control (the reference, its path state
    in bfloat16) in the program's place, after a sound ``run``."""
    ctl = reference(run, int(run.cell.traffic["first_steps"]), control=True)
    return compare(run, ctl, run.readings["ref"])
