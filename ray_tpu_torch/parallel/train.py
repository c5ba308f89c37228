"""The sharded differentiable train step on ``torch.distributed``.

The port of ``__graft_entry__.py``'s ``dryrun_multichip``: the float
columns of the material table and ``env_col`` are the parameters, the loss
is ``mean((color - target)**2)`` over
:func:`~ray_tpu_torch.parallel.shard.render_sharded_balanced` (the
multi-device default: bit-exact against plain bands), the gradients are
all-reduced over the ranks by the sharded render's entry, and SGD steps at
``SGD_LR``.

Run it on several CPU processes with gloo::

    torchrun --nproc-per-node=4 -m ray_tpu_torch.parallel.train --device cpu

(one process per CUDA card with NCCL: ``--device cuda``, the default).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ray_tpu_torch.parallel.shard import (
    make_tile_mesh,
    render_sharded,
    render_sharded_balanced,
)
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.utils.device import resolve_device

SGD_LR = 1e-3


def params_of(scene):
    """The trained parameters of a scene: ``{"materials": its float
    columns, "env_col": ...}``."""
    return {
        "materials": {k: v for k, v in scene.materials.items()
                      if v.is_floating_point()},
        "env_col": scene.env_col,
    }


def _sgd(scene, params, loss_of):
    """(loss, gradients, new params): ``loss_of(scene)`` on the scene with
    ``params`` as fresh leaves, differentiated, one SGD step; the
    gradients in ``params``' structure."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params["materials"].items()}
    env = params["env_col"].detach().clone().requires_grad_(True)
    scene = dataclasses.replace(
        scene, materials={**scene.materials, **leaves}, env_col=env)
    loss = loss_of(scene)
    # a column the frame never reads gets a zero gradient
    grads = torch.autograd.grad(loss, [*leaves.values(), env],
                                allow_unused=True, materialize_grads=True)
    grads = {"materials": dict(zip(leaves, grads)), "env_col": grads[-1]}
    new = {"materials": {k: v.detach() - SGD_LR * grads["materials"][k]
                         for k, v in leaves.items()},
           "env_col": env.detach() - SGD_LR * grads["env_col"]}
    if isinstance(loss, DTensor):
        loss = loss.full_tensor()
    return loss.detach(), grads, new


def _sharded_rows(full, mesh):
    """A full-frame tensor on every rank as the DTensor sharded by rows
    that the sharded render returns beside it."""
    band = full.shape[0] // mesh.size()
    r = mesh.get_local_rank()
    return DTensor.from_local(full[r * band:(r + 1) * band], mesh, [Shard(0)],
                              run_check=False)


def train_step(scene, cam, params, target, *, mesh, width: int, height: int,
               settings: PassSettings):
    """One step on the mesh: the loss ``mean((color - target)**2)`` over
    ``render_sharded_balanced`` at iteration 1, seed 0, and the parameters
    after one SGD step.  ``params`` is :func:`params_of`'s dict, ``target``
    the full (H*W, 3) frame on every rank.  Returns (loss, gradients, new
    params), the same on every rank; the gradients (the whole frame's,
    all-reduced) in ``params``' structure."""
    tgt = _sharded_rows(target, mesh)

    def loss_of(sc):
        out = render_sharded_balanced(sc, cam, None, 1, 0, mesh=mesh,
                                      width=width, height=height,
                                      settings=settings)
        return ((out["color"] - tgt) ** 2).mean()

    return _sgd(scene, params, loss_of)


def _flagship(device):
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    sc, cam = cornell_scene("emissive_quad")
    return sc.finalize(device=device), cam


def dryrun_multichip(n_devices: int, *, device=None,
                     scaling: bool = False) -> None:
    """One sharded differentiable train step over the ``n_devices`` ranks
    of the caller's process group, at ``__graft_entry__``'s dry-run
    settings (depth 2, remat, width 32, 8 rows a rank); prints the loss on
    rank 0.

    ``scaling`` adds ``__graft_entry__``'s scaling ladder: the same fixed-
    size train step timed on rank 0 alone (``render_tile`` over the whole
    frame) and on every rank (plain bands, then balanced) at four
    (width, depth) sizes, with raw = t1 / (n tn) and the same against
    min(n, cores).  Ranks that share a host share its cores, and ranks that
    share a card share the card (NCCL takes one rank a card, so one card
    runs one rank): on such a host the ladder times contention, not the
    scaling of separate devices."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n_devices:
        raise AssertionError(f"need {n_devices} ranks, the process group "
                             f"has {world}")
    dev = resolve_device(device)
    mesh = make_tile_mesh(device=dev)
    scene, cam = _flagship(dev)
    settings = PassSettings(max_total_depth=2, min_total_depth=2, remat=True)
    width, height = 32, 8 * n_devices
    target = torch.zeros((height * width, 3), dtype=torch.float32, device=dev)
    params = params_of(scene)
    loss, _, new = train_step(scene, cam, params, target, mesh=mesh,
                              width=width, height=height, settings=settings)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"non-finite loss {float(loss)}")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}): ok, loss={float(loss):.6f}, "
              f"grad leaves={len(new['materials']) + 1}")
    if scaling:
        _scaling_ladder(scene, cam, params, mesh, settings, dev)


def _scaling_ladder(scene, cam, params, mesh, settings, dev):
    n = mesh.size()
    cores = os.cpu_count() or 1
    rank0 = dist.get_rank() == 0

    def best_of(step, iters=4):
        step()   # warm-up
        best = float("inf")
        for _ in range(iters):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    for label, w, depth in (("small", 32, 2), ("medium", 64, 3),
                            ("large", 128, 5), ("xlarge", 256, 6)):
        h = 8 * n
        st = dataclasses.replace(settings, max_total_depth=depth,
                                 min_total_depth=depth)
        tgt = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)

        def single(sc):
            out = render_tile(sc, cam, None, 0, 0, 1, 0, width=w, height=h,
                              tile_w=w, tile_h=h, settings=st,
                              use_filter_table=False)
            return ((out["color"] - tgt) ** 2).mean()

        t1 = best_of(lambda: _sgd(scene, params, single)) if rank0 else 0.0
        dist.barrier()
        for balanced in (False, True):
            render_fn = render_sharded_balanced if balanced else render_sharded
            tgt_d = _sharded_rows(tgt, mesh)

            def sharded(sc, render_fn=render_fn, tgt_d=tgt_d):
                out = render_fn(sc, cam, None, 1, 0, mesh=mesh, width=w,
                                height=h, settings=st)
                return ((out["color"] - tgt_d) ** 2).mean()

            tn = best_of(lambda: _sgd(scene, params, sharded))
            if rank0:
                raw = t1 / (n * tn)
                adj = t1 / (min(n, cores) * tn)
                tag = "balanced" if balanced else "bands"
                print(f"scaling [{label} {tag}: {w}x{h} depth {depth}]: "
                      f"t1={t1 * 1e3:.1f}ms t{n}={tn * 1e3:.1f}ms raw~"
                      f"{raw:.2f} (ceiling {min(n, cores) / n:.2f} on "
                      f"{cores} cores) core-adj~{adj:.2f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scaling", action="store_true",
                    help="also run the scaling ladder")
    args = ap.parse_args()
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        dryrun_multichip(dist.get_world_size(), device=args.device,
                         scaling=args.scaling)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
