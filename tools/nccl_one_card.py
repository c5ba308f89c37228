#!/usr/bin/env python3
"""What a one-card host lets ``ray_tpu_torch.parallel`` run across ranks.

    python3 tools/nccl_one_card.py [--timeout SECONDS]

Starts two processes that join one NCCL group (a ``file://`` store in a
temporary directory) with both ranks on CUDA device 0, and has each run
one ``all_reduce`` and the sharded flagship (``render_sharded`` at 64x64)
on a ``make_tile_mesh()`` of the two.  Prints, for each rank, whether that
finished and what it raised, or that the pair was stopped after
``--timeout`` seconds.  NCCL needs one device a rank, so on a host with
one card it is expected to refuse the pair; the same two ranks with gloo
on the CPU (``tests/test_torch_shard.py`` runs four) are what such a host
can run across ranks.
"""

from __future__ import annotations

import argparse
import multiprocessing
import pathlib
import queue
import sys
import tempfile
import traceback

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def rank_main(rank, store, results):
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=2)
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        from ray_tpu_torch.parallel.shard import make_tile_mesh, render_sharded
        from ray_tpu_torch.render.integrator import PassSettings
        from ray_tpu_torch.utils.test_scenes import cornell_scene

        sc, cam = cornell_scene("emissive_quad")
        out = render_sharded(sc.finalize(), cam, None, 1, 0,
                             mesh=make_tile_mesh(), width=64, height=64,
                             settings=PassSettings(max_total_depth=2))
        results.put((rank, f"finished: all_reduce gave {x.tolist()}, the "
                           f"sharded frame traced "
                           f"{int(out['rays_traced'])} rays"))
        dist.destroy_process_group()
    except Exception:   # the finding is what the rank raised
        results.put((rank, "raised: " + traceback.format_exc(limit=2)
                     .strip().splitlines()[-1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("nccl_one_card: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"{torch.cuda.device_count()} CUDA device(s): "
          f"{torch.cuda.get_device_name(0)}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=rank_main,
                             args=(r, f"{tmp}/store", results))
                 for r in range(2)]
        for p in procs:
            p.start()
        found = {}
        try:
            for _ in procs:
                rank, what = results.get(timeout=args.timeout)
                found[rank] = what
        except queue.Empty:   # a rank is still waiting
            pass
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    for r in range(2):
        print(f"rank {r} on cuda:0: "
              + found.get(r, f"stopped after {args.timeout:.0f} s without "
                             f"an answer"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
