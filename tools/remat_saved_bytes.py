#!/usr/bin/env python3
"""Bytes that autograd keeps for the backward of one colonnade tile, with
and without path replay (``PassSettings.remat``).

    python3 tools/remat_saved_bytes.py [--x0 912 --y0 500 --tile 64x48]
                                       [--lanes 518400]

Renders one tile of ``colonnade_scene()`` on the CPU with the port's plain
path at bench.py's big-scene settings (depth 5, compaction after bounce 2),
with every float material column and ``env_col`` as leaf tensors, and
counts what the backward keeps alive, by unique storage, leaving out the
scene's own tables:

* ``remat=False``: every tensor autograd saves
  (``torch.autograd.graph.saved_tensors_hooks``);
* ``remat=True``: what autograd saves outside the checkpointed bounces
  (the same hooks: inside a checkpoint its own hooks take over), plus what
  each checkpoint keeps: its input state and, with ``remat_save_trace``,
  its trace tape.

Each storage is charged to the bounce in which it was first kept.  Prints
the bytes a lane of each bounce (the bounce's own lane count: the
compacted bounces run on K lanes) and the tile's total scaled to
``--lanes`` (518,400: one 960x540 tile of bench.py's 2x2 grid, which runs
its own backward).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from ray_tpu_torch.render import integrator  # noqa: E402
from ray_tpu_torch.utils.test_scenes import colonnade_scene  # noqa: E402

WIDTH, HEIGHT = 1920, 1080
BIG = dict(max_total_depth=5, min_total_depth=2, compact_after=2,
           compact_factor=4)


def _tensors(x):
    """Every tensor in a nest of tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def count(scene, cam, x0, y0, tw, th, **settings):
    """{bounce: [bytes, lanes]} kept for the backward (bounce -1: outside
    every bounce), and the loss."""
    params = {k: v.clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    env = scene.env_col.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, materials={**scene.materials, **params},
                             env_col=env)
    skip = {t.untyped_storage().data_ptr() for f in dataclasses.fields(sc)
            for t in _tensors(getattr(sc, f.name))}
    seen = set()
    per_bounce = {}
    current = [-1]

    def keep(t):
        s = t.untyped_storage()
        if s.data_ptr() in skip or s.data_ptr() in seen or s.nbytes() == 0:
            return
        seen.add(s.data_ptr())
        per_bounce.setdefault(current[0], [0, 0])[0] += s.nbytes()

    real_bounce = integrator._bounce
    real_replayed = integrator._replayed_bounce
    real_tape_call = integrator._TraceTape.__call__

    def bounce(scene_, settings_, feats, st, b, sample_i, tape=None):
        prev = current[0]
        current[0] = b
        per_bounce.setdefault(b, [0, 0])[1] = st.ro.shape[0]
        try:
            return real_bounce(scene_, settings_, feats, st, b, sample_i, tape)
        finally:
            current[0] = prev

    def replayed(scene_, settings_, feats, st, b, sample_i):
        current[0] = b
        for t in st:
            keep(t)           # the checkpoint holds its inputs
        try:
            return real_replayed(scene_, settings_, feats, st, b, sample_i)
        finally:
            current[0] = -1

    def tape_call(self, trace, *args):
        fresh = self.pos == len(self.outs)
        out = real_tape_call(self, trace, *args)
        if fresh:
            for t in _tensors(out):
                keep(t)
        return out

    def pack(t):
        keep(t)
        return t

    integrator._bounce = bounce
    integrator._replayed_bounce = replayed
    integrator._TraceTape.__call__ = tape_call
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = integrator.render_tile(
                sc, cam, None, x0, y0, 1, 0, width=WIDTH, height=HEIGHT,
                tile_w=tw, tile_h=th,
                settings=integrator.PassSettings(**BIG, **settings),
                use_filter_table=False)
            loss = (out["color"] ** 2).sum() / (HEIGHT * WIDTH * 3)
    finally:
        integrator._bounce = real_bounce
        integrator._replayed_bounce = real_replayed
        integrator._TraceTape.__call__ = real_tape_call
    loss.backward()
    if not all(torch.isfinite(p.grad).all() for p in params.values()
               if p.grad is not None):
        raise RuntimeError("non-finite gradient")
    return per_bounce, float(loss.detach())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--x0", type=int, default=912)
    ap.add_argument("--y0", type=int, default=500)
    ap.add_argument("--tile", default="64x48")
    ap.add_argument("--lanes", type=int, default=518_400)
    args = ap.parse_args()
    tw, th = (int(v) for v in args.tile.split("x"))
    torch.set_num_threads(1)
    sc, cam = colonnade_scene()
    scene = sc.finalize(device="cpu")
    R = tw * th
    for label, kw in (("remat=False", {}), ("remat=True", dict(remat=True)),
                      ("remat=True, remat_save_trace=False",
                       dict(remat=True, remat_save_trace=False))):
        per_bounce, loss = count(scene, cam, args.x0, args.y0, tw, th, **kw)
        total = sum(b for b, _ in per_bounce.values())
        print(f"{label}: loss {loss:.9e}; kept for backward over the "
              f"{tw}x{th} tile at ({args.x0}, {args.y0}): {total} B, "
              f"{total / R:.1f} B a tile lane; scaled to {args.lanes} lanes: "
              f"{total * args.lanes / R / 1e9:.3f} GB")
        for b in sorted(per_bounce):
            nbytes, lanes = per_bounce[b]
            where = "outside the bounces" if b < 0 else f"bounce {b}"
            per_lane = f", {nbytes / lanes:.1f} B a lane" if lanes else ""
            print(f"  {where}: {nbytes} B over {lanes or R} lanes{per_lane}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
