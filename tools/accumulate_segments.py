#!/usr/bin/env python3
"""How long the cached renderer's accumulate segments run, on one CUDA card.

    python3 tools/accumulate_segments.py [--samples N]

For each scene of ``scenes()`` (finalized on the card), renders N samples (default
3) at 1920x1080 through ``create_renderer`` with ``use_spatial_cache`` at
the cache's defaults (2^20 entries, update at a quarter of the resolution)
and ``chip_smoke.py``'s pass settings, and records the inputs of each
update pass's ``accumulate_segments``.  Every pass's output is held
bit-exact against the plain version.  Prints per scene the valid lanes of
a pass, the entries touched, the longest segment, and, over
``radcache_accumulate``'s tiles of 512 sorted positions, the segments
that run past their tile and the longest overhang: the kernel's last warp
folds those in steps of 128 positions past the tile, the first read with
the tile.  Then times the kernel on the scene's last pass beside
``index_add_`` x2 (``chip_smoke.accumulate_timing``).
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# the kernel's first step past a tile (kAhead in the source)
STEP = 128


def scenes():
    """{label: (scene builder, finalize kwargs, bench.py's big settings?)}"""
    from ray_tpu_torch.utils import test_scenes

    return {
        "flagship": (cs.flagship, {}, False),
        "cornell_sphere": (cs.cornell_sphere, {}, False),
        "colonnade": (cs.colonnade, {}, True),
        "physical_sky": (test_scenes.physical_sky, {}, False),
        "tex_features": (test_scenes.tex_features, {}, True),
    }


def segments(args):
    """(valid lanes, entries touched, longest segment, segments past
    their tile, longest overhang, overhangs past the first step)."""
    import torch

    from ray_tpu_torch.render import radcache

    table, _, entry, _, _, valid = args
    keys, _ = radcache.sort_lanes(entry, valid, table.shape[0])
    k = keys[: int(valid.sum())]
    head = torch.ones_like(k, dtype=torch.bool)
    head[1:] = k[1:] != k[:-1]
    starts = head.nonzero().flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([k.numel()])])
    over = (ends - (starts // cs.ACC_TILE + 1) * cs.ACC_TILE).clamp(min=0)
    return (k.numel(), starts.numel(), int((ends - starts).max()),
            int((over > 0).sum()), int(over.max()), int((over > STEP).sum()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=3)
    n = ap.parse_args().samples
    import torch

    import ray_tpu_torch as ray_tpu
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.render import radcache

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cs.CARD = cs.card_line()
    cuda_build.build(cs.SOURCES)
    settings = ray_tpu.PassSettings(max_total_depth=5, min_total_depth=2)
    big = dataclasses.replace(settings, compact_after=2, compact_factor=4)
    real = radcache.accumulate_segments
    errs = {}
    for label, (build, kw, use_big) in scenes().items():
        sc, cam = build()
        scene = sc.finalize(**kw)
        r = ray_tpu.create_renderer(
            ray_tpu.RenderSettings(width=cs.WIDTH, height=cs.HEIGHT,
                                   use_spatial_cache=True),
            big if use_big else settings)
        captured = []

        def recording(*args):
            out = real(*args)
            captured.append((tuple(a.clone() for a in args),
                             tuple(o.clone() for o in out)))
            return out

        radcache.accumulate_segments = recording
        try:
            r.render(scene, cam, n)
        finally:
            radcache.accumulate_segments = real
        rows = []
        for i, (args, out) in enumerate(captured):
            ref = radcache.accumulate_plain(*(a.cpu() for a in args))
            cs.check_accumulate(out, ref, f"{label} update pass {i + 1}",
                                errs)
            rows.append(segments(args))
        print(f"{label}: {len(rows)} update passes, bit-exact; valid lanes "
              f"{[x[0] for x in rows]}, entries touched "
              f"{[x[1] for x in rows]}, longest segment "
              f"{max(x[2] for x in rows)}; segments past their tile "
              f"{[x[3] for x in rows]}, longest overhang "
              f"{max(x[4] for x in rows)} positions, overhangs past the "
              f"first {STEP}-position step {sum(x[5] for x in rows)} "
              f"[{cs.CARD}]", flush=True)
        cs.accumulate_timing(captured[-1][0], label=f"{label}'s last pass's")
        del scene, r, captured
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
