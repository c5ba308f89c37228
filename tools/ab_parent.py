#!/usr/bin/env python3
"""Time this tree's trace_binned / trace_tlas kernels and frames against an
earlier checkout's on one CUDA card, in one run.

    python3 tools/ab_parent.py PARENT_DIR [--kernels-only]
        [--frames-only] [--scenes LABEL,...] [--pairs N]

PARENT_DIR is a checkout of an earlier commit (``git archive HEAD~1 | tar
-x -C DIR``) whose ``trace_binned.cu`` and ``trace_tlas.cu`` have the
earlier C entry points: ``trace_binned_launch`` on the slab tables
(slab_f, slab_i, sub_lo, sub_hi), ``binned_sort_key_launch`` on the boxes,
``trace_tlas_launch``, none of them with a ray counter.

1. Kernels: builds the parent's two sources with this tree's nvcc flags,
   captures every trace launch of ``chip_smoke.py``'s phase-10 tiles (the
   top-right 960x540 tile of the instanced, flattened and binned
   colonnades), holds the parent's outputs bit-equal to the plain version
   on each launch (and its binned sort keys equal to this tree's; this
   tree's kernels are held by chip_smoke.py), then times each launch (CUDA
   events, 50 launches) parent, this tree, this tree, parent, and prints
   the mean per scene and mode of each tree's two runs.
2. Frames (unless ``--kernels-only``): runs ``--frames`` workers, one
   process per tree, in the order parent, this tree, this tree, parent
   (``--pairs N`` such pairs, alternating: 2 by default); each renders
   chip_smoke.py's forward frames (the flagship and ``cornell_sphere`` 1x1,
   each colonnade 2x2, 10 frames after a warm-up) and 3 colonnade fwd+bwd
   2x2 frames with remat (bench.py's ``settings_big``), or only the
   ``--scenes`` named, and prints its frame ms.  ``--frames-only`` skips
   step 1.

Writes ``chiprun_out/ab_parent.json`` and prints the card's name and power
limit beside the numbers.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
FRAME_SCENES = ("flagship", "cornell_sphere", "colonnade",
                "colonnade fwd+bwd remat", "colonnade flatten",
                "colonnade binned")
KERNEL_SCENES = ("colonnade", "colonnade flatten", "colonnade binned")
REPS = 50


def parent_libs(parent: pathlib.Path):
    """The parent's trace_binned and trace_tlas libraries, built with this
    tree's flags into build/ab_parent/."""
    from ray_tpu_torch.ops import cuda_build

    out = ROOT / "build" / "ab_parent"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in ("trace_binned", "trace_tlas"):
        target = out / f"parent_{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(target),
               str(parent / "ray_tpu_torch" / "csrc" / f"{name}.cu")]
        jobs.append((name, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, target, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(target))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    libs["trace_binned"].trace_binned_launch.argtypes = [
        p, p, p, p, i, p, p, p, p, p, i64, p, p, p, p, p, i, i, i, p]
    libs["trace_binned"].binned_sort_key_launch.argtypes = [
        p, p, i, p, p, p, p, p, i64, p, p]
    libs["trace_tlas"].trace_tlas_launch.argtypes = [
        p, i, i, p, p, p, p, p, p, i64, p, p, p, p, p, p, i, i, i, p]
    return libs


def parent_launch(libs, kernel, args, any_hit):
    """(closure, outputs) launching the parent's kernel on captured inputs
    (trace_binned on the rays as its wrapper sorts them)."""
    import torch

    import chip_smoke as cs

    tables, rays, extra = cs.split_args(kernel, args)
    if kernel == "trace_binned":
        rays = cs.sorted_rays(tables[0], rays)
    ro, rd, t_min, t_max, active = rays
    R = ro.shape[0]
    dtypes = [torch.float32, torch.int32, torch.float32, torch.float32,
              torch.bool] + ([torch.int32] if kernel == "trace_tlas" else [])
    outs = [torch.empty(R, dtype=d, device=ro.device) for d in dtypes]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in rays]
    if kernel == "trace_tlas":
        (rows,), (mask, max_leaf, stack_size) = tables, extra
        fn = libs["trace_tlas"].trace_tlas_launch
        a = (rows.data_ptr(), rows.shape[0], rows.shape[1], *ptrs,
             None if mask is None else mask.data_ptr(), R,
             *(o.data_ptr() for o in outs), int(max_leaf), int(stack_size),
             int(any_hit), stream)
    else:
        arrays, S = cs.binned_arrays(tables[0])
        fn = libs["trace_binned"].trace_binned_launch
        a = (*(t.data_ptr() for t in arrays), S, *ptrs, R,
             *(o.data_ptr() for o in outs), *extra,
             tables[0]["stack_arr"].shape[0], int(any_hit), stream)

    def launch(_alive=(tables, rays, outs)):
        if fn(*a) != 0:
            cs.fail(f"the parent's {kernel} launch failed")
    return launch, rays, outs


def parent_sortkey(libs, binned, rays):
    import torch

    import chip_smoke as cs

    arrays, S = cs.binned_arrays(binned)
    key = torch.empty(rays[0].shape[0], dtype=torch.int32,
                      device=rays[0].device)
    a = (arrays[2].data_ptr(), arrays[3].data_ptr(), S,
         *(t.data_ptr() for t in rays), rays[0].shape[0], key.data_ptr(),
         torch.cuda.current_stream().cuda_stream)
    fn = libs["trace_binned"].binned_sort_key_launch

    def launch(_alive=(binned, rays, key)):
        if fn(*a) != 0:
            cs.fail("the parent's sort-key launch failed")
    return launch, key


def kernel_ab(parent: pathlib.Path):
    """Per scene and mode: the parent's and this tree's kernel ms."""
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import cuda_build, traverse
    from ray_tpu_torch.render.integrator import PassSettings

    cuda_build.build(["trace_binned", "trace_tlas"])
    libs = parent_libs(parent)
    st = PassSettings(max_total_depth=5, min_total_depth=2, compact_after=2,
                      compact_factor=4)
    makers = {"colonnade": cs.colonnade, "colonnade flatten": cs.colonnade,
              "colonnade binned": cs.colonnade_binned}
    result = {}
    for label in KERNEL_SCENES:
        sc, cam = makers[label]()
        scene = sc.finalize(**cs.FINALIZE.get(label, {}))
        tw, th = cs.WIDTH // 2, cs.HEIGHT // 2
        _, calls = cs.capture_frame(scene, cam, st, 1, cs.WIDTH - tw, 0, tw,
                                    th)
        rows = []
        for kernel, args, any_hit in calls:
            new = cs.raw_launch(kernel, args, any_hit)
            old, rays, old_out = parent_launch(libs, kernel, args, any_hit)
            # the parent's outputs against the wrapper's (the same sorted
            # rays for trace_binned: compare through the plain version)
            old()
            torch.cuda.synchronize()
            plain = getattr(traverse, f"{kernel}_plain")
            if kernel == "trace_binned":
                ref = plain(args[0], *rays, *args[6:], any_hit=any_hit)
            else:
                ref = plain(*args, any_hit=any_hit)
                ref = ref._replace(inst=torch.where(
                    ref.prim >= 0, ref.inst + int(args[1]), -1).to(
                        torch.int32))
            for o, r in zip(old_out, ref):
                if not cs.same_bits(o, r):
                    cs.fail(f"{label}: the parent's {kernel} differs from "
                            f"the plain version")
            times = [cs.time_launches(f, REPS) for f in (old, new, new, old)]
            row = {"kernel": kernel, "any_hit": bool(any_hit),
                   "rays": rays[0].shape[0],
                   "parent_ms": statistics.fmean(times[0::3]),
                   "ms": statistics.fmean(times[1:3]), "runs": times}
            if kernel == "trace_binned":
                urays = args[1:6]
                pk, pkey = parent_sortkey(libs, args[0], urays)
                pk()
                torch.cuda.synchronize()
                if not torch.equal(pkey, traverse.binned_sort_key(args[0],
                                                                  *urays)):
                    cs.fail(f"{label}: the parent's sort key differs")
                nk = cs.raw_sortkey_launch(args[0], urays)
                kt = [cs.time_launches(f, REPS) for f in (pk, nk, nk, pk)]
                row.update(sortkey_parent_ms=statistics.fmean(kt[0::3]),
                           sortkey_ms=statistics.fmean(kt[1:3]))
            rows.append(row)
        result[label] = rows
        for any_hit in (False, True):
            sel = [r for r in rows if r["any_hit"] == any_hit]
            each = ", ".join("%.4f/%.4f" % (r["parent_ms"], r["ms"])
                             for r in sel)
            line = (f"{label} {'anyhit ' if any_hit else 'closest'}: "
                    f"{sel[0]['kernel']} parent "
                    f"{statistics.fmean(r['parent_ms'] for r in sel):.5f} ms, "
                    f"this tree {statistics.fmean(r['ms'] for r in sel):.5f} "
                    f"ms a launch (mean of {len(sel)} launches, each "
                    f"parent/this: {each})")
            if "sortkey_ms" in sel[0]:
                line += (f"; sort key parent "
                         f"{statistics.fmean(r['sortkey_parent_ms'] for r in sel):.5f}"
                         f" ms, this tree "
                         f"{statistics.fmean(r['sortkey_ms'] for r in sel):.5f} ms")
            print(line, flush=True)
        del scene, calls
        torch.cuda.empty_cache()
    return result


def frames_worker(tree: pathlib.Path, scenes) -> int:
    """Render the frames of ``scenes`` with ``tree``'s ray_tpu_torch; print
    one JSON line of frame seconds by scene."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree))
    import dataclasses

    import torch

    import chip_smoke as cs
    import ray_tpu_torch
    from ray_tpu_torch.render.integrator import PassSettings

    assert pathlib.Path(ray_tpu_torch.__file__).resolve().is_relative_to(tree)
    st = PassSettings(max_total_depth=5, min_total_depth=2)
    big = dataclasses.replace(st, compact_after=2, compact_factor=4)
    makers = {"flagship": cs.flagship, "cornell_sphere": cs.cornell_sphere,
              "colonnade": cs.colonnade, "colonnade flatten": cs.colonnade,
              "colonnade binned": cs.colonnade_binned,
              "colonnade fwd+bwd remat": cs.colonnade}
    out = {}
    for label in scenes:
        sc, cam = makers[label]()
        scene = sc.finalize(**cs.FINALIZE.get(label, {}))
        if label == "colonnade fwd+bwd remat":
            remat = dataclasses.replace(big, remat=True)
            tiles = cs.grid_tiles(cs.GRID)
            cs.fwd_bwd(scene, cam, remat, 1, tiles)
            torch.cuda.synchronize()
            bwd = []
            for f in range(cs.COLONNADE_BWD_FRAMES):
                _, _, _, tf, tb = cs.fwd_bwd(scene, cam, remat, 2 + f, tiles)
                bwd.append(tf + tb)
            out[label] = bwd
            del scene
            torch.cuda.empty_cache()
            continue
        grid = (1, 1) if label in ("flagship", "cornell_sphere") else cs.GRID
        s = big if label.startswith("colonnade") else st
        cs.render_frame(scene, cam, s, 1, grid)
        torch.cuda.synchronize()
        frame_s = []
        for f in range(cs.FRAMES):
            t0 = time.perf_counter()
            cs.render_frame(scene, cam, s, 2 + f, grid)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
        out[label] = frame_s
        del scene
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def _option(name, default):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


def main() -> int:
    scenes = _option("--scenes", ",".join(FRAME_SCENES)).split(",")
    if sys.argv[1:2] == ["--frames"]:
        return frames_worker(pathlib.Path(sys.argv[2]).resolve(), scenes)
    parent = pathlib.Path(sys.argv[1]).resolve()
    pairs = int(_option("--pairs", "2"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    t0 = time.perf_counter()
    kernels = None
    if "--frames-only" not in sys.argv:
        kernels = kernel_ab(parent)
        print(f"kernel A/B done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    frames = {"parent": [], "this": []}
    if "--kernels-only" in sys.argv:
        print(cs.CARD)
        return 0
    order = []
    for i in range(pairs):
        pair = [("parent", parent), ("this", ROOT)]
        order += pair if i % 2 == 0 else pair[::-1]
    for who, tree in order:
        r = subprocess.run([sys.executable, __file__, "--frames", str(tree),
                            "--scenes", ",".join(scenes)],
                           capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            cs.fail(f"the {who} frames worker failed:\n{r.stderr[-4000:]}")
        frames[who].append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(f"frames worker ({who}) done at "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    summary = {}
    for label in frames["this"][0]:
        ms = {who: [1e3 * statistics.fmean(run[label]) for run in runs]
              for who, runs in frames.items()}
        summary[label] = ms
        print(f"frame {label}: parent "
              f"{' / '.join('%.1f' % x for x in ms['parent'])} ms (mean "
              f"{statistics.fmean(ms['parent']):.1f}), this tree "
              f"{' / '.join('%.1f' % x for x in ms['this'])} ms (mean "
              f"{statistics.fmean(ms['this']):.1f}); workers in the order "
              f"{', '.join(w for w, _ in order)} [{cs.CARD}]", flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    with open(cs.OUT_DIR / "ab_parent.json", "w") as f:
        json.dump({"card": cs.CARD, "kernels": kernels, "frames": frames,
                   "frame_ms": summary}, f, indent=1)
    print(cs.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main())
