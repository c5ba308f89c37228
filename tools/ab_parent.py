#!/usr/bin/env python3
"""Time this tree's trace kernels and frames against an earlier checkout's
on one CUDA card, in one run.

    python3 tools/ab_parent.py PARENT_DIR [--kernels-only]
        [--frames-only] [--scenes LABEL,...] [--pairs N]

PARENT_DIR is a checkout of an earlier commit (``git archive HEAD~1 | tar
-x -C DIR``) whose C entry points take the arguments this tree's do.  Its
``trace_brute`` / ``trace_bvh`` read the raw (T, 9) / (N, 14) tables when
its ``ops/traverse.py`` has no ``tri_rows`` (before the cached rows), this
tree's cached rows otherwise.

1. Kernels: builds the parent's sources of the kernels of the chosen
   scenes with this tree's nvcc flags, captures every trace launch of
   ``chip_smoke.py``'s frames (the flagship's and ``cornell_sphere``'s
   1920x1080 frame: ``trace_brute`` and ``trace_bvh``; the top-right
   960x540 tile of the instanced, flattened and binned colonnades:
   ``trace_tlas`` and ``trace_binned``), holds the parent's outputs
   bit-equal to the plain version on each launch (and its binned sort keys
   equal to this tree's; this tree's kernels are held by chip_smoke.py),
   then times each launch (CUDA events, 50 launches) parent, this tree,
   this tree, parent, and prints the mean per scene and mode of each
   tree's two runs.
2. Frames (unless ``--kernels-only``): runs ``--frames`` workers, one
   process per tree, in the order parent, this tree, this tree, parent
   (``--pairs N`` such pairs, alternating: 2 by default); each renders
   chip_smoke.py's forward frames (the flagship and ``cornell_sphere`` 1x1,
   each colonnade 2x2, 10 frames after a warm-up), the two Cornell scenes'
   fwd+bwd frames (5), 3 colonnade fwd+bwd 2x2 frames with remat
   (bench.py's ``settings_big``) and 8 samples of the flagship renderer
   (``create_renderer``), or only the ``--scenes`` named, and prints its
   frame ms.  ``--frames-only`` skips step 1.

``--scenes`` names the scenes of both steps (default: all).  Writes
``ab_parent.json`` in chip_smoke.py's ``OUT_DIR`` and prints the card's
name and power limit beside the numbers.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
FRAME_SCENES = ("flagship", "cornell_sphere", "flagship fwd+bwd",
                "cornell_sphere fwd+bwd", "renderer", "colonnade",
                "colonnade fwd+bwd remat", "colonnade flatten",
                "colonnade binned")
KERNEL_SCENES = ("flagship", "cornell_sphere", "colonnade",
                 "colonnade flatten", "colonnade binned")
REPS = 50


def _chip_smoke():
    """This tree's chip_smoke.py, whichever ray_tpu_torch is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def parent_fns(parent: pathlib.Path, kernels):
    """The parent's C entry points of ``kernels``, built with this tree's
    flags into build/ab_parent/, bound with this tree's argument types."""
    from ray_tpu_torch.ops import cuda_build, traverse

    out = ROOT / "build" / "ab_parent"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    csrc = parent / "ray_tpu_torch" / "csrc"
    for name in kernels:
        target = out / f"parent_{name}-{cuda_build.source_hash(csrc, name)}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(target),
               str(csrc / f"{name}.cu")]
        jobs.append((name, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    ours = {"trace_brute": traverse._brute_fn, "trace_bvh": traverse._bvh_fn,
            "trace_tlas": traverse._tlas_fn,
            "trace_binned": traverse._binned_fn}
    fns = {}
    for name, target, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(target))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ours[name]().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
        if name == "trace_binned":
            key = lib.binned_sort_key_launch
            key.argtypes = traverse._binned_key_fn().argtypes
            key.restype = ctypes.c_int
            fns["binned_sort_key"] = key
    return fns


def parent_arrays(parent: pathlib.Path, kernel, tables):
    """The tables the parent's entry point reads (``raw_launch``'s
    ``arrays``): the raw ones for a trace_brute / trace_bvh before the
    cached rows, else this tree's."""
    import chip_smoke as cs

    text = (parent / "ray_tpu_torch" / "ops" / "traverse.py").read_text()
    if kernel in ("trace_brute", "trace_bvh") and "def tri_rows" not in text:
        return tables
    return cs.kernel_arrays(kernel, tables)


def parent_sortkey(fns, binned, rays):
    import torch

    import chip_smoke as cs

    tree = cs.kernel_arrays("trace_binned", (binned,))[2]
    S = cs.binned_arrays(binned)[1]
    key = torch.empty(rays[0].shape[0], dtype=torch.int32,
                      device=rays[0].device)
    a = (tree.data_ptr(), S, *(t.data_ptr() for t in rays), rays[0].shape[0],
         key.data_ptr(), torch.cuda.current_stream().cuda_stream)
    fn = fns["binned_sort_key"]

    def launch(_alive=(binned, tree, rays, key)):
        if fn(*a) != 0:
            cs.fail("the parent's sort-key launch failed")
    return launch, key


def kernel_ab(parent: pathlib.Path, scenes):
    """Per scene and mode: the parent's and this tree's kernel ms."""
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import cuda_build, traverse
    from ray_tpu_torch.render.integrator import PassSettings

    kernel_of = {"flagship": "trace_brute", "cornell_sphere": "trace_bvh",
                 "colonnade": "trace_tlas", "colonnade flatten": "trace_tlas",
                 "colonnade binned": "trace_binned"}
    scenes = [s for s in KERNEL_SCENES if s in scenes]
    kernels = sorted({kernel_of[s] for s in scenes})
    cuda_build.build(kernels)
    fns = parent_fns(parent, kernels)
    st = PassSettings(max_total_depth=5, min_total_depth=2)
    big = PassSettings(max_total_depth=5, min_total_depth=2, compact_after=2,
                       compact_factor=4)
    makers = {"flagship": cs.flagship, "cornell_sphere": cs.cornell_sphere,
              "colonnade": cs.colonnade, "colonnade flatten": cs.colonnade,
              "colonnade binned": cs.colonnade_binned}
    result = {}
    for label in scenes:
        sc, cam = makers[label]()
        scene = sc.finalize(**cs.FINALIZE.get(label, {}))
        if label.startswith("colonnade"):
            tw, th = cs.WIDTH // 2, cs.HEIGHT // 2
            _, calls = cs.capture_frame(scene, cam, big, 1, cs.WIDTH - tw, 0,
                                        tw, th)
        else:
            _, calls = cs.capture_frame(scene, cam, st, 1)
        rows = []
        for kernel, args, any_hit in calls:
            new, _ = cs.raw_launch(kernel, args, any_hit)
            tables = cs.split_args(kernel, args)[0]
            old, old_out = cs.raw_launch(
                kernel, args, any_hit, fn=fns[kernel],
                arrays=parent_arrays(parent, kernel, tables))
            # the parent's outputs against the plain version (on the rays
            # as trace_binned's wrapper sorts them)
            old()
            torch.cuda.synchronize()
            plain = getattr(traverse, f"{kernel}_plain")
            if kernel == "trace_binned":
                rays = cs.sorted_rays(args[0], args[1:6])
                ref = plain(args[0], *rays, *args[6:], any_hit=any_hit)
            else:
                ref = plain(*args, any_hit=any_hit)
            if kernel == "trace_tlas":
                ref = ref._replace(inst=torch.where(
                    ref.prim >= 0, ref.inst + int(args[1]), -1).to(
                        torch.int32))
            for o, r in zip(old_out, ref):
                if not cs.same_bits(o, r):
                    cs.fail(f"{label}: the parent's {kernel} differs from "
                            f"the plain version")
            times = [cs.time_launches(f, REPS) for f in (old, new, new, old)]
            row = {"kernel": kernel, "any_hit": bool(any_hit),
                   "rays": args[cs.RAY_ARG.get(kernel, 2)].shape[0],
                   "parent_ms": statistics.fmean(times[0::3]),
                   "ms": statistics.fmean(times[1:3]), "runs": times}
            if kernel != "trace_binned":
                b = cs.launch_bound(kernel, args, any_hit)
                row["bound_ms"] = max(b["bytes_ms"], b["ops_ms"])
            if kernel == "trace_binned":
                urays = args[1:6]
                pk, pkey = parent_sortkey(fns, args[0], urays)
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
            if "bound_ms" in sel[0]:
                b = statistics.fmean(r["bound_ms"] for r in sel)
                line += (f"; bound {b:.5f} ms, {b / statistics.fmean(r['ms'] for r in sel):.3f}"
                         f" of it reached (parent "
                         f"{b / statistics.fmean(r['parent_ms'] for r in sel):.3f})")
            if "sortkey_ms" in sel[0]:
                line += (f"; sort key parent "
                         f"{statistics.fmean(r['sortkey_parent_ms'] for r in sel):.5f}"
                         f" ms, this tree "
                         f"{statistics.fmean(r['sortkey_ms'] for r in sel):.5f} ms")
            print(f"{line} [{cs.CARD}]", flush=True)
        del scene, calls
        torch.cuda.empty_cache()
    return result


def frames_worker(tree: pathlib.Path, scenes) -> int:
    """Render the frames of ``scenes`` with ``tree``'s ray_tpu_torch (and
    this tree's chip_smoke.py); print one JSON line of frame seconds by
    scene (a renderer sample's seconds for ``renderer``)."""
    sys.path.insert(0, str(tree))
    import dataclasses

    import torch

    import ray_tpu_torch
    from ray_tpu_torch.render.integrator import PassSettings

    cs = _chip_smoke()
    assert pathlib.Path(ray_tpu_torch.__file__).resolve().is_relative_to(tree)
    st = PassSettings(max_total_depth=5, min_total_depth=2)
    big = dataclasses.replace(st, compact_after=2, compact_factor=4)
    makers = {"flagship": cs.flagship, "cornell_sphere": cs.cornell_sphere,
              "colonnade": cs.colonnade, "colonnade flatten": cs.colonnade,
              "colonnade binned": cs.colonnade_binned,
              "renderer": cs.flagship}
    out = {}
    for label in scenes:
        sc, cam = makers[label.split(" fwd+bwd")[0]]()
        scene = sc.finalize(**cs.FINALIZE.get(label, {}))
        if label == "renderer":
            r = ray_tpu_torch.create_renderer(
                ray_tpu_torch.RenderSettings(width=cs.WIDTH,
                                             height=cs.HEIGHT), st)
            r.render(scene, cam, 1)
            torch.cuda.synchronize()
            frame_s = []
            for _ in range(8):
                t0 = time.perf_counter()
                r.render(scene, cam, 1)
                torch.cuda.synchronize()
                frame_s.append(time.perf_counter() - t0)
        elif "fwd+bwd" in label:
            remat = label.endswith("remat")
            s = dataclasses.replace(big, remat=True) if remat else st
            tiles = cs.grid_tiles(cs.GRID if remat else (1, 1))
            n = cs.COLONNADE_BWD_FRAMES if remat else cs.BWD_FRAMES
            cs.fwd_bwd(scene, cam, s, 1, tiles)
            torch.cuda.synchronize()
            frame_s = []
            for f in range(n):
                _, _, _, tf, tb = cs.fwd_bwd(scene, cam, s, 2 + f, tiles)
                frame_s.append(tf + tb)
        else:
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

    cs = _chip_smoke()

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    t0 = time.perf_counter()
    kernels = None
    if "--frames-only" not in sys.argv:
        kernels = kernel_ab(parent, scenes)
        print(f"kernel A/B done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    frames = {"parent": [], "this": []}
    if "--kernels-only" in sys.argv:
        scenes = []
    order = []
    for i in range(pairs):
        pair = [("parent", parent), ("this", ROOT)]
        order += pair if i % 2 == 0 else pair[::-1]
    for who, tree in order if scenes else ():
        r = subprocess.run([sys.executable, __file__, "--frames", str(tree),
                            "--scenes", ",".join(scenes)],
                           capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            cs.fail(f"the {who} frames worker failed:\n{r.stderr[-4000:]}")
        frames[who].append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(f"frames worker ({who}) done at "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    summary = {}
    for label in frames["this"][0] if scenes else ():
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
