#!/usr/bin/env python3
"""Run the port's flagship forward frame on one CUDA card and check it.

    python3 chip_smoke.py

Drives ``ray_tpu_torch`` (never JAX, never ``ray_tpu``) through the entry
points a user calls — ``cornell_scene()`` → ``Scene.finalize()`` →
``render_tile`` at 1920x1080, 1 spp, depth 5 — and:

1. prints the card's name and power limit (``nvidia-smi``); exits non-zero
   when CUDA is absent;
2. builds the CUDA kernel from ``ray_tpu_torch/csrc`` and prints the build
   seconds;
3. holds each kernel bit-exact against its plain PyTorch version: on the
   traversal test generator's scenes (8, 24, 40 triangles, 2M rays) and on
   the inputs of every launch of one flagship frame;
4. holds a 64x48 tile rendered on the card against the same tile rendered
   by the port's plain CPU path;
5. renders ``FRAMES`` flagship frames after a warm-up frame, with the
   launch counts set to 0 just before and read just after: every pixel
   finite, mean positive, 6 closest-hit + 6 any-hit launches a frame;
   prints forward Mray/s, frame ms (window / frames) with the spread of
   the frames within the window, and peak memory beside the card's name
   and power limit;
6. profiles one more frame with ``torch.profiler``: device kernel time,
   its share of the frame, the RNG's cost, and an op table written to
   ``chiprun_out/chip_smoke_profile.txt``;
7. times each kernel (CUDA events) at the flagship frame's launch shapes
   beside its plain version and its bound, and prints one ``kernels`` JSON
   line, the card line, and last the ``{"ok": true, ...}`` line.

Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

WIDTH, HEIGHT = 1920, 1080
FRAMES = 10
PROFILE_DIR = pathlib.Path(__file__).resolve().parent / "chiprun_out"
TPU_KERNEL = "ray_tpu/ops/traverse_pallas.py:57"
KERNEL_SOURCE = "ray_tpu_torch/csrc/trace_brute.cu"
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# one ray-triangle test: 46 float multiply/add/subtract/divide (the edges
# are per triangle; compares are not counted)
OPS_PER_TEST = 46
# every lane reads t_max, active (5 B) and writes t, u, v, prim, backface
# (17 B); an active lane also reads ro, rd, t_min (28 B)
BYTES_PER_LANE = 22
BYTES_PER_ACTIVE_LANE = 28


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    import torch

    if a.dtype == torch.bool or a.dtype == torch.int32:
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    return float((a - b).abs().max())


def generator_case(n_tris, n_rays, seed, device):
    """The traversal tests' random scene and rays (tests/test_traverse_pallas.py
    ``_scene`` / ``_rays``), as packed (T, 9) triangles."""
    import numpy as np
    import torch

    r = np.random.RandomState(seed)
    base = (r.rand(n_tris, 1, 3) - 0.5) * 10.0
    size = max(0.8, 12.0 / np.sqrt(n_tris))
    tris = (base + (r.rand(n_tris, 3, 3) - 0.5) * size).astype(np.float32)
    r = np.random.RandomState(seed + 1)
    ro = (r.rand(n_rays, 3).astype(np.float32) - 0.5) * 12.0
    target = (r.rand(n_rays, 3).astype(np.float32) - 0.5) * 6.0
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (t(tris.reshape(n_tris, 9)), t(ro), t(rd.astype(np.float32)),
            torch.zeros(n_rays, device=device),
            torch.full((n_rays,), 1e30, device=device),
            torch.ones(n_rays, dtype=torch.bool, device=device))


def check_parity(case, label, errs):
    """Kernel vs plain on one input set, closest-hit and any-hit."""
    from ray_tpu_torch.ops import traverse

    tris, ro, rd, t_min, t_max, active = case[:6]
    modes = (False, True) if len(case) == 6 else (case[6],)
    for any_hit in modes:
        k = traverse.trace_brute(tris, ro, rd, t_min, t_max, active, any_hit)
        p = traverse.trace_brute_plain(tris, ro, rd, t_min, t_max, active, any_hit)
        name = "trace_brute_anyhit" if any_hit else "trace_brute_closest"
        for f in k._fields:
            a, b = getattr(k, f), getattr(p, f)
            errs[name] = max(errs.get(name, 0.0), max_abs_err(a, b))
            if not same_bits(a, b):
                fail(f"{name} {f} differs from the plain version on {label}: "
                     f"max |diff| {max_abs_err(a, b)}")
        hits = int((k.prim >= 0).sum())
        print(f"  parity {label} {name}: bit-exact ({hits} hits of "
              f"{ro.shape[0]} rays)")


def capture_frame(scene, cam, settings, iteration):
    """Render one frame, keeping a copy of every trace_brute input."""
    from ray_tpu_torch.ops import traverse
    from ray_tpu_torch.render.integrator import render_tile

    calls = []
    real = traverse.trace_brute

    def recording(tris, ro, rd, t_min, t_max, active, any_hit=False):
        calls.append((tris, ro.clone(), rd.clone(), t_min.clone(),
                      t_max.clone(), active.clone(), any_hit))
        return real(tris, ro, rd, t_min, t_max, active, any_hit)

    traverse.trace_brute = recording
    try:
        out = render_tile(
            scene, cam, None, 0, 0, iteration, 0, width=WIDTH, height=HEIGHT,
            tile_w=WIDTH, tile_h=HEIGHT, settings=settings,
            use_filter_table=False,
        )
    finally:
        traverse.trace_brute = real
    return out, calls


def time_launches(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_timings(calls):
    """Per launch of the captured frame: kernel ms, plain ms, bound ms."""
    import torch

    from ray_tpu_torch.ops import traverse

    fn = traverse._brute_fn()
    rows = []
    for tris, ro, rd, t_min, t_max, active, any_hit in calls:
        R, T = ro.shape[0], tris.shape[0]
        outs = [torch.empty(R, dtype=d, device=ro.device) for d in
                (torch.float32, torch.int32, torch.float32, torch.float32,
                 torch.bool)]
        stream = torch.cuda.current_stream().cuda_stream
        args = (tris.data_ptr(), T, ro.data_ptr(), rd.data_ptr(),
                t_min.data_ptr(), t_max.data_ptr(), active.data_ptr(), R,
                *[o.data_ptr() for o in outs], int(any_hit), stream)

        def launch():
            if fn(*args) != 0:
                fail("trace_brute launch failed while timing")

        ms = time_launches(launch, 50)
        plain_ms = time_launches(
            lambda: traverse.trace_brute_plain(
                tris, ro, rd, t_min, t_max, active, any_hit), 3)
        plain = traverse.trace_brute_plain(tris, ro, rd, t_min, t_max, active,
                                           any_hit)
        n_active = int(active.sum())
        if any_hit:
            # tests run until the first hit: prim + 1 for hits, T for misses
            hit = plain.prim >= 0
            tests = int(torch.where(hit, plain.prim + 1, T)[active].sum())
        else:
            tests = n_active * T
        nbytes = BYTES_PER_LANE * R + BYTES_PER_ACTIVE_LANE * n_active + 36 * T
        ops = OPS_PER_TEST * tests
        rows.append({
            "any_hit": bool(any_hit), "rays": R, "active": n_active,
            "tests": tests, "ms": ms, "plain_ms": plain_ms,
            "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "ops_ms": ops / PEAK_F32_FLOPS * 1e3,
        })
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    try:
        from ray_tpu_torch.ops import cuda_build
        from ray_tpu_torch.render.integrator import PassSettings, render_tile
        from ray_tpu_torch.utils.test_scenes import cornell_scene
    except ImportError as e:
        fail(f"cannot import ray_tpu_torch ({e}): run from the repository root")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # ---- build -------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load("trace_brute")
    print(f"build: trace_brute in {time.perf_counter() - t0:.3f} s")

    device = torch.device("cuda")
    settings = PassSettings(max_total_depth=5, min_total_depth=2)

    # ---- kernel parity on the generator scenes ------------------------
    errs = {}
    for n_tris in (8, 24, 40):
        case = generator_case(n_tris, 2_000_000, 1000 + n_tris, device)
        check_parity(case, f"generator {n_tris} tris", errs)
        del case

    # ---- flagship scene; warm-up frame captures the kernel inputs -----
    sc, cam = cornell_scene()
    scene = sc.finalize()
    if scene.device.type != "cuda":
        fail(f"finalize() put the scene on {scene.device}, not CUDA")
    print(f"scene: {scene.num_tris} tris, {scene.bvh_soa['code0'].shape[0]} "
          f"nodes, {scene.num_lights} lights, light tree depth "
          f"{scene.light_tree_depth}")
    _, calls = capture_frame(scene, cam, settings, iteration=1)
    torch.cuda.synchronize()
    if len(calls) != 12:
        fail(f"a flagship frame made {len(calls)} trace calls, expected 12")
    for i, c in enumerate(calls):
        check_parity(c, f"flagship launch {i}", errs)

    # ---- small tile: card vs the port's plain CPU path ----------------
    check_tile_against_cpu(cornell_scene, settings)

    # ---- the main path ------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    rays = 0
    frame_s = []
    t_all = time.perf_counter()
    for f in range(FRAMES):
        t_f = time.perf_counter()
        out = render_tile(
            scene, cam, None, 0, 0, 2 + f, 0, width=WIDTH, height=HEIGHT,
            tile_w=WIDTH, tile_h=HEIGHT, settings=settings,
            use_filter_table=False,
        )
        rays += int(out["rays_traced"])  # synchronises
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t_f)
        color = out["color"]
        if tuple(color.shape) != (WIDTH * HEIGHT, 3):
            fail(f"color has shape {tuple(color.shape)}")
        if not bool(torch.isfinite(color).all()):
            fail("non-finite pixels in the flagship frame")
        if not float(color.mean()) > 0.0:
            fail("the flagship frame is black")
    wall = time.perf_counter() - t_all
    counts = dict(cuda_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    for name in ("trace_brute_closest", "trace_brute_anyhit"):
        if counts.get(name, 0) != 6 * FRAMES:
            fail(f"{name} launched {counts.get(name, 0)} times in "
                 f"{FRAMES} frames, expected {6 * FRAMES}")
    mrays = rays / wall / 1e6
    frame_ms = wall / FRAMES * 1e3
    spread = (max(frame_s) - min(frame_s)) / statistics.fmean(frame_s)
    print(f"flagship fwd 1920x1080 1spp depth5: {mrays:.3f} Mray/s over "
          f"{FRAMES} frames ({rays / FRAMES:.0f} rays/frame), frame "
          f"{frame_ms:.1f} ms (window / frames); frames min "
          f"{min(frame_s) * 1e3:.1f} max {max(frame_s) * 1e3:.1f} ms, "
          f"spread (max - min) / mean {spread:.3f}; "
          f"peak memory {peak / 2**30:.3f} GiB, mean radiance "
          f"{float(color.mean()):.6f} [{card}]")
    print(f"frame ms: {', '.join(f'{s * 1e3:.1f}' for s in frame_s)}")
    print(f"launch counts over {FRAMES} frames: {counts}")

    profile_frame(scene, cam, settings, frame_ms)

    # ---- kernel timing at the frame's launch shapes --------------------
    rows = kernel_timings(calls)
    for r in rows:
        print(f"  launch {'anyhit ' if r['any_hit'] else 'closest'} active "
              f"{r['active']:>8}/{r['rays']} tests {r['tests']:>10}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{max(r['bytes_ms'], r['ops_ms']):.4f} ms "
              f"(bytes {r['bytes_ms']:.4f}, ops {r['ops_ms']:.4f})")
    kernels = []
    for name, any_hit in (("trace_brute_closest", False),
                          ("trace_brute_anyhit", True)):
        rs = [r for r in rows if r["any_hit"] == any_hit]
        # mean over the frame's launches of each launch's own bound
        bound = statistics.fmean(max(r["bytes_ms"], r["ops_ms"]) for r in rs)
        b_ms = statistics.fmean(r["bytes_ms"] for r in rs)
        o_ms = statistics.fmean(r["ops_ms"] for r in rs)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL, "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": statistics.fmean(r["ms"] for r in rs),
            "plain_ms": statistics.fmean(r["plain_ms"] for r in rs),
            "bound_ms": bound,
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def check_tile_against_cpu(cornell_scene, settings):
    """A 64x48 tile of the flagship on the card against the same tile on
    the port's plain CPU path.  The card's transcendentals differ from the
    CPU's by ulps, which rarely flips a Russian-roulette decision — hence
    the per-pixel fraction bounds."""
    import numpy as np

    from ray_tpu_torch.render.integrator import render_tile

    outs = []
    for dev in ("cuda", "cpu"):
        sc, cam = cornell_scene()
        scene = sc.finalize(device=dev)
        o = render_tile(scene, cam, None, 928, 516, 1, 0, width=WIDTH,
                        height=HEIGHT, tile_w=64, tile_h=48,
                        settings=settings, use_filter_table=False)
        outs.append({k: v.cpu().numpy() for k, v in o.items()})
    g, c = outs
    close = np.isclose(g["color"], c["color"], rtol=1e-3, atol=1e-4).all(-1)
    aux = (np.isclose(g["base_color"], c["base_color"], rtol=1e-5, atol=1e-6)
           .all(-1) & np.isclose(g["depth_normal"], c["depth_normal"],
                                 rtol=1e-5, atol=1e-6).all(-1))
    mean_rel = abs(g["color"].mean() - c["color"].mean()) / c["color"].mean()
    rays_rel = abs(int(g["rays_traced"]) - int(c["rays_traced"])) / int(
        c["rays_traced"])
    print(f"tile 64x48 card vs cpu: color close {close.mean():.4f}, aux "
          f"close {aux.mean():.4f}, mean rel diff {mean_rel:.2e}, rays "
          f"{int(g['rays_traced'])} vs {int(c['rays_traced'])}")
    if not (close.mean() >= 0.99 and aux.mean() >= 0.999 and mean_rel < 1e-3
            and rays_rel < 5e-3 and np.isfinite(g["color"]).all()):
        fail("the card's 64x48 tile disagrees with the CPU path")


def profile_frame(scene, cam, settings, frame_ms):
    """One flagship frame under torch.profiler: the device's kernel time and
    its share of an unprofiled frame (``frame_ms``), the op table, and the
    cost of one RNG draw over the frame's lanes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import rng
    from ray_tpu_torch.render.integrator import render_tile

    PROFILE_DIR.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = render_tile(
            scene, cam, None, 0, 0, 99, 0, width=WIDTH, height=HEIGHT,
            tile_w=WIDTH, tile_h=HEIGHT, settings=settings,
            use_filter_table=False,
        )
        int(out["rays_traced"])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    brute_ms = sum(e.time_range.elapsed_us() for e in kernels
                   if "trace_brute" in e.name) / 1e3
    path = PROFILE_DIR / "chip_smoke_profile.txt"
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40))
    seed = torch.arange(WIDTH * HEIGHT, device="cuda", dtype=torch.int64)
    rng_ms = time_launches(lambda: rng.scrambled_2d_rand(7, seed, 0), 10)
    n_rng = 2 + 4 * (settings.max_total_depth + 1)
    print(f"profile: {len(kernels)} kernels, {kern_ms:.1f} ms device time a "
          f"frame ({kern_ms / frame_ms:.3f} of the {frame_ms:.1f} ms "
          f"unprofiled frame); trace_brute {brute_ms:.2f} ms; one "
          f"scrambled_2d_rand over {WIDTH * HEIGHT} lanes {rng_ms:.3f} ms x "
          f"{n_rng} draws a frame = {rng_ms * n_rng:.1f} ms; table in {path}")


if __name__ == "__main__":
    sys.exit(main())
