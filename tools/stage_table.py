#!/usr/bin/env python3
"""Where a render cell's sample spends its time, stage by stage, and what
the port's spans cost.  Runs on the CUDA card at the cell's own size.

    python3 tools/stage_table.py --workload flagship.render [--seed N]
        [--samples 6] [--cost-pairs 20] [--out FILE]

Sets the cell up through the benchmark's own code (``rtbench/harness.py``
finds the cell, ``rtbench/window.py`` finalizes its scene, the render
loop's ``render_settings`` refuses what its check cannot follow), warms
up ``warmup_samples`` and clears the renderer as ``rtbench/loops/
render.py`` does, then:

1. the spans' cost: ``--cost-pairs`` pairs of untraced samples, one with
   tracing off and one with ``trace.recording()`` on (off first in even
   pairs), each sample synchronised; the median and mean sample of each
   side;
2. a traced window of ``--samples`` samples under ``torch.profiler``
   (``rtbench/devtrace.py``, CUDA activity only) reduced by
   ``rtbench/stages.py``: for each program span, the device ms its
   launches took, their number and the device's idle ms whose gap
   midpoint falls in it, the copies it launched and the host's waits for
   the device inside it (``WAITS``), each a sample; the waits that lie in
   no ``rt.sync.*`` span, by call and span (the window's own
   per-sample synchronise is one ``cudaDeviceSynchronize`` a sample in no
   span); whether launches and operations paired, the stage sums against
   the window's device-op time, and the spans holding each ``trace_*``
   kernel.

Prints the table and writes it as JSON to ``--out``.  Without a card it
exits with 2.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the host calls that wait for the device
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def build(cell_name, seed, device):
    """A sample function of the cell's renderer, set up and warmed up as
    the render loop does."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.render.integrator import PassSettings
    from rtbench import harness, window

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve_cell(bench, cell_name)
    if cell.traffic["loop"] != "render":
        raise SystemExit(f"stage_table: {cell_name} is not a render cell")
    cfg = cell.config
    run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=device, width=cfg["width"],
                      height=cfg["height"], t_start=time.perf_counter())
    sc, cam = cell.scene_module().scene(harness.scene_api("ray_tpu_torch"))
    scene = window.finalize(run, sc)
    renderer = rt.create_renderer(
        rt.RenderSettings(width=run.width, height=run.height,
                          **cell.loop().render_settings(run)),
        PassSettings(**cfg["pass_settings"]), enabled_types=("gpu",))
    for _ in range(int(cell.traffic["warmup_samples"])):
        renderer.render_sample(scene, cam, seed)
    renderer.clear()

    def sample():
        t0 = time.perf_counter()
        renderer.render_sample(scene, cam, seed)
        window.sync(device)
        return time.perf_counter() - t0

    return sample


def span_cost(sample, pairs):
    from ray_tpu_torch.utils import trace

    times = {"off": [], "on": []}
    for r in range(pairs):
        for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
            if side == "on":
                with trace.recording():
                    times[side].append(sample())
                trace.clear()
            else:
                times[side].append(sample())
    return {k: {"median_ms": 1e3 * statistics.median(v),
                "mean_ms": 1e3 * statistics.fmean(v), "n": len(v)}
            for k, v in times.items()}


def stage_table(sample, n, device):
    from ray_tpu_torch.utils import trace
    from rtbench import devtrace, stages

    trace.clear()
    dw = devtrace.DeviceWindow(device)
    dw.start()
    for _ in range(n):
        sample()
    win = dw.stop()
    host_names = collections.Counter(h[0] for h in win.host_ops)
    launches = sum(v for k, v in host_names.items() if k in stages.LAUNCHES)
    out = {"samples": n, "launch_calls": launches, "device_ops": len(win.ops),
           "host_op_names": host_names.most_common(25)}
    att = stages.attribution(win)
    idle = stages.idle_by_span(win) or {}
    if att is None:
        kinds = collections.Counter(stages.LAUNCHES[h[0]] for h in win.host_ops
                                    if h[0] in stages.LAUNCHES)
        out.update(paired=False,
                   spans=len(stages.program_spans(win) or []),
                   launches_by_kind=dict(kinds),
                   ops_by_kind=dict(collections.Counter(o[3] for o in win.ops)))
        return out
    op_s = sum(e - s for _, s, e, _ in win.ops)
    timeline = stages.innermost(stages.program_spans(win))
    pairs = stages.match(win)
    labels = stages.label_at(timeline, [t for t, _ in pairs])
    copies = collections.Counter(str(lab) for lab, (_, op) in zip(labels, pairs)
                                 if op[3] == "memcpy")
    waits = [h for h in win.host_ops if h[0] in WAITS]
    wait_spans = [str(lab) for lab in
                  stages.label_at(timeline, [h[1] for h in waits])]
    outside = collections.Counter(
        f"{h[0]} in {lab}" for h, lab in zip(waits, wait_spans)
        if not lab.startswith(stages.SYNC_PREFIX))
    waits = collections.Counter(wait_spans)
    rows = {}
    for name in sorted(set(att) | set(idle), key=lambda k: (k is None, k)):
        dev_s, count = att.get(name, (0.0, 0))
        rows[str(name)] = {"device_ms": 1e3 * dev_s / n,
                           "launches": count / n,
                           "idle_ms": 1e3 * idle.get(name, 0.0) / n,
                           "copies": copies[str(name)] / n,
                           "waits": waits[str(name)] / n}
    trace_spans = collections.Counter(
        str(lab) for lab, (_, op) in zip(labels, pairs)
        if op[3] == "kernel" and "trace_" in op[0])
    out.update(paired=True, rows=rows, device_op_ms=1e3 * op_s / n,
               busy_ms=1e3 * win.busy_s() / n,
               window_ms=1e3 * win.window_s / n,
               attributed_sum_gap=abs(sum(v[0] for v in att.values()) - op_s)
               / op_s,
               waits_outside_sync_spans={k: v / n for k, v in outside.items()},
               trace_kernel_spans=dict(trace_spans))
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=3_000_000_017)
    p.add_argument("--samples", type=int, default=6)
    p.add_argument("--cost-pairs", type=int, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_table: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    sample = build(args.workload, args.seed, device)
    res = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device),
           "torch": torch.__version__}
    if args.cost_pairs:
        res["cost"] = span_cost(sample, args.cost_pairs)
    res["stages"] = stage_table(sample, args.samples, device)
    st = res["stages"]
    print(f"{args.workload} on {res['device']}, torch {res['torch']}")
    if "cost" in res:
        c = res["cost"]
        print(f"sample ms, tracing off: median {c['off']['median_ms']:.3f} "
              f"mean {c['off']['mean_ms']:.3f}; recording on: median "
              f"{c['on']['median_ms']:.3f} mean {c['on']['mean_ms']:.3f} "
              f"(n {c['on']['n']} each)")
    print(f"launch calls {st['launch_calls']}, device ops {st['device_ops']}, "
          f"paired {st['paired']}")
    if st["paired"]:
        print(f"a sample: device ops {st['device_op_ms']:.3f} ms, busy "
              f"{st['busy_ms']:.3f} ms, window {st['window_ms']:.3f} ms; "
              f"stage sums vs device-op time {st['attributed_sum_gap']:.2e}")
        print(f"{'span':24s} {'device ms':>10s} {'launches':>10s} "
              f"{'idle ms':>10s} {'copies':>7s} {'waits':>7s}")
        for name, r in st["rows"].items():
            print(f"{name:24s} {r['device_ms']:10.3f} {r['launches']:10.1f} "
                  f"{r['idle_ms']:10.3f} {r['copies']:7.1f} "
                  f"{r['waits']:7.1f}")
        print(f"waits outside rt.sync.* a sample: "
              f"{st['waits_outside_sync_spans']}")
        print(f"trace_* kernels by span: {st['trace_kernel_spans']}")
    else:
        print(f"host ops: {st['host_op_names']}; spans {st['spans']}; "
              f"launches by kind {st['launches_by_kind']}, operations "
              f"{st['ops_by_kind']}")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
