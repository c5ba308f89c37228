"""One run of one cell: set-up, the measured window, the check, the result.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness finds everything by those names:

* ``configs/<config>.json``: the configuration as it is run (frame size,
  pass and render settings, finalize options) and ``configs/<config>.py``,
  its scene generator, which builds the scene through a package's scene
  API;
* ``traffic/<traffic>.json``: the mix's parameters, and under ``loop`` the
  name of its loop;
* ``loops/<loop>.py``: set-up, the measured window and the check of a
  loop (``run(run)``), and its control (``control(run)``);
* ``limits/<cell>.json``: the limit of each number the check compares;
* ``metrics/<metric>.py``: one reader a metric, end-to-end or per-layer,
  with ``read(run)`` returning the value or None.

Only ``ray_tpu_torch`` is the program.  The reference (:mod:`rtbench.ref`)
and everything else here import nothing of it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import pathlib
import statistics
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "rtbench"
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def scene_module(self):
        return load_module(ROOT / self.config["scene"],
                           f"rtbench_scene_{self.config['name']}")

    def loop(self):
        name = self.traffic["loop"]
        return load_module(HERE / "loops" / f"{name}.py",
                           f"rtbench_loop_{name}")


def resolve_cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of a parsed ``BENCHMARK.json``, with its files read."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_file).read_text())
    traffic = json.loads(
        (root / "rtbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "rtbench" / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def scene_api(package: str):
    """The scene API a generator builds through: the port's
    (``"ray_tpu_torch"``) or the reference's (``"rtbench.ref"``)."""
    scene = importlib.import_module(f"{package}.scene.scene")
    mats = importlib.import_module(f"{package}.scene.materials")
    lights = importlib.import_module(f"{package}.scene.lights")
    camera = importlib.import_module(f"{package}.scene.camera")
    return types.SimpleNamespace(
        Scene=scene.Scene, MaterialDesc=mats.MaterialDesc,
        ShadingNode=mats.ShadingNode, LightDesc=lights.LightDesc,
        LightType=lights.LightType, make_camera=camera.make_camera)


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers take it."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    width: int
    height: int
    t_start: float
    finalize_s: float = 0.0
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                  # samples or steps completed
    unit_s: list = dataclasses.field(default_factory=list)
    rays: int = 0
    peak_bytes: int = 0
    window: object = None           # devtrace.WindowTrace of a traced run
    trace_calls: object = None      # devtrace.TraceCalls of a traced run
    traced_from: int = 0            # unit_s[traced_from:] were traced
    traced_units: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    readings: dict = dataclasses.field(default_factory=dict)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one the runs may not hold."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def check_card(chips: int) -> str | None:
    """None where this host has ``chips`` CUDA cards, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA card: the benchmark runs only on the card"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA cards, this host has "
                f"{torch.cuda.device_count()}")
    return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, size=None) -> Run:
    """Set-up, window and check of one cell on ``device``.  ``size``
    (width, height) replaces the configuration's frame in the tests."""
    w, h = size if size is not None else (cell.config["width"],
                                          cell.config["height"])
    run = Run(cell=cell, seed=int(seed), seconds=float(seconds),
              trace=bool(trace), device=device, width=w, height=h,
              t_start=t_start)
    cell.loop().run(run)
    return run


def read_metric(run: Run, name: str):
    reader = load_module(HERE / "metrics" / f"{name}.py",
                         "rtbench_metric_" + name.replace(".", "_"))
    return reader.read(run)


def per_layer_values(run: Run) -> dict:
    """The cell's per-layer metrics that found something to read."""
    out = {}
    for m in run.cell.per_layer:
        v = read_metric(run, m["name"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def end_to_end_values(run: Run) -> dict:
    """The cell's end-to-end metrics, every one of them."""
    out = {}
    for m in run.cell.end_to_end:
        v = read_metric(run, m["name"])
        if v is None:
            raise RuntimeError(f"{m['name']} read nothing in {run.cell.name}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def correct(run: Run) -> bool:
    return all(v["value"] <= v["limit"] for v in run.checks.values())


def result_line(run: Run) -> dict:
    import torch

    dev = run.device
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": run.cell.chips,
        "memory_peak_bytes": int(run.peak_bytes),
    }
    line = {"correct": correct(run), "attempted": run.units,
            "failed": 0, "metrics": None, "device": device}
    if not run.trace:
        line["metrics"] = end_to_end_values(run)
    else:
        line["metrics"] = per_layer_values(run)
        device["busy_s"] = run.window.busy_s()
        device["window_s"] = run.window.window_s
        line["breakdown"] = {
            "device_ops": run.window.device_ops_breakdown(),
            "idle_gaps": run.window.idle_breakdown(),
        }
    line["checks"] = run.checks
    return line


def _quartiles(xs):
    return [] if len(xs) < 2 else statistics.quantiles(xs, n=4)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = resolve_cell(bench, args.workload)
    why = check_card(cell.chips)
    if why is not None:
        print(f"rtbench: {why}", file=sys.stderr)
        return 2
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"rtbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(run)
    gc.collect()
    print(f"rtbench: {run.cell.name} seed {run.seed}: set-up "
          f"{run.setup_s:.3f} s (finalize {run.finalize_s:.3f} s), "
          f"{run.units} in {run.window_s:.3f} s (quartiles "
          f"{[round(1e3 * q, 1) for q in _quartiles(run.unit_s)]} ms), check "
          f"{run.readings.get('check_s', 0.0):.3f} s", file=sys.stderr)
    for k, v in run.checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0
