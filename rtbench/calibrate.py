"""Readings the check's limits are set from, on the card at a cell's size:

    python3 rtbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 [--control-seeds 4,5,6] [--faults 7,8,9]

For each of ``--seeds``, one sound run of the cell (its window and its
check), in one process.  For each of ``--control-seeds``, a sound run and
then the control in the program's place: the reference with its path
state in bfloat16, judged against the same float32 reference.  With
``--faults`` (training cells), each planted fault of :mod:`rtbench.faults`
on each of those seeds, with a window of one step.  One JSON line each,
with every number compared.  Not run by the benchmark itself."""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from rtbench import faults, harness  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _line(kind, seed, run, checks, steps=True):
    got, ref = run.readings.get("got_rays", []), run.readings["ref"]
    print(json.dumps({
        "kind": kind, "seed": seed, "units": run.units,
        "checks": {k: v["value"] for k, v in checks.items()},
        "check_s": run.readings.get("check_s"), "frame_s": ref.get("frame_s"),
        # each step's forward rays, program minus reference (train cells)
        "step_rays_gaps": ([a - b for a, b in zip(got, ref.get("rays", []))]
                           if steps else None)}), flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    a = p.parse_args()
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve_cell(bench, a.workload)
    why = harness.check_card(cell.chips)
    if why:
        sys.exit(f"calibrate: {why}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def sound(seed, seconds):
        run = harness.run_cell(cell, seed, seconds, False, dev,
                               time.perf_counter())
        _line("sound", seed, run, run.checks)
        return run

    for seed in _seeds(a.seeds):
        sound(seed, a.seconds)
    for seed in _seeds(a.control_seeds):
        run = sound(seed, a.seconds)
        _line("control", seed, run, cell.loop().control(run), steps=False)
    for seed in _seeds(a.faults):
        for name, fault in faults.FAULTS.items():
            with fault():
                run = harness.run_cell(cell, seed, 0.01, False, dev,
                                       time.perf_counter())
            _line("fault:" + name, seed, run, run.checks)


if __name__ == "__main__":
    main()
