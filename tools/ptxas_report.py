#!/usr/bin/env python3
"""Print what ``ptxas -v`` says of the port's trace kernels.

    python3 tools/ptxas_report.py [REPO_DIR ...]

For each repository checkout given (default: this one), compiles its
``ray_tpu_torch/csrc/trace_binned.cu`` and ``trace_tlas.cu`` with the
port's own nvcc flags (``ray_tpu_torch/ops/cuda_build.py`` NVCC_FLAGS) plus
``-Xptxas -v`` into ``build/ptxas_report/`` and prints, per kernel entry,
its registers, stack frame, spill stores / loads and shared memory.  Needs
``nvcc`` (the CUDA toolkit).
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCES = ("trace_binned", "trace_tlas")


def report(repo: pathlib.Path, out_dir: pathlib.Path) -> list[str]:
    from ray_tpu_torch.ops import cuda_build

    lines = []
    jobs = []
    for name in SOURCES:
        src = repo / "ray_tpu_torch" / "csrc" / f"{name}.cu"
        target = out_dir / f"{repo.name}-{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(target), str(src)]
        jobs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    for name, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {repo}/{name}.cu:\n{out}")
        entry = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            m = re.search(r"Function properties for (\w+)", line)
            if m:
                entry = m.group(1)
                continue
            if entry and ("stack frame" in line or "Used" in line):
                kind = ("binned_sort_key" if "sort_key" in entry
                        else f"{name} any-hit" if "ILb1E" in entry
                        else f"{name} closest" if "ILb0E" in entry
                        else entry)
                lines.append(f"{repo}: {kind}: {line.strip()}")
    return lines


def main() -> int:
    repos = [pathlib.Path(p).resolve() for p in sys.argv[1:]] or [ROOT]
    out_dir = ROOT / "build" / "ptxas_report"
    out_dir.mkdir(parents=True, exist_ok=True)
    for repo in repos:
        for line in report(repo, out_dir):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
