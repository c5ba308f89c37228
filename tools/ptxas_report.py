#!/usr/bin/env python3
"""Print what ``ptxas -v`` says of the port's trace kernels, of
``radcache_accumulate`` and of the RNG's ``rng_draw``, and count the SASS
instructions of the trace kernels' loops.

    python3 tools/ptxas_report.py [REPO_DIR ...]

For each repository checkout given (default: this one), compiles its
``ray_tpu_torch/csrc/trace_{brute,bvh,tlas,tlas_bin,binned}.cu``,
``radcache_accumulate.cu`` and ``rng_draw.cu`` (those it has) with the
port's own nvcc flags (``ray_tpu_torch/ops/cuda_build.py`` NVCC_FLAGS) plus
``-Xptxas -v`` into ``build/ptxas_report/`` and prints, per kernel entry,
its registers, stack frame, spill stores / loads and shared memory (a
masked instantiation marked "masked").  Then,
from ``cuobjdump -sass`` of ``trace_brute`` and ``trace_bvh``, each loop of
each kernel entry (a backward branch and the instructions from its target
to it): its instruction count, its float instructions (F*: FADD, FMUL,
FSETP, FMNMX, ...), its loads, and the instructions from its head to its
first conditional branch (for the new triangle test, the path of a pair
that the pre-test rejects on U).  Needs ``nvcc`` and ``cuobjdump`` (the
CUDA toolkit).
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCES = ("trace_brute", "trace_bvh", "trace_binned", "trace_tlas",
           "trace_tlas_bin", "radcache_accumulate", "rng_draw")
# the sources whose loops are counted
SASS_SOURCES = ("trace_brute", "trace_bvh")
# one SASS line: /*address*/ [@predicate] OPCODE operands ;
INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _kind(entry: str, name: str) -> str:
    # template <bool kAnyHit[, bool kVis]> mangles as ILb<0|1>E[Lb<0|1>E]E
    m = re.search(r"ILb([01])E(?:Lb([01])E)?E", entry)
    if "sort_key" in entry:
        return "binned_sort_key"
    if "radcache_accumulate" in entry:
        return "radcache_accumulate"
    if "scrambled_2d_rand_kernel" in entry:
        return "rng_draw scrambled_2d_rand"
    if "pixel_seed_kernel" in entry:
        return "rng_draw pixel_seed"
    if m is None:
        return entry
    kind = f"{name} {'any-hit' if m.group(1) == '1' else 'closest'}"
    return kind + (" masked" if m.group(2) == "1" else "")


def build(repo: pathlib.Path, out_dir: pathlib.Path, names):
    """{name: (ptxas log, library path)} of ``repo``'s sources ``names``."""
    from ray_tpu_torch.ops import cuda_build

    jobs = []
    for name in names:
        src = repo / "ray_tpu_torch" / "csrc" / f"{name}.cu"
        target = out_dir / f"{repo.name}-{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(target), str(src)]
        jobs.append((name, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for name, target, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {repo}/{name}.cu:\n{out}")
        built[name] = (out, target)
    return built


def ptxas_lines(repo, name, log) -> list[str]:
    lines = []
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            entry = m.group(1)
            continue
        if entry and ("stack frame" in line or "Used" in line):
            lines.append(f"{repo}: {_kind(entry, name)}: {line.strip()}")
    return lines


def sass_loops(repo, name, lib) -> list[str]:
    """One line a loop of each kernel entry of ``lib``'s SASS."""
    from ray_tpu_torch.ops import cuda_build

    cuobjdump = pathlib.Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    lines = []
    for block in sass.split("Function : ")[1:]:
        entry = block.split()[0]
        if "kernel" not in entry:
            continue
        insns = [(int(m.group(1), 16), m.group(2) or "", m.group(3),
                  m.group(4)) for m in INSN.finditer(block)]
        addr = [a for a, *_ in insns]
        for i, (a, pred, op, rest) in enumerate(insns):
            t = re.search(r"0x([0-9a-f]+)", rest)
            if not (op.startswith("BRA") and t):
                continue
            target = int(t.group(1), 16)
            if target > a or target not in addr:
                continue
            body = insns[addr.index(target):i + 1]
            first = next((j for j, (_, p, o, _) in enumerate(body)
                          if p and o.startswith("BRA")), len(body) - 1)
            lines.append(
                f"{repo}: {_kind(entry, name)}: loop {target:#06x}-{a:#06x}: "
                f"{len(body)} instructions, "
                f"{sum(o.startswith('F') for _, _, o, _ in body)} float, "
                f"{sum(o.startswith(('LD', 'ULD')) for _, _, o, _ in body)} "
                f"loads; {first + 1} to its first conditional branch")
    return lines


def main() -> int:
    repos = [pathlib.Path(p).resolve() for p in sys.argv[1:]] or [ROOT]
    out_dir = ROOT / "build" / "ptxas_report"
    out_dir.mkdir(parents=True, exist_ok=True)
    for repo in repos:
        built = build(repo, out_dir, [n for n in SOURCES if (
            repo / "ray_tpu_torch" / "csrc" / f"{n}.cu").exists()])
        for name, (log, _) in built.items():
            for line in ptxas_lines(repo, name, log):
                print(line)
        for name in SASS_SOURCES:
            for line in sass_loops(repo, name, built[name][1]):
                print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
