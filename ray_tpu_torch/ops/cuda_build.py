"""Build and load the port's CUDA kernels, and count their launches.

Every kernel is one ``ray_tpu_torch/csrc/<name>.cu`` file with a plain C
entry point (and the ``csrc/*.cuh`` headers it includes).  At its first
:func:`load` (or in :func:`build`, which starts one ``nvcc`` per source at
once) it is compiled with ``nvcc`` for ``sm_90a`` into
``build/ray_tpu_torch/lib<name>-<hash>.so`` at the repository root and
loaded with ``ctypes``; the file name carries a hash of the source, of
every ``csrc/*.cuh`` header and of the flags, so an edited source or
header is rebuilt.  Nothing is compiled or loaded when this module is
imported.

Flags: IEEE float32 everywhere (``-fmad=false -prec-div=true
-prec-sqrt=true``, never ``--use_fast_math``) — what makes each kernel
bit-equal to its plain PyTorch version.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC",
)

# launches per kernel wrapper; each wrapper adds one where it launches
launch_counts: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIBS: dict = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def source_hash(csrc: pathlib.Path, name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every header in ``csrc`` and the flags:
    an edited source or header gives a new library name."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{source_hash(CSRC, name)}.so"


def build(names) -> None:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet: one
    ``nvcc`` per source, all started together."""
    jobs = []
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, target, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}{err}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
    return lib
