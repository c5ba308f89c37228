"""Build and load the port's CUDA kernels, and count their launches.

Every kernel is one ``ray_tpu_torch/csrc/<name>.cu`` file with a plain C
entry point.  At its first :func:`load` it is compiled with ``nvcc`` for
``sm_90a`` into ``build/ray_tpu_torch/lib<name>-<hash>.so`` at the
repository root and loaded with ``ctypes``; the file name carries a hash of
the source and the flags, so an edited source is rebuilt.  Nothing is
compiled or loaded when this module is imported.

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


def _build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{r.stdout}{r.stderr}")
    os.replace(tmp, target)
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _LIBS[name] = lib
    return lib
