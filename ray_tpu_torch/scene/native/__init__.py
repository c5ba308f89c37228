"""The native (C++) BVH2 builder, for scenes of 8,192 primitives and more.

A port of ``ray_tpu.scene.native``'s BVH2 part.  At its first use
``bvh_builder.cpp`` (a copy of ``ray_tpu``'s) is compiled with g++ —
``ray_tpu``'s flags, ``-O3 -march=native -shared -fPIC``, which let g++
contract multiplies and adds, so the same flags on the same machine give
the same nodes as ``ray_tpu`` — into
``build/ray_tpu_torch/libbvh_builder-<hash>.so`` at the repository root,
named after a hash of the source and the flags, and loaded with ``ctypes``.
A failed compile raises with g++'s message: unlike ``ray_tpu``, the port
never falls back to the numpy builder silently.  The SBVH entry point is
not bound (ROADMAP Queue 1 item 18).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "ray_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def _target() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libbvh_builder-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = _target()
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                               capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build the native BVH builder:\n"
                    f"{r.stdout}{r.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        f32 = ctypes.POINTER(ctypes.c_float)
        i32 = ctypes.POINTER(ctypes.c_int32)
        fn = lib.ray_tpu_build_bvh2
        fn.restype = ctypes.c_int
        fn.argtypes = [f32, f32, ctypes.c_int, ctypes.c_int, f32, f32, i32,
                       i32, i32, f32, f32, ctypes.c_int, ctypes.c_int]
        _LIB = lib
        return lib


def build_bvh2_native(tri_lo: np.ndarray, tri_hi: np.ndarray, max_leaf: int,
                      fat_leaves: bool = False):
    """Run the C++ builder.  Returns ``(child_lo, child_hi, child, counts,
    prim_indices, root_lo, root_hi)``, the fields of
    :class:`ray_tpu_torch.scene.bvh.BVH2`."""
    lib = _load()
    n = tri_lo.shape[0]
    cap = max(n, 2)
    tri_lo = np.ascontiguousarray(tri_lo, np.float32)
    tri_hi = np.ascontiguousarray(tri_hi, np.float32)
    child_lo = np.zeros((cap, 2, 3), np.float32)
    child_hi = np.zeros((cap, 2, 3), np.float32)
    child = np.zeros((cap, 2), np.int32)
    counts = np.zeros((cap, 2), np.int32)
    prim = np.zeros((n,), np.int32)
    root_lo = np.zeros(3, np.float32)
    root_hi = np.zeros(3, np.float32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n_slots = lib.ray_tpu_build_bvh2(
        ptr(tri_lo, ctypes.c_float), ptr(tri_hi, ctypes.c_float),
        n, max_leaf,
        ptr(child_lo, ctypes.c_float), ptr(child_hi, ctypes.c_float),
        ptr(child, ctypes.c_int32), ptr(counts, ctypes.c_int32),
        ptr(prim, ctypes.c_int32),
        ptr(root_lo, ctypes.c_float), ptr(root_hi, ctypes.c_float),
        cap, int(bool(fat_leaves)),
    )
    if n_slots < 0:
        raise RuntimeError(f"the native BVH builder ran out of node slots "
                           f"({cap} for {n} primitives)")
    return (
        child_lo[:n_slots].copy(), child_hi[:n_slots].copy(),
        child[:n_slots].copy(), counts[:n_slots].copy(),
        prim, root_lo, root_hi,
    )
