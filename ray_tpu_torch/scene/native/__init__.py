"""The native (C++) BVH2 and SBVH builders, for scenes of 8,192 primitives
and more.

A port of ``ray_tpu.scene.native``.  At its first use
``bvh_builder.cpp`` (a copy of ``ray_tpu``'s) is compiled with g++ —
``ray_tpu``'s flags, ``-O3 -march=native -shared -fPIC``, which let g++
contract multiplies and adds, so the same flags on the same machine give
the same nodes as ``ray_tpu`` — into
``build/ray_tpu_torch/libbvh_builder-<hash>.so`` at the repository root,
named after a hash of the source and the flags, and loaded with ``ctypes``.
A failed compile raises with g++'s message: unlike ``ray_tpu``, the port
never falls back to the numpy builder silently.  The one failure a caller
may catch is :class:`NativeCapacityError`: the SBVH ran out of the
reference slots it was given, which ``build_bvh2(use_native="auto")``
answers with the numpy SBVH, as ``ray_tpu`` does.
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
        fs = lib.ray_tpu_build_sbvh
        fs.restype = ctypes.c_int
        # tri_lo, tri_hi, tri_verts (nullable), n, max_leaf, fat_leaves,
        # child_lo, child_hi, child, counts, prim_indices, root_lo, root_hi,
        # node_capacity, ref_capacity, out_n_refs
        fs.argtypes = [f32, f32, f32, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, f32, f32, i32, i32, i32, f32, f32,
                       ctypes.c_int, ctypes.c_int, i32]
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the native builder builds and loads here.  The builders
    themselves raise the build's error instead."""
    try:
        _load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


class NativeCapacityError(RuntimeError):
    """The C++ builder ran but its output capacity was exceeded (it returns
    -1): distinct from a builder that cannot be built, so that
    ``use_native="auto"`` can fall back on it alone."""


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


def build_sbvh_native(tri_lo: np.ndarray, tri_hi: np.ndarray,
                      tri_verts: np.ndarray | None, max_leaf: int,
                      fat_leaves: bool = False,
                      max_refs_factor: float = 1.75):
    """The C++ SBVH: the numpy ``_build_sbvh``'s split logic with spatial
    reference splits.  Returns the :func:`build_bvh2_native` tuple, whose
    ``prim_indices`` holds duplicated references; raises
    :class:`NativeCapacityError` when the references or node slots
    overflow ``max_refs_factor`` x n + 64."""
    lib = _load()
    n = tri_lo.shape[0]
    ref_cap = int(n * max_refs_factor) + 64
    cap = max(ref_cap, 2)
    tri_lo = np.ascontiguousarray(tri_lo, np.float32)
    tri_hi = np.ascontiguousarray(tri_hi, np.float32)
    child_lo = np.zeros((cap, 2, 3), np.float32)
    child_hi = np.zeros((cap, 2, 3), np.float32)
    child = np.zeros((cap, 2), np.int32)
    counts = np.zeros((cap, 2), np.int32)
    prim = np.zeros((ref_cap,), np.int32)
    root_lo = np.zeros(3, np.float32)
    root_hi = np.zeros(3, np.float32)
    n_refs = np.zeros(1, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    if tri_verts is not None:
        tri_verts = np.ascontiguousarray(tri_verts.reshape(n, 9), np.float32)
        vp = ptr(tri_verts, ctypes.c_float)
    else:
        vp = ctypes.POINTER(ctypes.c_float)()
    n_slots = lib.ray_tpu_build_sbvh(
        ptr(tri_lo, ctypes.c_float), ptr(tri_hi, ctypes.c_float), vp,
        n, max_leaf, int(bool(fat_leaves)),
        ptr(child_lo, ctypes.c_float), ptr(child_hi, ctypes.c_float),
        ptr(child, ctypes.c_int32), ptr(counts, ctypes.c_int32),
        ptr(prim, ctypes.c_int32),
        ptr(root_lo, ctypes.c_float), ptr(root_hi, ctypes.c_float),
        cap, ref_cap, ptr(n_refs, ctypes.c_int32),
    )
    if n_slots < 0:
        raise NativeCapacityError(
            f"native SBVH ref/slot capacity exceeded (n={n}, "
            f"ref_cap={ref_cap}); raise max_refs_factor")
    return (
        child_lo[:n_slots].copy(), child_hi[:n_slots].copy(),
        child[:n_slots].copy(), counts[:n_slots].copy(),
        prim[:int(n_refs[0])].copy(), root_lo, root_hi,
    )
