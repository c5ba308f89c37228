"""The per-lane table gather of ``scripts/test_pallas_gather.py``.

That script's ``try_kernel`` (its ``pl.pallas_call`` with the bodies
``k_take``, ``k_index`` and ``k_take_along``) is a compiler probe: it asks
whether Mosaic lowers a per-lane gather from VMEM on a TPU.  All three
bodies compute ``out = table.reshape(-1)[idx]`` for a float32 table of
shape (N,) or (1, N) and an int32 index.  No path of the renderer runs it,
in ``ray_tpu`` or here; the port carries it as ``csrc/gather_table.cu`` so
that every TPU kernel of the repository has a counterpart on the card.

:func:`gather_table` is the wrapper: on a CPU tensor it runs
:func:`gather_table_plain`; on a CUDA tensor it launches the kernel or
raises.  It validates on every device, since the kernel range-checks
nothing.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import cuda_build

# the index is int32, so no table longer than this can be addressed
MAX_TABLE = 2**31 - 1


def gather_table_plain(table, idx):
    """``table.reshape(-1)[idx]``: the plain PyTorch version."""
    return table.reshape(-1)[idx.long()]


def _validate(table, idx):
    for name, x in (("table", table), ("idx", idx)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_table runs on CPU or CUDA, not "
                         f"{table.device}")
    if table.dtype != torch.float32:
        raise TypeError(f"table has dtype {table.dtype}, expected float32")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx has dtype {idx.dtype}, expected int32")
    if not (table.dim() == 1 or (table.dim() == 2 and table.shape[0] == 1)):
        raise ValueError(f"table has shape {tuple(table.shape)}, expected "
                         f"(N,) or (1, N)")
    n = table.numel()
    if not 1 <= n <= MAX_TABLE:
        raise ValueError(f"table has {n} entries, expected 1 to {MAX_TABLE}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"idx holds entries outside [0, {n})")


def gather_table(table, idx):
    """``out[...] = table.reshape(-1)[idx[...]]``: ``table`` float32 of
    shape (N,) or (1, N), ``idx`` int32 of any shape with entries in [0,
    N), both contiguous on one device.  Returns float32 of ``idx``'s shape.
    The 32-bit words are copied, NaN payloads and -0 included."""
    _validate(table, idx)
    if table.device.type == "cpu":
        return gather_table_plain(table, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    if idx.numel() == 0:
        return out
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = _gather_fn()(table.data_ptr(), table.numel(), idx.data_ptr(),
                           idx.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gather_table kernel launch failed: CUDA error "
                           f"{err}")
    cuda_build.launch_counts["gather_table"] += 1
    return out


def _gather_fn():
    fn = cuda_build.load("gather_table").gather_table_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int64, p, ctypes.c_int64, p, p]
        fn.restype = ctypes.c_int
    return fn
