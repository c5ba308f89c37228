"""What the traced run records: the device trace of a window and the
traversal launches' inputs.

``TraceCalls`` wraps the port's traversal entry points
(``ray_tpu_torch.ops.traverse.trace_brute``, ``trace_bvh``,
``trace_tlas``, ``trace_tlas_bin``, ``trace_binned``) for the traced
window: each call's lanes and table bytes, and its ``active`` mask, whose
lanes are counted after the window so that the window launches no kernel
of the benchmark's.  The byte bound is then worked out from what was
asked of the traversal, whichever kernel serves it.

``DeviceWindow`` runs ``torch.profiler`` over the window and reduces its
events: device operations (kernels, copies, fills) by name and interval,
the host's CUDA calls that were running in the device's idle gaps, and the
host spans that the loops mark with its ``spans``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from rtbench import yardstick

TRAVERSE_ENTRIES = {
    # entry point: its number of leading table arguments
    "trace_brute": 1,
    "trace_bvh": 2,
    "trace_tlas": 1,
    "trace_tlas_bin": 3,
    "trace_binned": 1,
}


def _table_bytes(tables) -> int:
    n = 0
    for t in tables:
        if isinstance(t, dict):
            n += sum(4 * v.numel() for v in t.values()
                     if isinstance(v, torch.Tensor))
        elif isinstance(t, torch.Tensor):
            n += 4 * t.numel()
    return n


@dataclasses.dataclass
class TraceCall:
    kernel: str
    lanes: int
    table_bytes: int
    has_ray_mask: bool
    active: torch.Tensor


class TraceCalls:
    """Context manager: records every traversal call made inside it."""

    def __init__(self):
        self.calls: list[TraceCall] = []
        self._saved = {}

    def __enter__(self):
        from ray_tpu_torch.ops import traverse

        for name, n_tables in TRAVERSE_ENTRIES.items():
            fn = getattr(traverse, name)
            self._saved[name] = fn
            setattr(traverse, name, self._wrap(name, n_tables, fn))
        return self

    def __exit__(self, *exc):
        from ray_tpu_torch.ops import traverse

        for name, fn in self._saved.items():
            setattr(traverse, name, fn)
        self._saved.clear()
        return False

    def _wrap(self, name, n_tables, fn):
        def wrapped(*args, **kwargs):
            tables = args[:n_tables]
            ro, active = args[n_tables], args[n_tables + 4]
            if name == "trace_tlas":
                # (rows, winst_base, ro, rd, t_min, t_max, active, ray_mask)
                ro, active = args[2], args[6]
                mask = args[7] if len(args) > 7 else kwargs.get("ray_mask")
            elif name == "trace_tlas_bin":
                mask = args[8] if len(args) > 8 else kwargs.get("ray_mask")
            elif name == "trace_bvh":
                mask = kwargs.get("ray_mask")
                if kwargs.get("tri_vis") is not None:
                    tables = (*tables, kwargs["tri_vis"])
            else:
                mask = None
            self.calls.append(TraceCall(
                kernel=name, lanes=int(ro.shape[0]),
                table_bytes=_table_bytes(tables),
                has_ray_mask=mask is not None, active=active))
            return fn(*args, **kwargs)
        return wrapped

    def bound_seconds(self) -> float:
        """Σ over the recorded calls of the byte-bound time."""
        total = 0
        for c in self.calls:
            total += yardstick.launch_bytes(
                c.kernel, c.lanes, int(c.active.sum()), c.table_bytes,
                c.has_ray_mask)
        return yardstick.bound_seconds(total)


class Spans:
    """Host spans by name, on the profiler's clock (Unix time): a traced
    loop brackets a stage with ``with spans("name"):``."""

    def __init__(self):
        self.data: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        s = time.time_ns()
        try:
            yield
        finally:
            self.data.setdefault(name, []).append(
                (s * 1e-9, time.time_ns() * 1e-9))


@dataclasses.dataclass
class WindowTrace:
    """The reduced trace of one window (seconds on the profiler's clock)."""

    start: float
    end: float
    ops: list            # (name, start, end, kind): device operations
    spans: dict          # span name -> [(start, end)] host spans
    host_ops: list       # (name, start, end) host operations, no spans

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self):
        return [o for o in self.ops if o[3] == "kernel"]

    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran."""
        return yardstick.union_seconds([(s, e) for _, s, e, _ in self.ops],
                                       self.start, self.end)

    def device_ops_breakdown(self, top: int = 10):
        """Device seconds by operation name (the first 200 characters of
        a kernel's name: PyTorch's are whole template signatures)."""
        by = {}
        for name, s, e, _ in self.ops:
            by[name[:200]] = by.get(name[:200], 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_breakdown(self, top: int = 10):
        """Idle seconds of the device, summed by the innermost host CUDA
        call running at each gap's midpoint ("python" where none was: the
        host between calls)."""
        gaps = yardstick.idle_gaps([(s, e) for _, s, e, _ in self.ops],
                                   self.start, self.end)
        if not gaps:
            return []
        names = [h[0] for h in self.host_ops]
        hs = np.array([h[1] for h in self.host_ops] or [0.0])
        he = np.array([h[2] for h in self.host_ops] or [0.0])
        by = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(inside) and self.host_ops:
                k = inside[np.argmin(he[inside] - hs[inside])]
                name = names[k]
            else:
                name = "python"
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def _kind(ev) -> str | None:
    """kernel / memcpy / memset for a device operation, else None (host
    events and the device side of the spans)."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA \
            or ev.is_user_annotation():
        return None
    name = ev.name()
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class DeviceWindow:
    """Profiles the device between ``start()`` and ``stop()``.  Only the
    device's activity is recorded (the CUDA calls on the host, the
    operations on the device), which slows the host's launches less than
    recording every PyTorch operation; the window is the host interval
    between the two calls, read on the profiler's clock (Unix time)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.spans = Spans()
        self._prof = None
        self._t0 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        act = (ProfilerActivity.CUDA if self.device.type == "cuda"
               else ProfilerActivity.CPU)
        self._prof = profile(activities=[act], record_shapes=False,
                             with_stack=False, profile_memory=False)
        self._prof.__enter__()
        self._t0 = time.time_ns() * 1e-9

    def stop(self) -> WindowTrace:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns() * 1e-9
        self._prof.__exit__(None, None, None)
        ops, host = [], []
        for ev in self._prof.profiler.kineto_results.events():
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            kind = _kind(ev)
            if kind is not None:
                ops.append((ev.name(), s, e, kind))
            elif ev.device_type() == torch.autograd.DeviceType.CPU:
                host.append((ev.name(), s, e))
        self._prof = None
        return WindowTrace(start=self._t0, end=t1, ops=ops,
                           spans=self.spans.data, host_ops=host)
