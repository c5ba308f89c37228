"""What every loop shares: the scene's set-up and the measured window.

A loop builds its scene with :func:`finalize`, opens a :class:`Window`
when set-up is done and reports each sample or step to it; the window
says when to stop.  In a traced run (``--trace 1``) the window's last
``trace_seconds`` (a traffic mix's parameter) run under the profiler and
with the traversal's calls recorded, and the units before them run as an
untraced run's do, so a per-layer metric can set what the trace saw
against untraced units of the same run.  The trace comes last because a
profiler once started slows the host's launches for the rest of the
process, after it stops too.
"""

from __future__ import annotations

import time

import torch

from rtbench import devtrace


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def finalize(run, sc):
    """``sc.finalize`` with the configuration's options on the run's
    device; its seconds go to ``run.finalize_s``."""
    t0 = time.perf_counter()
    scene = sc.finalize(**run.cell.config["finalize"], device=run.device)
    sync(run.device)
    run.finalize_s = time.perf_counter() - t0
    return scene


def free(device):
    """Return the program's freed memory to the card before the check."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Window:
    """The measured window of one run.  Opening it ends set-up (the
    device synchronised, the memory peak reset); ``done(s0, s1)`` takes
    one unit's host interval and returns True once ``run.seconds`` have
    passed, when ``run.window_s`` and ``run.peak_bytes`` are set.  A
    traced run also waits for ``trace_seconds`` of trace counted from the
    profiler's start, which takes seconds of its own."""

    def __init__(self, run):
        self.run = run
        sync(run.device)
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(run.device)
        run.setup_s = time.perf_counter() - run.t_start
        self._trace = self._calls = None
        self._trace_s = float(run.cell.traffic["trace_seconds"])
        self._trace_at = (max(run.seconds - self._trace_s, 0.0)
                          if run.trace else None)
        self._trace_t0 = None
        self.t0 = time.perf_counter()
        if self._trace_at == 0.0:
            self._start_trace()

    @property
    def spans(self):
        """The traced part's host spans, or None outside it."""
        return None if self._trace is None else self._trace.spans

    def _start_trace(self):
        self.run.traced_from = len(self.run.unit_s)
        self._trace_at = None
        self._trace = devtrace.DeviceWindow(self.run.device)
        self._calls = devtrace.TraceCalls().__enter__()
        self._trace.start()
        self._trace_t0 = time.perf_counter()

    def _stop_trace(self):
        run = self.run
        run.window = self._trace.stop()
        self._calls.__exit__(None, None, None)
        run.trace_calls = self._calls
        run.traced_units = len(run.unit_s) - run.traced_from
        self._trace = self._calls = None

    def done(self, s0: float, s1: float) -> bool:
        run = self.run
        run.unit_s.append(s1 - s0)
        elapsed = s1 - self.t0
        if self._trace_at is not None and elapsed >= self._trace_at:
            # a unit longer than the trace still gets one traced unit
            self._start_trace()
            return False
        if elapsed < run.seconds:
            return False
        if self._trace is not None:
            if s1 - self._trace_t0 < self._trace_s:
                return False
            self._stop_trace()
        run.window_s = elapsed
        run.units = len(run.unit_s)
        if run.device.type == "cuda":
            run.peak_bytes = torch.cuda.max_memory_allocated(run.device)
        return True
