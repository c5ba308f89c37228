"""Device time by program stage: the traced window's device operations put
down to the program's own spans (``ray_tpu_torch/utils/trace.py``: the
``rt.`` stages of the render path, ``rt.rng`` inside them, ``rt.sync.*``
around each host synchronisation).

The port launches on one CUDA stream, so its operations run in the order
they were launched.  :func:`match` takes the window's launch calls on the
host (``LAUNCHES``) in order and pairs them one to one with the window's
device operations sorted by start; it gives up (None) where the two counts
differ or a pair's kinds do not (a kernel launch against a copy, a copy
against a fill).  It does not compare a launch's start with its
operation's: the profiler's device and host timestamps are two clocks,
and on the H100 an operation read from 43 us before to over a
millisecond after the launch that made it (CUPTI's correlation ids
paired them as the order does).  Each operation's device time then goes
to the innermost program span open at its launch's start
(:func:`attribution`), so a stage's time is its self time: an ``rt.rng``
inside ``rt.nee`` is the RNG's, not NEE's.  An operation launched outside
every span is unattributed (key None).

The spans are those of the program's buffer (``trace.spans()``) that
started inside the window: the benchmark's profiler records CUDA activity
only, so the program's ``record_function`` ranges never reach its host
operations.  A program without spans gives None, and so does every
reader built on this module.
"""

from __future__ import annotations

import numpy as np

from rtbench import yardstick

# the host's launch calls, each with the kind of operation it makes
LAUNCHES = {"cudaLaunchKernel": "kernel", "cudaLaunchKernelExC": "kernel",
            "cuLaunchKernel": "kernel", "cudaMemcpyAsync": "memcpy",
            "cudaMemsetAsync": "memset"}
SYNC_PREFIX = "rt.sync."


def program_spans(window):
    """[(name, start, end)] of the program's spans in ``window`` (seconds
    on the profiler's clock), or None where it recorded none or its
    buffer dropped some."""
    try:
        from ray_tpu_torch.utils import trace
    except ImportError:
        return None
    if trace.dropped():
        return None
    lo, hi = window.start * 1e9, window.end * 1e9
    found = [(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9)
             for s in trace.spans() if s.end_ns and lo <= s.start_ns <= hi]
    return found or None


def match(window):
    """[(launch start, operation)] pairing each launch call with its
    device operation, or None where the window's launches and operations
    cannot be paired in order (their counts or a pair's kinds differ)."""
    launches = sorted((h[1], LAUNCHES[h[0]]) for h in window.host_ops
                      if h[0] in LAUNCHES)
    ops = sorted(window.ops, key=lambda o: o[1])
    if len(launches) != len(ops) or not ops:
        return None
    if any(kind != o[3] for (_, kind), o in zip(launches, ops)):
        return None
    return [(t, o) for (t, _), o in zip(launches, ops)]


def innermost(spans):
    """(times, labels): from ``times[i]`` up to ``times[i + 1]`` the
    innermost open span is ``labels[i]`` (None: no span).  Spans nest (one
    thread opens and closes them)."""
    times, labels, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][2] <= t:
            top = stack.pop()
            times.append(top[2])
            labels.append(stack[-1][0] if stack else None)

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        close_until(s)
        stack.append((name, s, e))
        times.append(s)
        labels.append(name)
    close_until(float("inf"))
    return np.asarray(times, dtype=np.float64), labels


def label_at(timeline, ts):
    """The innermost span's name at each time of ``ts``."""
    times, labels = timeline
    idx = np.searchsorted(times, np.asarray(ts, dtype=np.float64),
                          side="right") - 1
    return [labels[i] if i >= 0 else None for i in idx]


def attribution(window):
    """{span name or None: [device seconds, operations]} over the window,
    each operation under the innermost span open at its launch; None
    where the program has no spans or the launches cannot be matched."""
    spans = program_spans(window)
    pairs = match(window) if spans is not None else None
    if pairs is None:
        return None
    names = label_at(innermost(spans), [t for t, _ in pairs])
    out = {}
    for name, (_, op) in zip(names, pairs):
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += op[2] - op[1]
        acc[1] += 1
    return out


def idle_by_span(window):
    """{span name or None: idle seconds}: each idle gap of the device goes
    to the innermost span open at its midpoint; None without spans."""
    spans = program_spans(window)
    if spans is None:
        return None
    gaps = yardstick.idle_gaps([(s, e) for _, s, e, _ in window.ops],
                               window.start, window.end)
    out = {}
    names = label_at(innermost(spans), [0.5 * (s + e) for s, e in gaps])
    for name, (s, e) in zip(names, gaps):
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def of_run(run):
    """:func:`attribution` of a run's traced window, worked out once."""
    if run.window is None or run.traced_units == 0:
        return None
    if "stages" not in run.readings:
        run.readings["stages"] = attribution(run.window)
    return run.readings["stages"]


def device_ms_per_unit(run, *names):
    """Device milliseconds a traced unit launched under the spans
    ``names`` (self time), or None."""
    att = of_run(run)
    if att is None:
        return None
    return 1e3 * sum(att.get(n, (0.0, 0))[0] for n in names) \
        / run.traced_units
