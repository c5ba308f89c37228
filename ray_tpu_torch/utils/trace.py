"""Spans of the program's stages and a count of its host synchronisations.

A span names what the host is doing: ``with trace.span("rt.surface"):``
around a stage, or ``with trace.Stages() as stage:`` for consecutive
stages of one body (each :meth:`Stages.next` ends the open stage and
starts the next).  A
span records only while tracing is on: while a ``torch.profiler`` runs,
or inside :func:`recording`.  Off, a span costs one flag check.  On, it
records its name, start and end on ``time.time_ns()`` (the clock the
profiler's events are read on) and its parent, the innermost span open at
its start, into a bounded buffer (:func:`spans`; past ``MAX_SPANS`` a span
is dropped and counted in :func:`dropped`); while a profiler runs it is
also a ``torch.profiler.record_function`` range, so the profiler's own
trace shows the stage names.

Every name starts with ``rt.``.  The render path's stages
(``render/integrator.py``, ``render/renderer.py``): ``rt.raygen``,
``rt.trace_closest``, ``rt.emission``, ``rt.surface``, ``rt.cache``,
``rt.nee``, ``rt.trace_shadow``, ``rt.bsdf``, ``rt.compact``,
``rt.accumulate``; every draw of ``ops/rng.py`` is an ``rt.rng`` inside
the stage that draws; every host synchronisation is an
``rt.sync.<site>`` (:func:`sync`): ``compact`` (the compaction test),
``march_closest`` and ``march_shadow`` (the transparency marches' loop
tests), ``radcache_check``, ``stats`` (``collect_stats``), ``upload``
(raygen's camera values, each copied from pageable memory, which waits
for the device) and ``tlas_base`` (``winst_base`` read back before each
two-level trace).

``host_syncs`` counts the synchronisations by site whether tracing is on
or not.  Spans are kept for one thread: the stack of open spans is the
process's.
"""

from __future__ import annotations

import collections
import contextlib
import time

from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 18

# host synchronisations by site, summed over the process
host_syncs: collections.Counter = collections.Counter()

_buffer: list = []
_open: list = []       # indices in _buffer of the open spans, innermost last
_state = {"forced": 0, "dropped": 0}


class Span:
    """One recorded span: ``parent`` is the index in :func:`spans` of the
    innermost span open at its start (-1: none); ``end_ns`` is 0 while
    it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent")

    def __init__(self, name, start_ns, parent):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = 0
        self.parent = parent


def enabled() -> bool:
    """Whether spans record now: a profiler runs or :func:`recording`
    is open."""
    return bool(_state["forced"] or _profiler._is_profiler_enabled)


class _Recorder:
    """An open span: the buffer entry and the profiler's range."""

    __slots__ = ("index", "range")

    def __init__(self, name):
        parent = _open[-1] if _open else -1
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(name)
            self.range.__enter__()
        if len(_buffer) < MAX_SPANS:
            self.index = len(_buffer)
            _buffer.append(Span(name, time.time_ns(), parent))
            _open.append(self.index)
        else:
            self.index = -1
            _state["dropped"] += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.index >= 0:
            _buffer[self.index].end_ns = time.time_ns()
            # a child left open by an exception closes with its parent
            while _open and _open.pop() != self.index:
                pass
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager recording the span ``name`` while tracing is on."""
    if _state["forced"] or _profiler._is_profiler_enabled:
        return _Recorder(name)
    return _OFF


def sync(site: str):
    """Count a host synchronisation at ``site`` and span it as
    ``rt.sync.<site>``: wrap the statement that waits for the device."""
    host_syncs[site] += 1
    if _state["forced"] or _profiler._is_profiler_enabled:
        return _Recorder(f"rt.sync.{site}")
    return _OFF


class Stages:
    """Consecutive stage spans of one body: ``with Stages() as stage:``,
    then ``stage.next(name)`` ends the open stage and starts ``name``;
    leaving the block (or ``end()``) ends the last, an exception too.
    Off, each call is one flag check."""

    __slots__ = ("_rec",)

    def __init__(self):
        self._rec = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def next(self, name: str):
        if self._rec is not None:
            self._rec.__exit__()
            self._rec = None
        if _state["forced"] or _profiler._is_profiler_enabled:
            self._rec = _Recorder(name)

    def end(self):
        if self._rec is not None:
            self._rec.__exit__()
            self._rec = None


@contextlib.contextmanager
def recording():
    """Record spans inside the block, profiler or not; yields a list that
    holds the block's spans once it closes."""
    first = len(_buffer)
    out: list = []
    _state["forced"] += 1
    try:
        yield out
    finally:
        _state["forced"] -= 1
        out.extend(_buffer[first:])


def spans() -> list:
    """Every span recorded so far (a :class:`Span` each), in start order."""
    return _buffer


def dropped() -> int:
    """Spans not recorded because the buffer was full."""
    return _state["dropped"]


def clear() -> None:
    """Empty the buffer and the dropped count (not ``host_syncs``)."""
    if _open:
        raise RuntimeError("clear() while a span is open")
    _buffer.clear()
    _state["dropped"] = 0
