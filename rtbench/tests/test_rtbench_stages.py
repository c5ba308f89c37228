"""The stage reader (``rtbench/stages.py``) on synthetic windows and spans
put in the program's span buffer: each device operation under the
innermost span open at its launch (self time), the stage sums and the
unattributed part adding up to the device-op time, and no reading where
launches and operations do not pair."""

import time
import types

import pytest

from ray_tpu_torch.utils import trace
from rtbench import harness, stages
from rtbench.devtrace import WindowTrace

# rt.nee [0, 10] holds rt.rng [2, 4]; rt.bsdf [10, 15]; rt.sync.compact
# [15, 15.5]; nothing after 15.5
SPANS = [("rt.nee", 0.0, 10.0), ("rt.rng", 2.0, 4.0), ("rt.bsdf", 10.0, 15.0),
         ("rt.sync.compact", 15.0, 15.5)]
# (launch start, operation start, operation seconds): nee, rng, nee, bsdf,
# sync, none
LAUNCHED = [(1.0, 1.5, 1.0), (3.0, 3.5, 2.0), (5.0, 6.0, 3.0),
            (12.0, 13.0, 4.0), (15.2, 15.3, 0.5), (16.0, 17.0, 5.0)]


def record(spans):
    """``spans`` (name, start s, end s) in the program's buffer, as its
    recorder leaves them."""
    trace.clear()
    for name, s, e in spans:
        sp = trace.Span(name, round(s * 1e9), -1)
        sp.end_ns = round(e * 1e9)
        trace.spans().append(sp)


@pytest.fixture(autouse=True)
def recorded():
    record(SPANS)
    yield
    trace.clear()


def window(launched=LAUNCHED, extra_host=()):
    ops = [(f"k{i}", s, s + d, "kernel") for i, (_, s, d) in enumerate(launched)]
    host = [("cudaLaunchKernel", t, t + 0.1) for t, _, _ in launched]
    host += [("cudaStreamSynchronize", 15.25, 15.4), *extra_host]
    return WindowTrace(start=0.0, end=30.0, ops=ops, spans={}, host_ops=host)


def fake_run(win, units=2):
    return types.SimpleNamespace(window=win, traced_units=units, readings={})


def test_innermost_span_takes_each_operation():
    att = stages.attribution(window())
    assert att == {"rt.nee": [pytest.approx(4.0), 2],
                   "rt.rng": [pytest.approx(2.0), 1],
                   "rt.bsdf": [pytest.approx(4.0), 1],
                   "rt.sync.compact": [pytest.approx(0.5), 1],
                   None: [pytest.approx(5.0), 1]}


def test_stage_sums_and_unattributed_add_up_to_device_time():
    win = window()
    att = stages.attribution(win)
    total = sum(e - s for _, s, e, _ in win.ops)
    assert sum(v[0] for v in att.values()) == pytest.approx(total, rel=1e-12)
    assert sum(v[1] for v in att.values()) == len(win.ops)


@pytest.mark.parametrize("broken", ["launch_missing", "extra_launch",
                                    "kinds_differ"])
def test_unpaired_launches_read_nothing(broken):
    if broken == "launch_missing":
        win = window()
        win.host_ops.remove(("cudaLaunchKernel", 5.0, 5.1))
    elif broken == "extra_launch":
        win = window(extra_host=[("cudaMemsetAsync", 20.0, 20.1)])
    else:
        # the copy's launch pairs with a kernel: one launch call fewer and
        # one more elsewhere keep the counts equal
        win = window()
        win.host_ops.remove(("cudaLaunchKernel", 16.0, 16.1))
        win.host_ops.append(("cudaMemcpyAsync", 0.5, 0.6))
    assert stages.match(win) is None and stages.attribution(win) is None
    run = fake_run(win)
    for name in ("rng_device_ms.render", "unattributed_device_share.render"):
        assert harness.read_metric(run, name) is None


def test_clocks_apart_still_pair_in_order():
    # the device's clock reads 0.3 s behind the host's: each operation
    # seems to start before its launch
    want = stages.attribution(window())
    late = [(t + 0.3, s, d) for t, s, d in LAUNCHED]
    record([(n, s + 0.3, e + 0.3) for n, s, e in SPANS])
    assert stages.attribution(window(late)) == want


def test_metrics_read_per_unit():
    run = fake_run(window(), units=2)
    got = {n: harness.read_metric(run, n) for n in (
        "rng_device_ms.render", "nee_device_ms.render",
        "bsdf_device_ms.render", "trace_device_ms.render",
        "unattributed_device_share.render", "host_syncs_per_sample.render")}
    assert got == {"rng_device_ms.render": pytest.approx(1000.0),
                   "nee_device_ms.render": pytest.approx(2000.0),
                   "bsdf_device_ms.render": pytest.approx(2000.0),
                   "trace_device_ms.render": 0.0,
                   "unattributed_device_share.render":
                       pytest.approx(100.0 * 5.0 / 15.5),
                   "host_syncs_per_sample.render": 0.5}


def test_idle_gaps_go_to_the_span_at_their_midpoint():
    idle = stages.idle_by_span(window())
    # gaps [0, 1.5] and [5.5, 6] in nee, [2.5, 3.5] in rng, [9, 13] across
    # nee and bsdf (midpoint 11: bsdf), [22, 30] in none
    assert idle == {"rt.nee": pytest.approx(2.0), "rt.rng": pytest.approx(1.0),
                    "rt.bsdf": pytest.approx(4.0), None: pytest.approx(8.0)}


def test_spans_from_the_programs_buffer():
    trace.clear()
    t0 = time.time_ns() * 1e-9
    with trace.recording():
        with trace.span("rt.nee"):
            time.sleep(0.002)
            with trace.span("rt.rng"):
                time.sleep(0.002)
    t1 = time.time_ns() * 1e-9
    win = WindowTrace(start=t0, end=t1, ops=[], spans={}, host_ops=[])
    got = stages.program_spans(win)
    assert [n for n, _, _ in got] == ["rt.nee", "rt.rng"]
    assert got[0][1] <= got[1][1] <= got[1][2] <= got[0][2]
    # a window without spans (the parent's program): nothing to read
    empty = WindowTrace(start=1.0, end=2.0, ops=[], spans={}, host_ops=[])
    assert stages.program_spans(empty) is None
    assert harness.read_metric(fake_run(empty),
                               "host_syncs_per_sample.render") is None


def test_a_buffer_that_dropped_spans_reads_nothing(monkeypatch):
    win = window()
    assert stages.program_spans(win) is not None
    monkeypatch.setitem(trace._state, "dropped", 1)
    assert stages.program_spans(win) is None
    assert harness.read_metric(fake_run(win), "rng_device_ms.render") is None
