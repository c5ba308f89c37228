"""The port's stage spans and host-sync count (``ray_tpu_torch/utils/
trace.py``) on the flagship at 32x32 with compaction after bounce 2: with
tracing off nothing records; with ``trace.recording()`` the samples are
bit-identical to untraced ones, each bounce's stages come in order, every
RNG draw lies inside a stage and the compaction test is one host sync a
sample; a tile whose live lanes fit compacts inside ``rt.compact``."""

import contextlib

import pytest
import torch

from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.render.renderer import Renderer, RenderSettings
from ray_tpu_torch.utils import trace
from ray_tpu_torch.utils.test_scenes import cornell_scene

torch.set_num_threads(1)

SAMPLES = 2
SETTINGS = PassSettings(max_total_depth=5, min_total_depth=2, compact_after=2)
# a flagship bounce: NEE's shadow trace splits its span in two
BOUNCE = ["rt.trace_closest", "rt.emission", "rt.surface", "rt.emission",
          "rt.nee", "rt.trace_shadow", "rt.nee", "rt.bsdf"]
STAGES = set(BOUNCE) | {"rt.raygen", "rt.compact", "rt.accumulate"}


def _render(record: bool):
    sc, cam = cornell_scene("emissive_quad")
    scene = sc.finalize(device="cpu")
    r = Renderer(RenderSettings(width=32, height=32), SETTINGS, device="cpu")
    trace.host_syncs.clear()
    n0 = len(trace.spans())
    with (trace.recording() if record else contextlib.nullcontext([])) as sp:
        rays = [int(r.render_sample(scene, cam, 7)["rays_traced"])
                for _ in range(SAMPLES)]
    return {"r": r, "rays": rays, "spans": sp, "syncs": dict(trace.host_syncs),
            "new": len(trace.spans()) - n0}


@pytest.fixture(scope="module")
def runs():
    assert not trace.enabled()
    return {"off": _render(False), "on": _render(True)}


def test_nothing_records_with_tracing_off(runs):
    assert runs["off"]["new"] == 0 and runs["off"]["spans"] == []
    assert runs["on"]["new"] == len(runs["on"]["spans"]) > 0
    assert not trace.enabled() and trace.dropped() == 0


def test_recording_leaves_the_samples_bit_identical(runs):
    off, on = runs["off"], runs["on"]
    assert off["rays"] == on["rays"]
    for k in Renderer._STATE_KEYS:
        assert torch.equal(getattr(off["r"], k), getattr(on["r"], k)), k


def test_stages_in_order_and_draws_inside_them(runs):
    spans = runs["on"]["spans"]
    first = spans[0]
    index = {id(s): i for i, s in enumerate(trace.spans())}
    base = index[id(first)]
    top = [s.name for s in spans if s.parent < base]
    # the live lanes do not fit a quarter of the frame: no gather
    c = SETTINGS.compact_after
    one = (["rt.raygen"] + BOUNCE * c + ["rt.compact"]
           + BOUNCE * (SETTINGS.max_total_depth + 1 - c) + ["rt.accumulate"])
    assert top == one * SAMPLES
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= base:
            p = trace.spans()[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(trace.spans()[s.parent].name
                                              if s.parent >= base else None)
    assert set(by_name["rt.rng"]) <= STAGES
    assert {"rt.raygen", "rt.surface", "rt.nee", "rt.bsdf"} <= set(
        by_name["rt.rng"])
    assert by_name["rt.sync.compact"] == ["rt.compact"] * SAMPLES
    assert set(by_name["rt.sync.upload"]) == {"rt.raygen"}


@pytest.mark.parametrize("mode", ["off", "on"])
def test_one_compaction_sync_a_sample(runs, mode):
    # and raygen's 20 camera values, each copied from pageable memory
    assert runs[mode]["syncs"] == {"compact": SAMPLES, "upload": 20 * SAMPLES}


def test_compacted_tile_gathers_and_scatters_inside_compact():
    sc, cam = cornell_scene("emissive_quad")
    scene = sc.finalize(device="cpu")
    mask = torch.arange(32 * 32) % 4 == 0      # a quarter of the lanes live

    def tile():
        return render_tile(scene, cam, None, 0, 0, 1, 7, width=32, height=32,
                           tile_w=32, tile_h=32, settings=SETTINGS,
                           use_filter_table=False, pixel_mask=mask)

    off = tile()
    with trace.recording() as spans:
        on = tile()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    top = [s.name for s in spans if s.name in STAGES and s.name != "rt.rng"]
    c = SETTINGS.compact_after
    assert top == (["rt.raygen"] + BOUNCE * c + ["rt.compact"]
                   + BOUNCE * (SETTINGS.max_total_depth + 1 - c)
                   + ["rt.compact"])


def test_an_exception_in_a_bounce_leaves_no_span_open(monkeypatch):
    from ray_tpu_torch.render import uber

    sc, cam = cornell_scene("emissive_quad")
    scene = sc.finalize(device="cpu")

    def fail(*args, **kwargs):
        raise RuntimeError("planted")

    monkeypatch.setattr(uber, "sample_uber", fail)
    with trace.recording() as spans:
        with pytest.raises(RuntimeError, match="planted"):
            render_tile(scene, cam, None, 0, 0, 1, 7, width=8, height=8,
                        tile_w=8, tile_h=8, settings=SETTINGS,
                        use_filter_table=False)
    assert [s.name for s in spans if s.name in STAGES] == [
        "rt.raygen", *BOUNCE]
    assert all(s.end_ns for s in spans)
    trace.clear()       # raises while a span is left open
    with trace.recording() as spans:
        with trace.span("rt.nee"):
            pass
    assert [s.parent for s in spans] == [-1]
