"""Every cell of BENCHMARK.json resolves to the files the harness finds by
name, and the file keeps to the rules of BENCHMARK.json."""

import json
import re

import pytest

from rtbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = harness.resolve_cell(BENCH, cell)
    assert (harness.ROOT / c.config["scene"]).is_file()
    assert callable(c.scene_module().scene)
    loop = c.loop()
    assert callable(loop.run) and callable(loop.control)
    for m in c.per_layer + c.end_to_end:
        path = harness.HERE / "metrics" / f"{m['name']}.py"
        assert callable(harness.load_module(path, "m").read)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert set(c.limits) >= {"pixel_gap_max", "hit_gap_max"} or set(
        c.limits) >= {"loss_gap", "rays_gap", "grad_gap", "step_gap"}


def test_benchmark_json_shape():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["rtbench"] and 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    for entry in b["configs"] + b["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("rtbench/")
