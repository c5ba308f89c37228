"""The harness on the CPU: no card, no run; no JAX in what it imports;
and the check decides ``correct`` at a small size, the control and every
planted fault failing it."""

import json
import subprocess
import sys

import pytest
import torch

from rtbench import faults, harness

torch.set_num_threads(1)
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SIZE = (32, 24)
SEED = 2 ** 31 + 977


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "flagship.render", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA card" in out.err


def test_forbidden_names_compare_whole_top_level_names():
    mods = {"ray_tpu_torch": 0, "ray_tpu_torch.ops": 0, "jaxtyping": 0,
            "rtbench.ref": 0}
    assert harness.forbidden_modules(mods) == []
    for bad in ("jax", "jaxlib.xla", "flax.linen", "ray_tpu",
                "ray_tpu.render"):
        assert harness.forbidden_modules({**mods, bad: 0}) == [bad]


def test_imports_hold_no_jax_and_no_ray_tpu():
    code = (
        "import sys, pathlib; sys.path.insert(0, '.');"
        "from rtbench import harness, check, calibrate, faults, window;"
        "import rtbench.ref.render.integrator, rtbench.ref.scene.scene;"
        "import rtbench.ref.render.raygen;"
        "[harness.load_module(p, 'm' + str(i)) for i, p in enumerate("
        "sorted((harness.HERE / 'metrics').glob('*.py')))];"
        "[harness.load_module(p, 'c' + str(i)) for i, p in enumerate("
        "sorted((harness.HERE / 'configs').glob('*.py')))];"
        "[harness.load_module(p, 'l' + str(i)) for i, p in enumerate("
        "sorted((harness.HERE / 'loops').glob('*.py')))];"
        "import ray_tpu_torch.render.renderer, ray_tpu_torch.api;"
        "print(harness.forbidden_modules());"
        "print(sorted(m for m in sys.modules if m.startswith('rtbench.ref')"
        " and 'ray_tpu_torch' in str(getattr(sys.modules[m], '__file__',"
        " ''))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "[]"]


def test_reference_imports_nothing_of_the_port():
    for path in (harness.HERE / "ref").rglob("*.py"):
        text = path.read_text()
        assert "import ray_tpu" not in text and "from ray_tpu" not in text, \
            path


def _cell(name, **traffic):
    cell = harness.resolve_cell(BENCH, name)
    cell.traffic = {**cell.traffic, "check_pixels": 64, "warmup_samples": 1,
                    **traffic}
    return cell


def _run(cell, seconds=0.3):
    import time

    return harness.run_cell(cell, SEED, seconds, False, torch.device("cpu"),
                            time.perf_counter(), size=SIZE)


@pytest.mark.parametrize("name", ["flagship.render", "flagship.train"])
def test_sound_run_is_correct_and_control_is_not(name):
    cell = _cell(name)
    run = _run(cell)
    assert run.units >= 1 and run.rays > 0
    assert harness.correct(run), run.checks
    got = cell.loop().control(run)
    assert any(v["value"] > v["limit"] for v in got.values()), got


@pytest.mark.parametrize("name", ["flagship.render", "flagship.train"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_is_not_correct(name, fault):
    cell = _cell(name)
    with faults.FAULTS[fault]():
        run = _run(cell, seconds=0.01)
    assert not harness.correct(run), run.checks


def test_colonnade_sound_run_is_correct():
    run = _run(_cell("colonnade.render", check_pixels=32), seconds=0.01)
    assert harness.correct(run), run.checks


def test_result_line_keys():
    run = _run(_cell("flagship.render"), seconds=0.01)
    line = harness.result_line(run)
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert set(line["metrics"]) == {"render_mrays", "sample_ms_p90",
                                    "peak_mem_gib", "setup_s"}


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "flagship.render",
         "--seed", "5", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().split("\n")[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("setting", [{"variance_threshold": 0.01},
                                     {"use_spatial_cache": True}])
def test_render_loop_refuses_settings_its_check_cannot_follow(setting):
    cell = _cell("flagship.render")
    cell.config = {**cell.config, "render_settings": setting}
    with pytest.raises(ValueError, match="loop of its own"):
        _run(cell, seconds=0.01)
