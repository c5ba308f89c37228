"""The benchmark's arithmetic on synthetic inputs."""

import pytest
import torch

from rtbench import yardstick


def test_percentile_is_over_all_samples():
    xs = list(range(1, 101))           # 1..100
    assert yardstick.percentile(xs, 90) == pytest.approx(90.1)
    assert yardstick.percentile([5.0], 90) == 5.0
    assert yardstick.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        yardstick.percentile([], 90)


def test_window_rate():
    # 9.2M rays a sample, 100 samples in 30 s
    assert yardstick.mrays_per_s(920_000_000, 30.0) == pytest.approx(
        30.666666, rel=1e-6)


def test_idle_share_from_overlapping_intervals():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (9.0, 12.0)]
    assert yardstick.union_seconds(ivs, 0.0, 10.0) == pytest.approx(4.0)
    gaps = yardstick.idle_gaps(ivs, 0.0, 10.0)
    assert gaps == [(2.0, 3.0), (4.0, 9.0)]
    assert yardstick.union_seconds([], 0.0, 1.0) == 0.0
    assert yardstick.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    # 4 s busy over 2 traced units against untraced units of 2.5 s
    assert yardstick.idle_share(4.0, 2, [2.0, 3.0]) == pytest.approx(0.2)


def test_launch_bytes_bound():
    # chip_smoke.py's launch_bound: 22 B a lane, 28 B an active lane,
    # the tables once; +4 B a lane on the two-level walk, +8 with a mask
    assert yardstick.launch_bytes("trace_brute", 100, 40, 864, False) == (
        22 * 100 + 28 * 40 + 864)
    assert yardstick.launch_bytes("trace_tlas", 100, 40, 0, False) == (
        26 * 100 + 28 * 40)
    assert yardstick.launch_bytes("trace_tlas", 100, 40, 0, True) == (
        30 * 100 + 28 * 40)
    assert yardstick.bound_seconds(3.35e12) == pytest.approx(1.0)


def test_bench_loss():
    c = torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]])
    t = torch.zeros_like(c)
    # sum(color^2) / (H * W * 3) with H * W = 2
    assert float(yardstick.bench_loss(c, t, 1, 2)) == pytest.approx(14 / 6)

