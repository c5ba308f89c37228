"""Device milliseconds a traced sample launched inside the program's
``rt.rng`` spans (every draw of ``ray_tpu_torch/ops/rng.py``, nested in the
stage that draws): each device operation of the window under the innermost
program span open at its launch (``rtbench/stages.py``).  Silent on a
program without spans or where launches and operations do not pair."""

from rtbench import stages


def read(run):
    return stages.device_ms_per_unit(run, "rt.rng")
