"""Device milliseconds a traced sample launched inside the program's
``rt.bsdf`` spans, its ``rt.rng`` draws excluded (``sample_uber``, Russian
roulette and the next bounce's state; ``rtbench/stages.py``).  Silent on a
program without spans or where launches and operations do not pair."""

from rtbench import stages


def read(run):
    return stages.device_ms_per_unit(run, "rt.bsdf")
