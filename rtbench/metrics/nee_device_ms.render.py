"""Device milliseconds a traced sample launched inside the program's
``rt.nee`` spans, its ``rt.rng`` draws and the shadow trace excluded (light
pick, ``sample_light_source``, the light direction's ``eval_uber``, MIS and
the shadowed contribution; ``rtbench/stages.py``).  Silent on a program
without spans or where launches and operations do not pair."""

from rtbench import stages


def read(run):
    return stages.device_ms_per_unit(run, "rt.nee")
