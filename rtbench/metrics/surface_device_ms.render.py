"""Device milliseconds a traced sample launched inside the program's
``rt.surface`` spans, its ``rt.rng`` draws excluded (``fetch_tri_row``
through ``gather_uber_params``: Mix, normal map, tangent rotation, texture
LOD; ``rtbench/stages.py``).  Silent on a program without spans or where
launches and operations do not pair."""

from rtbench import stages


def read(run):
    return stages.device_ms_per_unit(run, "rt.surface")
