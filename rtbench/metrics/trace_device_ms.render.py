"""Device milliseconds a traced sample launched inside the program's
``rt.trace_closest`` and ``rt.trace_shadow`` spans: the traversal kernels
and their wrappers' operations, the closest-hit and shadow marches
included, their ``rt.rng`` draws not (``rtbench/stages.py``).  Silent on a
program without spans or where launches and operations do not pair."""

from rtbench import stages


def read(run):
    return stages.device_ms_per_unit(run, "rt.trace_closest",
                                     "rt.trace_shadow")
