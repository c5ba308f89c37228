"""Millions of rays a second: every ``rays_traced`` of the samples the
window completed over the window's wall time (``bench.py``'s arithmetic)."""

from rtbench import yardstick


def read(run):
    return yardstick.mrays_per_s(run.rays, run.window_s)
