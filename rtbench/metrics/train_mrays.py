"""Millions of rays a second: every forward ``rays_traced`` of the
optimisation steps the window completed over the window's wall time."""

from rtbench import yardstick


def read(run):
    return yardstick.mrays_per_s(run.rays, run.window_s)
