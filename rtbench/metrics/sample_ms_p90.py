"""The 90th percentile over every sample of the window of one sample's
wall time in milliseconds, from its call until it is synchronised."""

from rtbench import yardstick


def read(run):
    return 1e3 * yardstick.percentile(run.unit_s, 90)
