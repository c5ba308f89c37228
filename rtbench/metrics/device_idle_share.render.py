"""Share of an untraced sample's wall time in which no operation runs on
the device: 1 - (device busy time a sample: the union of the device
operations' intervals over the traced samples) / (the mean wall time of
the samples before the trace, in the same run).  The profiler slows the
host but not the device, so the traced samples give the device's time and
the untraced ones the host's."""

from rtbench import yardstick


def read(run):
    untraced = run.unit_s[:run.traced_from]
    if run.window is None or not run.window.ops or not untraced:
        return None
    return 100.0 * yardstick.idle_share(run.window.busy_s(), run.traced_units,
                                        untraced)
