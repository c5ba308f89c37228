"""The traversal kernels' share of their byte roofline: the byte-bound
time of every traversal call in the traced window (``yardstick.
launch_bytes`` on the call's lanes, active lanes and tables, at the H100's
HBM rate) over the device time of the kernels named here.  Silent where
no such kernel ran."""

KERNEL_PREFIX = "trace_"


def read(run):
    if run.window is None or run.trace_calls is None:
        return None
    dev = sum(e - s for name, s, e, _ in run.window.kernels()
              if KERNEL_PREFIX in name)
    if dev <= 0.0 or not run.trace_calls.calls:
        return None
    return 100.0 * run.trace_calls.bound_seconds() / dev
