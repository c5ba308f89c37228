"""The whole sample's share of the H100's HBM peak, counting the
traversal's bytes: the byte-bound time of the traversal calls a sample
(as ``trace_roofline.render`` counts them, whatever kernel serves them;
over the traced samples) over the mean wall time of the samples before the
trace, in the same run.  It bounds what a change to the traversal can
claim end to end."""


def read(run):
    untraced = run.unit_s[:run.traced_from]
    if run.trace_calls is None or not run.trace_calls.calls \
            or run.traced_units == 0 or not untraced:
        return None
    per_sample = run.trace_calls.bound_seconds() / run.traced_units
    return 100.0 * per_sample / (sum(untraced) / len(untraced))
