"""Share of the traced window's device-operation time whose launch lies
in no program span (``rtbench/stages.py``): how much of the device's work
the program's spans leave unaccounted.  Silent on a program without spans
or where launches and operations do not pair."""

from rtbench import stages


def read(run):
    att = stages.of_run(run)
    if att is None:
        return None
    total = sum(v[0] for v in att.values())
    if total <= 0.0:
        return None
    return 100.0 * att.get(None, (0.0, 0))[0] / total
