"""Host synchronisations a traced sample: the program's ``rt.sync.*``
spans that started in the traced window over its samples (each is one
statement of the program that waits for the device).  Silent on a program
without spans."""

from rtbench import stages


def read(run):
    if run.window is None or run.traced_units == 0:
        return None
    spans = stages.program_spans(run.window)
    if spans is None:
        return None
    n = sum(name.startswith(stages.SYNC_PREFIX) for name, _, _ in spans)
    return n / run.traced_units
