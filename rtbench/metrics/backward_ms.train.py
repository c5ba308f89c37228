"""Mean milliseconds of the backward pass a step in the traced window:
the device time from the first to the last operation inside each
``backward`` span (which the traced step brackets with synchronisations),
so host launch gaps inside the backward count and the forward's do not."""


def read(run):
    if run.window is None:
        return None
    spans = run.window.spans.get("backward", [])
    per = []
    for s, e in spans:
        inside = [(a, b) for _, a, b, _ in run.window.ops if a >= s and b <= e]
        if inside:
            per.append(max(b for _, b in inside) - min(a for a, _ in inside))
    if not per:
        return None
    return 1e3 * sum(per) / len(per)
