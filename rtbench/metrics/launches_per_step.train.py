"""Device kernels launched in the traced window over the optimisation
steps it completed (forward, backward and Adam)."""


def read(run):
    if run.window is None or run.traced_units == 0 or not run.window.kernels():
        return None
    return len(run.window.kernels()) / run.traced_units
