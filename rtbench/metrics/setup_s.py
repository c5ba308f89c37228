"""Seconds from the process's start to the window's first unit."""


def read(run):
    return run.setup_s
