"""Seconds of ``Scene.finalize`` in set-up (host clock, synchronised):
the scene compile's share of ``setup_s``."""


def read(run):
    return run.finalize_s
