"""Faults planted under the timed path, to show that the check fails them.

Each is a context manager that breaks the port where the window drives
it, as a later change might: the tests run a cell under each at a small
size on the CPU and see ``correct`` come out false, and
``calibrate.py`` reads them on the card at the cell's size.

* ``state_unchanged``: a sample leaves the renderer's buffers as they
  were; a training step leaves the parameters as they were;
* ``half_batch``: ``render_tile`` renders the first half of its lanes and
  gives the rest their mean;
* ``answer_altered``: ``render_tile``'s radiance comes out 0.1% high.

There is no exchange between chips in any cell, so that fault has no
planting here.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _wrap_render_tile(change):
    from ray_tpu_torch.render import integrator, renderer

    plain = integrator.render_tile

    def render_tile(*args, **kwargs):
        out = plain(*args, **kwargs)
        return {**out, "color": change(out["color"])}

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(integrator, "render_tile", render_tile))
    stack.enter_context(_patched(renderer, "render_tile", render_tile))
    return stack


@contextlib.contextmanager
def state_unchanged():
    from ray_tpu_torch.render import renderer

    def accumulate(full_buf, half_buf, counts, sample, mask):
        return full_buf, half_buf, counts

    def step(self, closure=None):
        return None

    with _patched(renderer, "_accumulate", accumulate), \
            _patched(torch.optim.Adam, "step", step):
        yield


def _half(color):
    n = color.shape[0] // 2
    rest = color[:n].mean(dim=0, keepdim=True).expand(color.shape[0] - n, -1)
    return torch.cat([color[:n], rest])


@contextlib.contextmanager
def half_batch():
    with _wrap_render_tile(_half):
        yield


@contextlib.contextmanager
def answer_altered():
    with _wrap_render_tile(lambda c: c * 1.001):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
