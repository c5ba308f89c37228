"""The port's ``gather_table`` against the gather probe's Pallas bodies.

``scripts/test_pallas_gather.py`` probes three Pallas bodies (``k_take``,
``k_index``, ``k_take_along``) that all compute
``table.reshape(-1)[idx]``.  The script is loaded from its path and each
body runs through ``pl.pallas_call(..., interpret=True)`` with the
script's own VMEM ``in_specs`` / ``out_specs``: on the probe's inputs
(``arange`` tables of shape (1024,) and (1, 1024), the (8, 128) index of
``default_rng(0)``) and on random tables holding NaN (with payloads) and
-0.  A gather copies bits, so the port's wrapper on the CPU (the plain
version) must equal every body bit for bit.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ray_tpu_torch.ops.gather_probe import gather_table, gather_table_plain

# one intra-op thread, as in tests/test_torch_scene.py
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 1024


def _probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_gather_probe", ROOT / "scripts" / "test_pallas_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROBE = _probe()
BODIES = {"k_take": (N,), "k_index": (N,), "k_take_along": (1, N)}


def _pallas(body, table, idx):
    """One probe body as the script calls it, in interpret mode."""
    out = pl.pallas_call(
        getattr(PROBE, body),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(table), jnp.asarray(idx))
    return np.asarray(out)


def _probe_idx():
    # try_kernel's index
    return np.random.default_rng(0).integers(0, N, (8, 128)).astype(np.int32)


def _special_table(shape, seed):
    """Random floats with NaNs of several payloads, -0, +0 and infinities."""
    r = np.random.default_rng(seed)
    bits = r.normal(size=N).astype(np.float32).view(np.uint32)
    bits[::7] = 0x7FC00000 | r.integers(0, 1 << 22, bits[::7].shape,
                                        dtype=np.uint32)
    bits[3::11] = 0xFFC00001      # a negative NaN with a payload
    bits[1::13] = 0x80000000      # -0
    bits[2::17] = 0x00000000      # +0
    bits[5::19] = 0x7F800000      # +inf
    return bits.view(np.float32).reshape(shape)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("table_kind", ["arange", "special"])
def test_gather_table_equals_the_pallas_body(body, table_kind):
    shape = BODIES[body]
    if table_kind == "arange":
        table = np.arange(N, dtype=np.float32).reshape(shape)
        idx = _probe_idx()
    else:
        table = _special_table(shape, 1)
        # every special entry among the lanes
        idx = np.random.default_rng(2).permutation(N).astype(
            np.int32).reshape(8, 128)
    ref = _pallas(body, table, idx)
    out = gather_table(torch.from_numpy(table.copy()), torch.from_numpy(idx))
    assert out.shape == (8, 128) and out.dtype == torch.float32
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
    if table_kind == "special":
        o = _bits(out.numpy())
        assert (o == 0x80000000).any() and (o == 0xFFC00001).any()


def test_gather_table_any_shape_and_plain():
    """Any index shape (and an empty one); the wrapper on the CPU is the
    plain version."""
    table = torch.from_numpy(_special_table((N,), 3))
    idx = torch.from_numpy(np.random.default_rng(4).integers(
        0, N, (3, 5, 7)).astype(np.int32))
    out = gather_table(table, idx)
    assert out.shape == (3, 5, 7)
    np.testing.assert_array_equal(_bits(out.numpy()),
                                  _bits(table.numpy()[idx.numpy()]))
    np.testing.assert_array_equal(
        _bits(out.numpy()), _bits(gather_table_plain(table, idx).numpy()))
    empty = gather_table(table, torch.zeros((0, 4), dtype=torch.int32))
    assert empty.shape == (0, 4)


@pytest.mark.parametrize("case", [
    "idx_int64", "table_f64", "table_2_rows", "table_empty", "idx_negative",
    "idx_past_end", "idx_strided", "not_a_tensor", "meta_device"])
def test_gather_table_rejects_bad_inputs(case):
    table = torch.zeros(N)
    idx = torch.zeros((8, 128), dtype=torch.int32)
    err = ValueError
    if case == "idx_int64":
        idx, err = idx.long(), TypeError
    elif case == "table_f64":
        table, err = table.double(), TypeError
    elif case == "table_2_rows":
        table = torch.zeros(2, N)
    elif case == "table_empty":
        table = torch.zeros(0)
    elif case == "idx_negative":
        idx[3, 4], err = -1, IndexError
    elif case == "idx_past_end":
        idx[7, 127], err = N, IndexError
    elif case == "idx_strided":
        idx = torch.zeros((128, 8), dtype=torch.int32).t()
    elif case == "not_a_tensor":
        table, err = np.zeros(N, np.float32), TypeError
    elif case == "meta_device":
        table = torch.empty(N, device="meta")
        idx = torch.empty((8, 128), dtype=torch.int32, device="meta")
    with pytest.raises(err):
        gather_table(table, idx)
