"""Big flatten scenes' tables against ray_tpu's on the CPU, bit for bit.

* The native BVH2 builder: ``build_bvh2`` of a 20,000-triangle generator
  cloud (tests/test_traverse_pallas.py's) takes the C++ builder from 8,192
  primitives on, as ray_tpu's ``use_native="auto"`` does; nodes, leaf order
  and root box equal ``ray_tpu.scene.bvh.build_bvh2(...,
  use_native="always")``.  Both compile the same source with the same g++
  flags on this machine, so the floats are the same bits.  (The numpy
  builder gives other nodes on this cloud, and takes ~10 s for it.)
* ``partition_subtrees`` and ``pack_binned_scene`` of the 3,000-triangle
  cloud of tests/test_binned_interpret.py: every array equal, the stack
  size included.
* ``finalize(instancing="flatten", pallas_binned=True)`` of
  ``colonnade_scene(n_cols=3)`` (106,402 triangles, S = 298 subtrees):
  every table equal, ``wrows`` and the ``binned_*`` slabs included, and
  ``SceneFlat.from_numpy`` of ray_tpu's scene gives the port's.
* ``colonnade_scene(n_cols=2)``: both packages refuse to partition it (a
  node too large to be a subtree has a two-triangle leaf child).
"""

import jax
import numpy as np
import pytest

from ray_tpu.ops.traverse_pallas import pack_binned_scene as j_pack
from ray_tpu.scene import bvh as jbvh
from ray_tpu.utils.test_scenes import colonnade_scene as j_colonnade
from ray_tpu_torch.scene import bvh as tbvh
from ray_tpu_torch.scene.binned import CI
from ray_tpu_torch.scene.binned import pack_binned_scene as t_pack
from ray_tpu_torch.scene.scene import SceneFlat
from ray_tpu_torch.utils.test_scenes import colonnade_scene as t_colonnade
from test_torch_scene import _ARRAYS, _STATIC, _assert_same, _assert_scene_equal

BVH_FIELDS = ("child_lo", "child_hi", "child", "counts", "prim_indices",
              "root_lo", "root_hi")


def _cloud_bounds(n_tris, seed):
    """tests/test_traverse_pallas.py's big clouds (seed 7)."""
    r = np.random.RandomState(seed)
    base = (r.rand(n_tris, 1, 3) - 0.5) * 10.0
    size = max(0.8, 12.0 / np.sqrt(n_tris))
    tris = base + (r.rand(n_tris, 3, 3) - 0.5) * size
    v = tris.reshape(-1, 3).astype(np.float32)
    t = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    return jbvh.tri_bounds(v, t)


def _interpret_cloud():
    """tests/test_binned_interpret.py's 3,000-triangle cloud."""
    r = np.random.RandomState(3)
    n_tris = 3000
    base = r.rand(n_tris, 1, 3).astype(np.float32) * 10.0
    tris = base + r.rand(n_tris, 3, 3).astype(np.float32) * 0.6
    v = tris.reshape(-1, 3)
    t = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    return v, t


@pytest.mark.parametrize("max_leaf", [4, 8])
def test_native_builder_matches_ray_tpu(max_leaf):
    lo, hi = _cloud_bounds(20_000, 7)
    assert lo.shape[0] >= tbvh.NATIVE_BUILDER_THRESHOLD
    ref = jbvh.build_bvh2(lo, hi, max_leaf=max_leaf, use_native="always")
    for kw in ({}, {"use_native": "always"}):
        b = tbvh.build_bvh2(lo, hi, max_leaf=max_leaf, **kw)
        for f in BVH_FIELDS:
            _assert_same(getattr(b, f), getattr(ref, f), f)


def test_native_builder_fat_leaves_matches_ray_tpu():
    lo, hi = _cloud_bounds(9_000, 5)
    ref = jbvh.build_bvh2(lo, hi, max_leaf=8, use_native="always",
                          fat_leaves=True)
    b = tbvh.build_bvh2(lo, hi, max_leaf=8, fat_leaves=True)
    for f in BVH_FIELDS:
        _assert_same(getattr(b, f), getattr(ref, f), f)


def test_sbvh_raises_naming_item_18():
    lo, hi = _cloud_bounds(100, 1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        tbvh.build_bvh2(lo, hi, spatial_splits=True)


def test_partition_and_pack_match_ray_tpu():
    v, t = _interpret_cloud()
    lo, hi = jbvh.tri_bounds(v, t)
    jb = jbvh.build_bvh2(lo, hi, max_leaf=4, use_native="never")
    tb = tbvh.build_bvh2(lo, hi, max_leaf=4, use_native="never")
    jp, tp = jbvh.partition_subtrees(jb), tbvh.partition_subtrees(tb)
    assert set(jp) == set(tp)
    for k in ("top_child_lo", "top_child_hi", "top_code"):
        _assert_same(tp[k], jp[k], k)
    assert tp["depth"] == jp["depth"]
    assert len(tp["sub_local"]) == len(jp["sub_local"]) >= 4
    for s, (a, b) in enumerate(zip(tp["sub_local"], jp["sub_local"])):
        for f in ("child_lo", "child_hi", "child", "counts"):
            _assert_same(getattr(a, f), getattr(b, f), f"sub {s} {f}")
        _assert_same(tp["sub_tri_ids"][s], jp["sub_tri_ids"][s], f"ids {s}")

    jpk = j_pack(jb, jbvh.pack_tri_soa(v, t[jb.prim_indices]))
    tpk = t_pack(tb, tbvh.pack_tri_soa(v, t[tb.prim_indices]))
    _assert_same(tpk, jpk, "binned")
    assert tpk["stack_arr"].shape[0] == jp["depth"] + 2


@pytest.fixture(scope="module")
def colonnade3():
    """~5 s: both finalizes of the 106,402-triangle scene."""
    jsc, _ = j_colonnade(n_cols=3)
    tsc, _ = t_colonnade(n_cols=3)
    kw = dict(instancing="flatten", pallas_binned=True)
    return jsc.finalize(**kw), tsc.finalize(device="cpu", **kw)


def test_colonnade_binned_tables_match_ray_tpu(colonnade3):
    js, ts = colonnade3
    _assert_scene_equal(ts, js)
    assert ts.mode == "flatten" and ts.num_tris == 106_402
    soa = ts.bvh_soa
    assert tuple(soa["wrows"].shape) == (21_719, 88)
    assert soa["binned_slab_i"].shape[0] // CI == 298
    assert tuple(soa["binned_slab_f"].shape) == (298 * 88, 128)
    assert ts.stack_size == 23 and soa["binned_stack_arr"].shape[0] == 11


def test_from_numpy_carries_the_binned_colonnade(colonnade3):
    js, ts = colonnade3
    arrays = {n: jax.tree_util.tree_map(np.asarray, getattr(js, n))
              for n in _ARRAYS}
    static = {n: getattr(js, n) for n in _STATIC}
    carried = SceneFlat.from_numpy(arrays, static, device="cpu")
    _assert_scene_equal(carried, js)
    for n in _STATIC:
        assert getattr(carried, n) == getattr(ts, n), n


def test_two_column_colonnade_raises_in_both():
    """Finding of the slice: ray_tpu's partition asserts when a node too
    large to be a subtree has a leaf child; the port raises on the same
    scene, naming the same cause."""
    jsc, _ = j_colonnade(n_cols=2)
    with pytest.raises(AssertionError, match="cannot be split"):
        jsc.finalize(instancing="flatten", pallas_binned=True)
    tsc, _ = t_colonnade(n_cols=2)
    with pytest.raises(ValueError, match="leaf with 2 tris cannot be split"):
        tsc.finalize(device="cpu", instancing="flatten", pallas_binned=True)
