"""The SBVH builder (``build_bvh2(spatial_splits=True)``) and
``finalize(spatial_splits=True)`` against ray_tpu's, on the CPU.

* The numpy SBVH on ``tests/test_sbvh.py``'s long thin diagonal triangles
  (with ``tri_verts`` spatial splits fire and references repeat), with and
  without ``tri_verts``: nodes, leaf references and root box bit-equal to
  ``ray_tpu.scene.bvh.build_bvh2``'s.
* The native SBVH on 9,000 such triangles (past
  ``NATIVE_BUILDER_THRESHOLD``: ``"auto"`` takes it), with and without
  ``tri_verts``, bit-equal to ray_tpu's ``use_native="always"`` (both
  compile the same source with the same g++ flags on this machine).
* ``NativeCapacityError``: the native SBVH raises it in both packages when
  its reference slots overflow; ``build_bvh2`` raises it under
  ``"always"`` and falls back to the numpy SBVH under ``"auto"``, in both.
* A scene whose emissive triangles the SBVH references more than once (the
  flagship plus an emissive diagonal soup), finalized with
  ``spatial_splits=True`` in flatten and in tlas mode (the soup instanced
  twice): every table equal to ray_tpu's, light tables included, so each
  emissive triangle registers one TRI light.
* ``cornell_sphere`` (248 triangles) finalized with ``spatial_splits=True``:
  its tables equal, and the 64x48 1080p tile of
  ``tests/test_torch_render.py`` against ``ray_tpu``'s ``render_tile`` at
  that file's bounds.
"""

import numpy as np
import pytest

from ray_tpu.scene import bvh as jbvh
from ray_tpu.scene import native as j_native
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.materials import ShadingNode as JShadingNode
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.scene import bvh as tbvh
from ray_tpu_torch.scene import native as t_native
from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell
from test_sbvh import diagonal_tri_soup
from test_torch_render import _check
from test_torch_scene import (
    _assert_same,
    _assert_scene_equal,
    cornell_sphere,
    wait_for_ray_tpu_native,
)

BVH_FIELDS = ("child_lo", "child_hi", "child", "counts", "prim_indices",
              "root_lo", "root_hi")


def _same_bvh(port, ref):
    for f in BVH_FIELDS:
        _assert_same(getattr(port, f), getattr(ref, f), f)
    assert port.max_leaf == ref.max_leaf


@pytest.mark.parametrize("with_verts", [True, False])
def test_numpy_sbvh_matches_ray_tpu(with_verts):
    v, t = diagonal_tri_soup(250, seed=5)
    lo, hi = jbvh.tri_bounds(v, t)
    kw = dict(max_leaf=4, spatial_splits=True,
              tri_verts=v[t] if with_verts else None)
    ref = jbvh.build_bvh2(lo, hi, **kw)
    port = tbvh.build_bvh2(lo, hi, **kw)
    if with_verts:
        assert ref.prim_indices.shape[0] > 250   # references repeat
    _same_bvh(port, ref)
    # fat leaves, as finalize builds them
    _same_bvh(tbvh.build_bvh2(lo, hi, fat_leaves=True, **kw),
              jbvh.build_bvh2(lo, hi, fat_leaves=True, **kw))


@pytest.mark.parametrize("with_verts", [True, False])
def test_native_sbvh_matches_ray_tpu(with_verts):
    v, t = diagonal_tri_soup(9_000, seed=23)
    lo, hi = jbvh.tri_bounds(v, t)
    assert lo.shape[0] >= tbvh.NATIVE_BUILDER_THRESHOLD
    wait_for_ray_tpu_native()
    tv = v[t] if with_verts else None
    ref = jbvh.build_bvh2(lo, hi, max_leaf=4, spatial_splits=True,
                          tri_verts=tv, use_native="always")
    assert ref.prim_indices.shape[0] > 9_000
    for mode in ("auto", "always"):
        _same_bvh(tbvh.build_bvh2(lo, hi, max_leaf=4, spatial_splits=True,
                                  tri_verts=tv, use_native=mode), ref)


def _tight(module, monkeypatch):
    """The native SBVH with room for 64 references only."""
    build = module.build_sbvh_native

    def tight(*args, **kw):
        kw["max_refs_factor"] = 0.0
        return build(*args, **kw)

    monkeypatch.setattr(module, "build_sbvh_native", tight)


def test_native_capacity_error_in_both_modes(monkeypatch):
    v, t = diagonal_tri_soup(200, seed=7)
    lo, hi = jbvh.tri_bounds(v, t)
    wait_for_ray_tpu_native()
    for module in (j_native, t_native):
        with pytest.raises(module.NativeCapacityError, match="capacity"):
            module.build_sbvh_native(lo, hi, v[t], 4, max_refs_factor=0.0)
    assert issubclass(t_native.NativeCapacityError, RuntimeError)
    assert t_native.available()
    _tight(j_native, monkeypatch)
    _tight(t_native, monkeypatch)
    # "auto" reaches the native builder from this size on
    monkeypatch.setattr(jbvh, "NATIVE_BUILDER_THRESHOLD", 100)
    monkeypatch.setattr(tbvh, "NATIVE_BUILDER_THRESHOLD", 100)
    kw = dict(max_leaf=4, spatial_splits=True, tri_verts=v[t])
    with pytest.raises(j_native.NativeCapacityError):
        jbvh.build_bvh2(lo, hi, use_native="always", **kw)
    with pytest.raises(t_native.NativeCapacityError):
        tbvh.build_bvh2(lo, hi, use_native="always", **kw)
    ref = jbvh.build_bvh2(lo, hi, use_native="auto", **kw)
    port = tbvh.build_bvh2(lo, hi, use_native="auto", **kw)
    _same_bvh(port, ref)
    _same_bvh(port, tbvh.build_bvh2(lo, hi, use_native="never", **kw))


def sbvh_scene(port: bool, instanced: bool = False):
    """The flagship plus 250 long thin emissive triangles across the box
    (importance-sampled: TRI lights) that the SBVH references more than
    once; ``instanced``: the soup as one mesh instanced twice."""
    cornell = t_cornell if port else j_cornell
    desc, node = ((MaterialDesc, ShadingNode) if port
                  else (JMaterialDesc, JShadingNode))
    sc, cam = cornell("emissive_quad")
    m = sc.add_material(desc(type=node.EMISSIVE, base_color=(1.0, 0.8, 0.6),
                             strength=2.0, importance_sample=True))
    v, t = diagonal_tri_soup(250, seed=5)
    mesh = sc.add_mesh(v * 0.12, t, material=m)
    if instanced:
        xf = np.eye(4, dtype=np.float32)
        xf[:3, 3] = (0.1, 0.05, -0.1)
        sc.add_instance(mesh)
        sc.add_instance(mesh, xf)
    return sc, cam


@pytest.mark.parametrize("instancing", ["flatten", "tlas"])
def test_sbvh_scene_tables_match_ray_tpu(instancing):
    """Every table equal, TRI lights registered once a triangle."""
    (jsc, _), (tsc, _) = (sbvh_scene(p, instancing == "tlas")
                          for p in (False, True))
    js = jsc.finalize(instancing=instancing, spatial_splits=True)
    ts = tsc.finalize(device="cpu", instancing=instancing,
                      spatial_splits=True)
    assert ts.mode == instancing
    _assert_scene_equal(ts, js)
    plain = tsc.finalize(device="cpu", instancing=instancing)
    # duplicated leaf references, one light a triangle
    assert ts.num_lights == plain.num_lights
    if instancing == "flatten":
        assert ts.num_tris > plain.num_tris
        tri_light = ts.tri_light.numpy()
        assert (np.bincount(tri_light[tri_light >= 0]) > 1).any()


def test_sbvh_tile_matches_ray_tpu():
    """``cornell_sphere`` finalized with ``spatial_splits=True``: the same
    64x48 tile as tests/test_torch_render.py's, at its bounds."""
    import jax.numpy as jnp

    from ray_tpu.render.integrator import PassSettings as JPass
    from ray_tpu.render.integrator import render_tile as j_render
    from ray_tpu_torch.render.integrator import PassSettings, render_tile

    (jsc, jcam), (tsc, tcam) = (cornell_sphere(p, rings=8)
                                for p in (False, True))
    js = jsc.finalize(spatial_splits=True)
    ts = tsc.finalize(device="cpu", spatial_splits=True)
    _assert_scene_equal(ts, js)
    st = dict(max_total_depth=5, min_total_depth=2)
    tile = dict(width=1920, height=1080, tile_w=64, tile_h=48,
                use_filter_table=False)
    ref = j_render(js, jcam, None, jnp.int32(900), jnp.int32(840),
                   jnp.uint32(1), jnp.uint32(0), settings=JPass(**st), **tile)
    out = render_tile(ts, tcam, None, 900, 840, 1, 0,
                      settings=PassSettings(**st), **tile)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    assert ref["color"].mean() > 0.0
    _check(out, ref)
