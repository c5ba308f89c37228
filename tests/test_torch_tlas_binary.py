"""The binary two-level walk and instanced TRI lights against ray_tpu on
the CPU.

A tlas scene of ≤ 256 unique triangles carries no ``wrows_tlas``; ray_tpu
walks it with the XLA ``_traverse_tlas`` and the port with
``trace_tlas_bin_plain`` (on a CUDA tensor ``csrc/trace_tlas_bin.cu``, held
to it bit for bit in ``chip_smoke.py`` and tests/test_torch_cuda.py).

* ``trace_tlas_bin_plain`` against ``_traverse_tlas`` on seeded rays, both
  modes, with the ray masks ``RAY_CAMERA`` and ``RAY_SHADOW``: on
  ``cornell_tlas`` and on a scene of two meshes instanced under
  translation and non-uniform scale, one instance hidden from camera rays
  and one from shadow rays.  ``prim``, ``inst``, ``backface`` and the
  occlusion verdict exact; ``t`` within rtol 1e-5 + atol 1e-5 and ``u`` /
  ``v`` within atol 1e-4 (tests/test_torch_traverse.py's bounds: XLA's CPU
  code is not IEEE-sequential float32).
* A 32x32 ``cornell_tlas`` tile (the flagship finalized in tlas mode: its
  light quad's two TRI lights are instanced) and a tile of
  tests/test_instancing.py's instanced-lamp scene (two instances of an
  emissive quad: 4 TRI lights read from the light table's world-space
  triangles) against ray_tpu's ``render_tile``, within
  tests/test_torch_render.py's bounds.
(The bench loss's gradients through the binary walk:
tests/test_torch_tlas_binary_grad.py.)
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import traverse as jtrav
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.scene.camera import make_camera as j_camera
from ray_tpu.scene.lights import LightDesc as JLightDesc
from ray_tpu.scene.lights import LightType as JLightType
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.materials import ShadingNode as JShadingNode
from ray_tpu.scene.scene import Scene as JScene
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.ops import traverse as ttrav
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.scene.visibility import (
    RAY_CAMERA,
    RAY_SHADOW,
    visibility_mask,
)
from ray_tpu_torch.utils import test_scenes as ts
from ray_tpu_torch.utils.geometry import make_box, make_quad, make_uv_sphere
from test_torch_render import _check
from test_torch_scene import _assert_same, _np_tree

W, H = 1920, 1080
SETTINGS = dict(max_total_depth=5, min_total_depth=2)

J_API = types.SimpleNamespace(
    cornell_scene=j_cornell, MaterialDesc=JMaterialDesc,
    ShadingNode=JShadingNode, LightDesc=JLightDesc, LightType=JLightType,
    Scene=JScene, make_camera=j_camera)
T_API = ts.port_api()  # its Scene and make_camera too


def _xform(t, scale=(1.0, 1.0, 1.0)):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = scale
    m[:3, 3] = t
    return m


def instanced_shapes(api):
    """A UV sphere (160 triangles) and a box (12) instanced seven times
    under translation, uniform and non-uniform scale, one sphere hidden
    from camera rays and one box from shadow rays: 172 unique triangles,
    no ``wrows_tlas``.  Returns the Scene."""
    sc = api.Scene()
    m = sc.add_material(api.MaterialDesc(type=api.ShadingNode.DIFFUSE,
                                         base_color=(0.7, 0.7, 0.7)))
    v, idx, n, uv = make_uv_sphere(radius=0.6, rings=8, segments=10)
    sphere = sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)
    bv, bidx, bn = make_box(size=(0.8, 0.5, 0.6))
    box = sc.add_mesh(bv, bidx, normals=bn, material=m)
    sc.add_instance(sphere, _xform((-1.2, 0.0, 0.3), (0.8, 0.8, 0.8)))
    sc.add_instance(sphere, _xform((1.0, 0.2, 0.6), (1.5, 0.6, 1.0)))
    sc.add_instance(sphere, _xform((0.1, -1.1, -0.4), (0.7, 1.3, 0.9)),
                    visibility=visibility_mask(camera=False))
    sc.add_instance(sphere, _xform((0.2, 1.2, 0.1)))
    sc.add_instance(box, _xform((-0.3, 0.4, -1.0), (1.2, 0.5, 2.0)))
    sc.add_instance(box, _xform((0.9, -0.8, -0.6)),
                    visibility=visibility_mask(shadow=False))
    sc.add_instance(box, _xform((-1.1, -0.9, 1.0), (0.6, 2.0, 0.8)))
    sc.set_environment((0.5, 0.5, 0.5))
    return sc


SCENES = {
    "cornell_tlas": lambda api: api.cornell_scene("emissive_quad")[0],
    "instanced_shapes": instanced_shapes,
}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, build in SCENES.items():
        js = build(J_API).finalize(instancing="tlas")
        tsc = build(T_API).finalize(device="cpu", instancing="tlas")
        assert "wrows_tlas" not in tsc.bvh_soa and tsc.num_tris <= 256
        out[name] = (js, tsc)
    return out


def _rays(n, seed, half):
    r = np.random.default_rng(seed)
    ro = r.uniform(-half, half, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = np.where(r.random(n) < 0.8, 1e30, r.random(n) * 3.0)
    active = r.random(n) < 0.95
    return (ro, rd, np.zeros(n, np.float32), t_max.astype(np.float32),
            active)


def test_tables_match_ray_tpu(scenes):
    """The binary walk's inputs: nodes, triangles and instance columns."""
    for js, tsc in scenes.values():
        _assert_same(_np_tree(tsc.bvh_soa), _np_tree(js.bvh_soa), "bvh_soa")
        _assert_same(_np_tree(tsc.tri_soa), _np_tree(js.tri_soa), "tri_soa")
        _assert_same(_np_tree(tsc.inst), _np_tree(js.inst), "inst")
        assert tsc.stack_size == js.stack_size


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("mask", [RAY_CAMERA, RAY_SHADOW])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_tlas_bin_plain_matches_ray_tpu(scenes, name, mask, any_hit):
    js, tsc = scenes[name]
    R = 3000
    arrays = _rays(R, 17, 0.95 if name == "cornell_tlas" else 2.0)
    ray_mask = np.full(R, mask, np.int32)
    ref = jtrav._traverse_tlas(
        js.bvh_soa, js.tri_soa, js.inst,
        *(jnp.asarray(a) for a in arrays), jnp.asarray(ray_mask),
        js.max_leaf, js.stack_size, any_hit)
    hit = ttrav.trace_tlas_bin_plain(
        tsc.bvh_soa["packed"], tsc.tri_soa["packed"], tsc.inst,
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(ray_mask),
        tsc.max_leaf, tsc.stack_size, any_hit)
    prim = hit.prim.numpy()
    hits = prim >= 0
    assert 0.05 < hits.mean() < 0.98, hits.mean()
    if any_hit:
        np.testing.assert_array_equal(hits, np.asarray(ref.prim) >= 0)
        return
    np.testing.assert_array_equal(prim, np.asarray(ref.prim))
    np.testing.assert_array_equal(hit.inst.numpy(), np.asarray(ref.inst))
    np.testing.assert_array_equal(hit.backface.numpy(),
                                  np.asarray(ref.backface))
    np.testing.assert_array_equal(hit.t.numpy()[~hits],
                                  np.asarray(ref.t)[~hits])
    np.testing.assert_allclose(hit.t.numpy()[hits], np.asarray(ref.t)[hits],
                               rtol=1e-5, atol=1e-5)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(hit, f).numpy()[hits],
                                   np.asarray(getattr(ref, f))[hits],
                                   rtol=0, atol=1e-4, err_msg=f)
    # the hidden instances: camera rays never report the camera-invisible
    # sphere (instance 2), shadow rays never the shadow-invisible box (5)
    if name == "instanced_shapes":
        assert not (hit.inst.numpy() == (2 if mask == RAY_CAMERA else 5)).any()


def test_wrapper_runs_plain_on_cpu_and_routes(scenes, monkeypatch):
    """``trace_closest_tlas`` / ``trace_occlusion_tlas`` send a scene
    without ``wrows_tlas`` to ``trace_tlas_bin``, whose CPU path is the
    plain walk."""
    _, tsc = scenes["instanced_shapes"]
    rays = tuple(torch.from_numpy(a) for a in _rays(256, 3, 2.0))
    calls = []
    real = ttrav.trace_tlas_bin
    monkeypatch.setattr(ttrav, "trace_tlas_bin",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    h = ttrav.trace_closest_tlas(tsc.bvh_soa, tsc.tri_soa, tsc.inst, *rays,
                                 max_leaf=tsc.max_leaf,
                                 stack_size=tsc.stack_size)
    occ = ttrav.trace_occlusion_tlas(tsc.bvh_soa, tsc.tri_soa, tsc.inst,
                                     *rays, max_leaf=tsc.max_leaf,
                                     stack_size=tsc.stack_size)
    p = ttrav.trace_tlas_bin_plain(tsc.bvh_soa["packed"],
                                   tsc.tri_soa["packed"], tsc.inst, *rays,
                                   None, tsc.max_leaf, tsc.stack_size)
    assert calls == [{"any_hit": False}, {"any_hit": True}]
    for f in h._fields:
        assert torch.equal(getattr(h, f), getattr(p, f)), f
    assert torch.equal(occ, p.prim >= 0)


def test_plain_counts_work(scenes):
    _, tsc = scenes["instanced_shapes"]
    rays = tuple(torch.from_numpy(a) for a in _rays(256, 4, 2.0))
    work = {}
    hit = ttrav.trace_tlas_bin_plain(
        tsc.bvh_soa["packed"], tsc.tri_soa["packed"], tsc.inst, *rays, None,
        tsc.max_leaf, tsc.stack_size, work=work)
    n_hit = int((hit.prim >= 0).sum())
    assert set(work) == {"node_steps", "inst_entries", "tri_tests"}
    assert work["inst_entries"] >= n_hit > 0
    assert work["tri_tests"] >= n_hit
    assert work["node_steps"] >= int(rays[4].sum())


def _tiles(build, x0, y0, tw, th, api_pairs=(J_API, T_API)):
    (jsc, jcam), (tsc, tcam) = (build(api) for api in api_pairs)
    ref = j_render(
        jsc.finalize(instancing="tlas"), jcam, None, jnp.int32(x0),
        jnp.int32(y0), jnp.uint32(1), jnp.uint32(0), width=W, height=H,
        tile_w=tw, tile_h=th, settings=JPass(**SETTINGS),
        use_filter_table=False)
    out = render_tile(
        tsc.finalize(device="cpu", instancing="tlas"), tcam, None, x0, y0,
        1, 0, width=W, height=H, tile_w=tw, tile_h=th,
        settings=PassSettings(**SETTINGS), use_filter_table=False)
    return ({k: v.numpy() for k, v in out.items()},
            {k: np.asarray(v) for k, v in ref.items()})


def test_cornell_tlas_tile_matches_ray_tpu():
    out, ref = _tiles(ts.cornell_tlas, 944, 524, 32, 32)
    assert ref["color"].mean() > 0.0
    _check(out, ref)


def lamps(api):
    """tests/test_instancing.py's instanced-lamp scene: an emissive
    two-sided quad instanced twice over a floor (4 TRI lights in tlas
    mode).  Returns (Scene, Camera)."""
    v, idx, uvq = make_quad((0, 0, 0), (0.3, 0, 0), (0, 0, 0.3))
    floor_v, floor_i, floor_uv = make_quad((0, -1, 0), (3, 0, 0), (0, 0, -3))
    sc = api.Scene()
    emis = sc.add_material(api.MaterialDesc(
        type=api.ShadingNode.EMISSIVE, base_color=(1, 1, 1), strength=10.0,
        importance_sample=True, two_sided=True))
    white = sc.add_material(api.MaterialDesc(
        type=api.ShadingNode.DIFFUSE, base_color=(0.7, 0.7, 0.7)))
    lamp = sc.add_mesh(v, idx, uvs=uvq, material=emis)
    floor = sc.add_mesh(floor_v, floor_i, uvs=floor_uv, material=white)
    sc.add_instance(lamp, _xform((-0.8, 0.8, 0.0)))
    sc.add_instance(lamp, _xform((0.8, 0.8, 0.0)))
    sc.add_instance(floor)
    cam = api.make_camera(origin=(0, 1.2, -3.2), look_at=(0, -0.4, 0),
                          fov=50.0)
    return sc, cam


def test_instanced_lamp_tile_matches_ray_tpu():
    """Four TRI lights of two instances: NEE samples the light table's
    world-space triangles, and a BSDF ray that hits a lamp finds its light
    by instance (MIS)."""
    tsc = lamps(T_API)[0].finalize(device="cpu", instancing="tlas")
    js = lamps(J_API)[0].finalize(instancing="tlas")
    assert tsc.num_lights == js.num_lights == 4
    _assert_same(_np_tree(tsc.lights), _np_tree(js.lights), "lights")
    # the tile spans the left lamp and the floor it lights
    out, ref = _tiles(lamps, 560, 130, 32, 32)
    emissive = np.isclose(ref["base_color"], 1.0).all(-1).mean()
    assert 0.0 < emissive < 1.0, emissive
    _check(out, ref)
