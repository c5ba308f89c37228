"""The HLBVH builder (``finalize(fast_build=True)``) against ray_tpu's.

* ``build_hlbvh`` (``scene/hlbvh.py``, a numpy copy of
  ``ray_tpu.scene.hlbvh``) on seeded triangle soups of 1 to 3,000
  triangles at ``max_leaf`` 1, 4, 8 and 15 — the single-leaf case, ties of
  Morton codes, leaves at every size — and ``morton30``: every array
  byte-equal.
* ``finalize(fast_build=True)`` of ``sphere_hlbvh`` (``cornell_sphere``,
  376 triangles: the BVH2 and its 8-wide rows), of ``sphere_vis`` in
  flatten mode (per-triangle visibility) and of ``cornell_vis`` and
  ``sphere_vis`` in tlas mode (HLBVH BLASes; the binary walk and
  ``wrows_tlas``): every table and static field equal to ray_tpu's, and
  ``SceneFlat.from_numpy`` carries ray_tpu's across unchanged.
* A 32x24 ``sphere_hlbvh`` tile on the sphere against ray_tpu's ``render_tile``
  (tests/test_torch_render.py's bounds).
* ``furnace_scene`` (``utils/test_scenes.py``, a copy of ray_tpu's) equal
  to ray_tpu's, and a white DIFFUSE furnace through ``Renderer`` on the
  CPU within tests/test_materials.py's bound (|v - 1| < 0.02 for an
  albedo-1 body that conserves energy; measured 0.99934 in both).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_scene  # noqa: F401  (one torch thread)
from cpu_golden_scenes import SCENES
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.scene import hlbvh as JH
from ray_tpu.scene.lights import LightDesc as JLightDesc
from ray_tpu.scene.lights import LightType as JLightType
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.materials import ShadingNode as JShadingNode
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu.utils.test_scenes import furnace_scene as j_furnace
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.render.renderer import Renderer, RenderSettings
from ray_tpu_torch.scene import hlbvh as TH
from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
from ray_tpu_torch.scene.scene import SceneFlat
from ray_tpu_torch.utils import test_scenes as ts
from test_torch_render import _check
from test_torch_scene import _ARRAYS, _STATIC, _assert_same, _assert_scene_equal

J_API = types.SimpleNamespace(
    cornell_scene=j_cornell, scene_dir_env=SCENES["dir_env"],
    MaterialDesc=JMaterialDesc, ShadingNode=JShadingNode,
    LightDesc=JLightDesc, LightType=JLightType)


def _soup(n, seed):
    r = np.random.default_rng(seed)
    base = r.uniform(-10.0, 10.0, (n, 1, 3))
    tris = base + r.uniform(-0.4, 0.4, (n, 3, 3))
    if n > 8:
        tris[: n // 8] = tris[0]  # equal boxes: equal Morton codes
    lo = tris.min(axis=1).astype(np.float32)
    hi = tris.max(axis=1).astype(np.float32)
    return lo, hi


@pytest.mark.parametrize("n", [1, 3, 17, 400, 3000])
@pytest.mark.parametrize("max_leaf", [1, 4, 8, 15])
def test_build_hlbvh_matches_ray_tpu(n, max_leaf):
    lo, hi = _soup(n, n * 7 + max_leaf)
    a, b = TH.build_hlbvh(lo, hi, max_leaf), JH.build_hlbvh(lo, hi, max_leaf)
    for f in ("child_lo", "child_hi", "child", "counts", "prim_indices",
              "root_lo", "root_hi"):
        _assert_same(getattr(a, f), getattr(b, f), f)
    assert a.max_leaf == b.max_leaf == max_leaf
    c = 0.5 * (lo + hi)
    _assert_same(TH.morton30(c, lo.min(0), hi.max(0)),
                 JH.morton30(c, lo.min(0), hi.max(0)), "morton30")


@pytest.mark.parametrize("name,mode", [
    ("sphere_hlbvh", "flatten"), ("sphere_vis", "flatten"),
    ("cornell_vis", "tlas"), ("sphere_vis", "tlas")])
def test_fast_build_finalize_matches_ray_tpu(name, mode):
    build = getattr(ts, name)
    ref = build(J_API)[0].finalize(instancing=mode, fast_build=True)
    port = build()[0].finalize(device="cpu", instancing=mode, fast_build=True)
    _assert_scene_equal(port, ref)
    # the HLBVH tree differs from the SAH one
    sah = build()[0].finalize(device="cpu", instancing=mode)
    assert not np.array_equal(sah.bvh_soa["packed"].numpy(),
                              port.bvh_soa["packed"].numpy())
    arrays = {n: jax.tree_util.tree_map(np.asarray, getattr(ref, n))
              for n in _ARRAYS}
    static = {n: getattr(ref, n) for n in _STATIC}
    _assert_scene_equal(SceneFlat.from_numpy(arrays, static, device="cpu"),
                        ref)


def test_sphere_hlbvh_tile_matches_ray_tpu():
    (jsc, jcam), (tsc, tcam) = ts.sphere_hlbvh(J_API), ts.sphere_hlbvh()
    port = tsc.finalize(device="cpu", fast_build=True)
    assert port.num_tris == 376 and port.bvh_soa["code0"].shape[0] <= 512
    settings = dict(max_total_depth=5, min_total_depth=2)
    x0, y0 = 900, 840
    ref = j_render(jsc.finalize(fast_build=True), jcam, None, jnp.int32(x0),
                   jnp.int32(y0), jnp.uint32(1), jnp.uint32(0), width=1920,
                   height=1080, tile_w=32, tile_h=24,
                   settings=JPass(**settings), use_filter_table=False)
    out = render_tile(port, tcam, None, x0, y0, 1, 0, width=1920,
                      height=1080, tile_w=32, tile_h=24,
                      settings=PassSettings(**settings),
                      use_filter_table=False)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    on_sphere = np.isclose(ref["base_color"][:, 2], 0.8).mean()
    assert on_sphere > 0.1, on_sphere
    _check(out, ref)


def test_furnace_scene_matches_ray_tpu():
    jsc, jcam = j_furnace(JMaterialDesc(type=JShadingNode.DIFFUSE,
                                        base_color=(0.5, 0.6, 0.7)))
    tsc, tcam = ts.furnace_scene(MaterialDesc(type=ShadingNode.DIFFUSE,
                                              base_color=(0.5, 0.6, 0.7)))
    _assert_scene_equal(tsc.finalize(device="cpu"), jsc.finalize())
    for f in ("origin", "fwd", "side", "up", "fov"):
        np.testing.assert_array_equal(np.asarray(getattr(tcam, f)),
                                      np.asarray(getattr(jcam, f)))


def test_diffuse_furnace():
    """tests/test_materials.py's furnace at 24x24, 24 spp, depth 8 without
    Russian roulette: the centre 6x6 of a white Lambertian ball
    (roughness 0; Oren-Nayar's default 0.5 loses energy: 0.8746 in both
    packages) in a unit environment returns 1."""
    sc, cam = ts.furnace_scene(MaterialDesc(type=ShadingNode.DIFFUSE,
                                            base_color=(1.0, 1.0, 1.0),
                                            roughness=0.0))
    r = Renderer(RenderSettings(24, 24), PassSettings(
        max_total_depth=8, min_total_depth=8, use_path_termination=False),
        device="cpu")
    img = r.render(sc.finalize(device="cpu"), cam, 24)
    v = float(np.asarray(img)[9:15, 9:15].mean())
    assert abs(v - 1.0) < 0.02, v
