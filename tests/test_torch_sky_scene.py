"""``Scene.set_physical_sky`` and the sky scene's tile against ray_tpu.

``physical_sky`` (``samples/05_physical_sky.py``'s scene:
``ray_tpu_torch.utils.test_scenes``) with the full sky baked at 32x16, built
by each package:

* the baked environment texture, row by row as tests/test_torch_sky_bake.py
  holds the bake (every row within 1e-5 relative, but for one row the
  cloud layer covers, within 1e-4; its docstring gives the cause):
  measured at the sample's 10 cloud steps, every row at 6.3e-6 or less,
  and 5.0e-6 or less with the atmosphere alone; the sun's DIR light — color
  within 1e-5 relative (the float32 transmittance lookup, then float64),
  direction and angle exact — and the environment settings equal; with
  ``full_sky=False`` and the sun's disk in the bake instead of a light,
  the same;
* a 16x16 tile across the horizon of the 1920x1080 frame (the ground quad
  under the sky: 2 triangles, the brute-force walk; the sky map's
  importance-sampled NEE and the sun's directional light) against ray_tpu's
  ``render_tile``, within tests/test_torch_render.py's bounds.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_scene  # noqa: F401  (one torch thread)
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.scene.camera import make_camera as j_make_camera
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.materials import ShadingNode as JShadingNode
from ray_tpu.scene.scene import Scene as JScene
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.scene.scene import Scene as TScene
from ray_tpu_torch.utils import test_scenes as ts
from test_torch_render import _check

W, H = 1920, 1080
RES = (32, 16)
J_API = types.SimpleNamespace(Scene=JScene, make_camera=j_make_camera,
                              MaterialDesc=JMaterialDesc,
                              ShadingNode=JShadingNode)


@pytest.fixture(scope="module")
def scenes():
    """(ray_tpu's physical_sky Scene, camera, the port's, camera)."""
    jsc, jcam = ts.physical_sky(J_API, env_res=RES)
    tsc, tcam = ts.physical_sky(env_res=RES, device="cpu")
    return jsc, jcam, tsc, tcam


def _rows_close(out, ref):
    row = (np.abs(out - ref) / np.abs(ref)).max(axis=(1, 2))
    past = np.nonzero(row > 1e-5)[0]
    assert len(past) <= 1 and (past < RES[1] // 2).all(), row
    assert row.max() <= 1e-4, row


def _check_sky(jsc, tsc, sun_light):
    assert (tsc.env_map, tsc.env_rotation) == (jsc.env_map, jsc.env_rotation)
    np.testing.assert_array_equal(tsc.env_col, jsc.env_col)
    ref = jsc._textures.get_image(jsc.env_map)
    out = tsc._textures.get_image(tsc.env_map)
    assert out.shape == ref.shape == (RES[1], RES[0], 4)
    assert tsc._textures.num_mips == jsc._textures.num_mips == [1]
    _rows_close(out[..., :3], ref[..., :3])
    assert len(tsc._lights) == len(jsc._lights) == int(sun_light)
    if sun_light:
        a, b = tsc._lights[0], jsc._lights[0]
        assert (a.type, a.direction, a.angle) == (b.type, b.direction,
                                                  b.angle)
        np.testing.assert_allclose(a.color, b.color, rtol=1e-5, atol=0)


def test_set_physical_sky_matches_ray_tpu(scenes):
    jsc, _, tsc, _ = scenes
    _check_sky(jsc, tsc, True)
    # the sun at 8 degrees is a bright light, dimmed by its long path
    assert 1e4 < max(tsc._lights[0].color) < 30.0 / (np.pi * np.radians(
        0.265) ** 2)


def test_set_physical_sky_atmosphere_only_matches_ray_tpu():
    sd = (0.3, 0.9, 0.2)
    jsc, tsc = JScene(), TScene()
    jp = jsc.set_physical_sky(sun_direction=sd, env_res=RES,
                              add_sun_light=False)
    tp = tsc.set_physical_sky(sun_direction=sd, env_res=RES,
                              add_sun_light=False, device="cpu")
    assert type(tp).__name__ == type(jp).__name__ == "AtmosphereParams"
    _check_sky(jsc, tsc, False)


def test_physical_sky_tile_matches_ray_tpu(scenes):
    jsc, jcam, tsc, tcam = scenes
    x0, y0, tw, th = 952, 764, 16, 16
    settings = dict(max_total_depth=5, min_total_depth=2)
    ref = j_render(jsc.finalize(), jcam, None, jnp.int32(x0), jnp.int32(y0),
                   jnp.uint32(1), jnp.uint32(0), width=W, height=H,
                   tile_w=tw, tile_h=th, settings=JPass(**settings),
                   use_filter_table=False)
    out = render_tile(tsc.finalize(device="cpu"), tcam, None, x0, y0, 1, 0,
                      width=W, height=H, tile_w=tw, tile_h=th,
                      settings=PassSettings(**settings),
                      use_filter_table=False)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    missed = (ref["depth_normal"] == 0).all(-1).mean()
    assert 0.0 < missed < 1.0 and ref["color"].mean() > 0.0
    _check(out, ref)
