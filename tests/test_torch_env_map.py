"""Latlong environment maps against ray_tpu on the CPU.

``set_environment(color, map_id, rotation)`` with a texture: finalize
builds ray_tpu's importance tables (``scene/env.py`` ``build_env_cdf``: a
sin-θ-weighted luminance marginal / conditional CDF and each texel's
solid-angle pdf), the environment's radiance is the color times the
bilinear map turned about +y (``env_color``), NEE samples it by inverse
transform (``sample_env_importance``: a binary search of ``_bits(N)``
gathers, so the texel picked is ray_tpu's index) and a miss's MIS weight
reads the texel's pdf (``env_hit_pdf``).

* ``build_env_cdf`` and ``TexturePacker.get_image`` byte-equal to
  ray_tpu's, and so every env table of the finalized ``env_map`` scene.
* ``env_color`` within rtol 1e-4 / atol 1e-6: the two CPU ``arccos`` /
  ``atan2`` differ in the last ulp, which moves the bilinear weights, and
  the map's steep sun (radiance ~40 over a few texels) and 5% texel noise
  turn that into up to 3.6e-5 relative (measured, 12 of 12,000 values
  past 1e-5).  ``sample_env_importance``'s texel exact (its pdf is the
  table entry, bit for bit) and its direction within atol 1e-5;
  ``env_hit_pdf`` exact; on seeded directions and random numbers.
* A 32x32 ``env_map`` tile (the ball, the ground and the sky), and one
  with a sky portal under the map, against ray_tpu's ``render_tile``:
  tests/test_torch_render.py's bounds, except the normals of
  ``depth_normal`` — held to atol 2e-5 (measured 1.87e-5): the ball's
  2,208 smooth-shaded triangles seen from 4 units condition the hit's
  barycentrics, which the port computes IEEE-sequentially and XLA's CPU
  code does not (tests/test_torch_tlas.py states the same for the
  colonnade's columns).

(The bench loss's gradients under an environment map:
tests/test_torch_env_map_grad.py.)
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_golden_scenes import SCENES
from ray_tpu.render import light_sampling as jls
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.scene.env import build_env_cdf as j_build_env_cdf
from ray_tpu.scene.lights import LightDesc as JLightDesc
from ray_tpu.scene.lights import LightType as JLightType
from ray_tpu.scene.textures import TexturePacker as JPacker
from ray_tpu_torch.render import light_sampling as tls
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.scene.env import build_env_cdf
from ray_tpu_torch.scene.textures import TexturePacker
from ray_tpu_torch.utils import test_scenes as ts
from test_torch_render import _check
from test_torch_scene import _ARRAYS, _assert_same, _np_tree

W, H = 1920, 1080
SETTINGS = dict(max_total_depth=5, min_total_depth=2)
J_API = types.SimpleNamespace(scene_dir_env=SCENES["dir_env"],
                              LightDesc=JLightDesc, LightType=JLightType)
ENV_FIELDS = ("env_col", "env_map", "env_rotation", "env_marginal_cdf",
              "env_cond_cdf", "env_pdf", "textures")


@pytest.fixture(scope="module")
def scenes():
    """portal → (ray_tpu's env_map scene, its camera, the port's, its
    camera)."""
    out = {}
    for portal in (False, True):
        jsc, jcam = ts.env_map(J_API, portal=portal)
        tsc, tcam = ts.env_map(portal=portal)
        out[portal] = (jsc.finalize(), jcam, tsc.finalize(device="cpu"),
                       tcam)
    return out


def test_env_tables_match_ray_tpu(scenes):
    img = ts.env_map_image()
    for a, b in zip(build_env_cdf(img), j_build_env_cdf(img)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    tp, jp = TexturePacker(), JPacker()
    for p in (tp, jp):
        p.add(np.full((4, 4, 3), 0.25, np.float32))
        p.add(img, srgb=True, generate_mips=True)
    for tex_id, mip in ((0, 0), (1, 0), (1, 3)):
        a, b = tp.get_image(tex_id, mip), jp.get_image(tex_id, mip)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), (tex_id, mip)
    js, _, tsc, _ = scenes[False]
    assert (tsc.env_tab_h, tsc.env_tab_w) == (js.env_tab_h, js.env_tab_w) == (
        256, 512)
    for k in ENV_FIELDS + ("light_tree", "lights"):
        _assert_same(_np_tree(getattr(tsc, k)), _np_tree(getattr(js, k)), k)
    assert set(ENV_FIELDS) <= set(_ARRAYS)
    assert tsc.light_kinds == js.light_kinds


def _directions(n, seed):
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
             [0, 0, -1], [0.6, 0.8, 0], [0, 0.8, -0.6]]
    return d


def test_env_color_matches_ray_tpu(scenes):
    js, _, tsc, _ = scenes[False]
    L = _directions(4000, 3)
    ref = np.asarray(jls.env_color(js, jnp.asarray(L)))
    out = tls.env_color(tsc, torch.from_numpy(L)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)
    assert ref.max() > 5.0  # the sun is among the directions' texels


def test_sample_env_importance_matches_ray_tpu(scenes):
    js, _, tsc, _ = scenes[False]
    r = np.random.default_rng(5)
    r1, r2 = (r.random(4000).astype(np.float32) for _ in range(2))
    r1[:4] = [0.0, 0.9999999, 0.5, 1e-7]
    jL, jpdf = jls.sample_env_importance(js, jnp.asarray(r1), jnp.asarray(r2))
    tL, tpdf = tls.sample_env_importance(tsc, torch.from_numpy(r1),
                                         torch.from_numpy(r2))
    # the texel picked: its pdf is the table entry, bit for bit
    np.testing.assert_array_equal(tpdf.numpy(), np.asarray(jpdf))
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), rtol=0, atol=1e-5)
    # importance sampling favours bright texels: the mean pdf of the
    # samples, ∫p², is 1/4π for a uniform sampler and far above it here
    assert tpdf.numpy().mean() > 2.0 / (4.0 * np.pi)


def test_env_hit_pdf_matches_ray_tpu(scenes):
    js, _, tsc, _ = scenes[False]
    L = _directions(4000, 9)
    np.testing.assert_array_equal(
        tls.env_hit_pdf(tsc, torch.from_numpy(L)).numpy(),
        np.asarray(jls.env_hit_pdf(js, jnp.asarray(L))))


@pytest.mark.parametrize("portal", [False, True])
def test_env_map_tile_matches_ray_tpu(scenes, portal):
    """The tile spans the ball (its normals: the module docstring), the
    ground and the sky; with the portal, environment shadow rays pass
    only through it."""
    js, jcam, tsc, tcam = scenes[portal]
    x0, y0, tw, th = 944, 300, 32, 32
    ref = j_render(js, jcam, None, jnp.int32(x0), jnp.int32(y0),
                   jnp.uint32(1), jnp.uint32(0), width=W, height=H,
                   tile_w=tw, tile_h=th, settings=JPass(**SETTINGS),
                   use_filter_table=False)
    out = render_tile(tsc, tcam, None, x0, y0, 1, 0, width=W, height=H,
                      tile_w=tw, tile_h=th, settings=PassSettings(**SETTINGS),
                      use_filter_table=False)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    missed = (ref["depth_normal"] == 0).all(-1).mean()
    assert 0.0 < missed < 1.0 and ref["color"].mean() > 0.0
    n_close = np.isclose(out["depth_normal"][:, :3],
                         ref["depth_normal"][:, :3], rtol=0.0,
                         atol=2e-5).all(-1)
    assert n_close.mean() >= 0.999, n_close.mean()
    _check(dict(out, depth_normal=out["depth_normal"][:, 3:]),
           dict(ref, depth_normal=ref["depth_normal"][:, 3:]))
