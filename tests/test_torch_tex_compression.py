"""Compressed textures (BC1 / BC4 / BC5 / RGBE) against ray_tpu on the CPU.

* Every encoder (``_encode_blocks``, ``_encode_blocks_bc4``,
  ``_encode_blocks_bc5``, ``_encode_rgbe``) and host decoder
  (``_decode_blocks_np``, ``_decode_rgbe_np``) byte-equal to ray_tpu's on
  seeded images of even and odd sizes; ``TexturePacker.pack()`` byte-equal
  for each format with mips, mixed with raw records, and ``get_image``
  equal for every record.
* ``sample_bilinear`` on the packed tables at seeded uvs (wrapping past
  [0, 1]) and mip levels, in every filter mode — the 4-tap bilinear, the
  stochastic single tap and the anisotropic taps — within 1e-6 of ray_tpu's
  (bit-exact measured; the RGBE taps exact).
* A 32x32 tile of ``tex_features`` (the RGBE environment map, a BC1 base,
  BC4 roughness and BC5 normal map with a turned anisotropic frame on the
  ball, a raw ground texture) against ray_tpu's ``render_tile``:
  tests/test_torch_render.py's bounds, except the normals of
  ``depth_normal``, held to atol 5e-5 on ≥ 99.9% of pixels (measured
  3.3e-5): tests/test_torch_env_map.py's 2e-5 from the ball's
  ill-conditioned barycentrics, which move the uv at which the normal map
  is fetched.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.scene import textures as JT
from ray_tpu.scene.camera import make_camera as j_make_camera
from ray_tpu.scene.lights import LightDesc as JLightDesc
from ray_tpu.scene.lights import LightType as JLightType
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.materials import ShadingNode as JShadingNode
from ray_tpu.scene.scene import Scene as JScene
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.scene import textures as TT
from ray_tpu_torch.utils import test_scenes as ts
from test_torch_render import _check
from test_torch_scene import _assert_same

J_API = types.SimpleNamespace(
    Scene=JScene, make_camera=j_make_camera, MaterialDesc=JMaterialDesc,
    ShadingNode=JShadingNode, LightDesc=JLightDesc, LightType=JLightType)
FORMATS = (True, "bc1", "bc4", "bc5", "rgbe")


def _image(h, w, seed, hdr=False):
    r = np.random.default_rng(seed)
    img = r.random((h, w, 3)).astype(np.float32)
    if hdr:
        img *= np.float32(40.0) ** r.random((h, w, 1)).astype(np.float32)
        img[0, 0] = 0.0  # a black texel: exponent 0
    return img


@pytest.mark.parametrize("h,w", [(16, 16), (13, 7), (1, 5)])
def test_encoders_match_ray_tpu(h, w):
    img = _image(h, w, h * 31 + w)
    rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], -1)
    for name, arg in (("_encode_blocks", rgba),
                      ("_encode_blocks_bc4", rgba[..., 0]),
                      ("_encode_blocks_bc5", rgba)):
        a, b = getattr(TT, name)(arg), getattr(JT, name)(arg)
        assert a[1:] == b[1:], name
        _assert_same(a[0], b[0], name)
        for fmt in (1, 2, 3):
            _assert_same(TT._decode_blocks_np(a[0], w, h, fmt),
                         JT._decode_blocks_np(b[0], w, h, fmt), name)
    hdr = np.concatenate([_image(h, w, 5, hdr=True),
                          np.ones((h, w, 1), np.float32)], -1)
    words = TT._encode_rgbe(hdr)
    _assert_same(words, JT._encode_rgbe(hdr), "rgbe")
    _assert_same(TT._decode_rgbe_np(words, w, h),
                 JT._decode_rgbe_np(words, w, h), "rgbe decode")


def _packers():
    """Both packers with the same textures: raw, then every compressed
    format with mips (odd sizes included), then raw again."""
    tp, jp = TT.TexturePacker(), JT.TexturePacker()
    for p in (tp, jp):
        p.add(_image(8, 8, 1))
        for k, fmt in enumerate(FORMATS):
            p.add(_image(20 - 3 * k, 12 + k, 10 + k, hdr=fmt == "rgbe"),
                  srgb=fmt == "bc1", compress=fmt)
        p.add(_image(6, 10, 2), generate_mips=False)
    return tp, jp


def test_pack_and_get_image_match_ray_tpu():
    tp, jp = _packers()
    a, b = tp.pack(), jp.pack()
    assert {"blocks_t", "rgbe_t"} <= set(a)
    _assert_same(a, b, "textures")
    assert tp.num_mips == jp.num_mips
    for tex_id, n in enumerate(tp.num_mips):
        for mip in range(n):
            _assert_same(tp.get_image(tex_id, mip), jp.get_image(tex_id, mip),
                         f"get_image({tex_id}, {mip})")


@pytest.mark.parametrize("mode", ["bilinear", "stochastic", "aniso"])
def test_sample_bilinear_matches_ray_tpu(mode):
    tp, _ = _packers()
    pack = tp.pack()
    n_tex = len(tp.num_mips)
    r = np.random.default_rng({"bilinear": 1, "stochastic": 2,
                               "aniso": 3}[mode])
    R = 4096
    ids = r.integers(-1, n_tex, R).astype(np.int32)
    uv = r.uniform(-1.5, 2.5, (R, 2)).astype(np.float32)
    lod = r.uniform(0.0, 5.0, R).astype(np.float32)
    kw_j, kw_t = {}, {}
    if mode != "bilinear":
        rand = r.random((R, 2)).astype(np.float32)
        kw_j["rand"], kw_t["rand"] = jnp.asarray(rand), torch.from_numpy(rand)
    if mode == "aniso":
        duv = r.normal(0.0, 0.05, (R, 2)).astype(np.float32)
        ar = r.random(R).astype(np.float32)
        kw_j.update(aniso_duv=jnp.asarray(duv), aniso_rand=jnp.asarray(ar))
        kw_t.update(aniso_duv=torch.from_numpy(duv),
                    aniso_rand=torch.from_numpy(ar))
    jtex = {k: jnp.asarray(v) for k, v in pack.items()}
    ttex = {k: torch.from_numpy(v) for k, v in pack.items()}
    for lv in (None, lod):
        ref = np.asarray(JT.sample_bilinear(
            jtex, jnp.asarray(ids), jnp.asarray(uv),
            None if lv is None else jnp.asarray(lv), **kw_j))
        out = TT.sample_bilinear(
            ttex, torch.from_numpy(ids), torch.from_numpy(uv),
            None if lv is None else torch.from_numpy(lv), **kw_t).numpy()
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        fmt = pack["tex_fmt"][pack["tex_mip0"][np.maximum(ids, 0)]]
        rgbe = (fmt == 4) & (ids >= 0)
        np.testing.assert_array_equal(out[rgbe], ref[rgbe])


def test_tex_features_tile_matches_ray_tpu():
    jsc, jcam = ts.tex_features(J_API)
    tsc, tcam = ts.tex_features()
    scene = tsc.finalize(device="cpu")
    assert {"blocks_t", "rgbe_t"} <= set(scene.textures)
    assert scene.has_normal_maps and scene.has_aniso_rotation
    assert "wrows" in scene.bvh_soa and scene.env_tab_w == 512
    settings = dict(max_total_depth=5, min_total_depth=2)
    x0, y0, tw, th = 944, 300, 32, 32
    ref = j_render(jsc.finalize(), jcam, None, jnp.int32(x0), jnp.int32(y0),
                   jnp.uint32(1), jnp.uint32(0), width=1920, height=1080,
                   tile_w=tw, tile_h=th, settings=JPass(**settings),
                   use_filter_table=False)
    out = render_tile(scene, tcam, None, x0, y0, 1, 0, width=1920,
                      height=1080, tile_w=tw, tile_h=th,
                      settings=PassSettings(**settings),
                      use_filter_table=False)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    missed = (ref["depth_normal"] == 0).all(-1).mean()
    assert 0.0 < missed < 1.0 and ref["color"].mean() > 0.0
    n_close = np.isclose(out["depth_normal"][:, :3],
                         ref["depth_normal"][:, :3], rtol=0.0,
                         atol=5e-5).all(-1)
    assert n_close.mean() >= 0.999, n_close.mean()
    _check(dict(out, depth_normal=out["depth_normal"][:, 3:]),
           dict(ref, depth_normal=ref["depth_normal"][:, 3:]))
