"""Normal maps and the anisotropic tangent rotation against ray_tpu.

* ``apply_normal_map`` and ``apply_tangent_rotation`` on 1,024 seeded
  lanes (random orthonormal frames, geometric normals tilted off the
  shading ones, view directions on both sides, uvs across the map, LOD
  and stochastic taps; materials with and without a normal map, with
  rotations of 0, 0.25 and past 1, which clips) of a scene with a BC5
  normal map: N, T and B within 1e-6, and the reflection clamp taken on
  some lanes.  In ray_tpu's order: the normal map, then the rotation.
* The bench loss's gradients (tests/test_torch_grad.py's loss, tile
  settings and gates: rtol 1e-3, atol 1e-3 of the column's largest entry)
  w.r.t. every float material column and ``env_col``, on a 16x16 tile of
  the flagship Cornell box whose tall box is GLOSSY, ``anisotropic=0.6``
  turned by ``anisotropic_rotation=0.25``, with ``tex_features``' BC1 base
  texture and BC5 normal map at intensity 0.8 (the ``tex_features``
  material on a cheaper node: ray_tpu's PRINCIPLED ball compiles for over
  a minute, tests/test_torch_env_map_grad.py).  The reference is
  ``jax.jvp`` of ray_tpu's loss along each of the 128 scalars, batched
  under ``jax.vmap`` (measured: every column within 5.3e-5 of its scale):
  ray_tpu's reverse mode gives NaN in the ``anisotropic``,
  ``anisotropic_rotation``, ``normal_map_intensity`` and ``roughness``
  columns there (its one-hot matmul reads carry a NaN lane's cotangent to
  every material; ``anisotropic``'s is NaN on ``env_map``'s ball too),
  and forward mode does not.
"""

import dataclasses
import types

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_scene  # noqa: F401  (one torch thread)
from ray_tpu.render import surface as JS
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.materials import ShadingNode as JShadingNode
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.render import surface as TS
from ray_tpu_torch.utils import test_scenes as ts
from test_torch_grad import _assert_matches_jax, _port_grads

R = 1024
# the gradient tile: tests/test_torch_grad.py's size and depth, on the tall
# box's front face
W, H, RES = 1920, 1080, 16
X0, Y0 = 1088, 824
DEPTH = dict(max_total_depth=3, min_total_depth=3)


def textured_box(api):
    """The flagship Cornell box whose tall box is GLOSSY, anisotropic and
    turned, with ``tex_features``' BC1 base texture and BC5 normal map
    (textures 0 and 1).  Returns (Scene, Camera)."""
    sc, cam = api.cornell_scene("emissive_quad", box_material=api.MaterialDesc(
        type=api.ShadingNode.GLOSSY, base_color=(0.9, 0.8, 0.7),
        base_texture=0, roughness=0.35, normal_map=1,
        normal_map_intensity=0.8, anisotropic=0.6,
        anisotropic_rotation=0.25))
    base, _, normal, _ = ts.tex_features_images()
    assert sc.add_texture(base, srgb=True, compress="bc1") == 0
    assert sc.add_texture(normal, compress="bc5") == 1
    return sc, cam


J_API = types.SimpleNamespace(cornell_scene=j_cornell,
                              MaterialDesc=JMaterialDesc,
                              ShadingNode=JShadingNode)


def _frames(r):
    n = r.normal(size=(R, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    a = np.where(np.abs(n[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
    t = np.cross(n, a)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    b = np.cross(n, t)
    pn = n + 0.3 * r.normal(size=(R, 3))
    pn /= np.linalg.norm(pn, axis=1, keepdims=True)
    raw = t + 0.2 * r.normal(size=(R, 3))
    return [x.astype(np.float32) for x in (n, pn, t, b, raw)]


def _surfaces(r):
    N, pN, T, B, raw = _frames(r)
    uv = r.uniform(-0.5, 1.5, (R, 2)).astype(np.float32)
    f = dict(P=np.zeros((R, 3), np.float32), N=N, plane_N=pN, T=T, B=B,
             uv=uv, backfacing=np.zeros(R, bool),
             tri_area=np.ones(R, np.float32),
             lod_base=np.zeros(R, np.float32),
             duv_major_unit=np.zeros((R, 2), np.float32),
             aniso_elong=np.zeros(R, np.float32), raw_tangent=raw)
    js = JS.Surface(**{k: jnp.asarray(v) for k, v in f.items()})
    tsf = TS.Surface(**{k: torch.from_numpy(v) for k, v in f.items()})
    return js, tsf


def test_normal_map_and_rotation_match_ray_tpu():
    jsc = textured_box(J_API)[0].finalize()
    tsc = textured_box(ts.port_api())[0].finalize(device="cpu")
    r = np.random.default_rng(8)
    js, tsf = _surfaces(r)
    # the box's material (with the maps) and the white walls' (without)
    box = int(np.flatnonzero(np.asarray(jsc.materials["normal_map"]) >= 0)[0])
    mat = np.where(r.random(R) < 0.75, box, 0).astype(np.int32)
    I = r.normal(size=(R, 3))
    I = (I / np.linalg.norm(I, axis=1, keepdims=True)).astype(np.float32)
    rand = r.random((R, 2)).astype(np.float32)
    lam = r.uniform(-12.0, -4.0, R).astype(np.float32)
    jn = JS.apply_normal_map(jsc, jnp.asarray(mat), js, jnp.asarray(I),
                             jnp.asarray(rand), lam=jnp.asarray(lam),
                             fetch_kw={"rand": jnp.asarray(rand)})
    tn = TS.apply_normal_map(tsc, torch.from_numpy(mat), tsf,
                             torch.from_numpy(I), torch.from_numpy(rand),
                             lam=torch.from_numpy(lam),
                             fetch_kw={"rand": torch.from_numpy(rand)})
    for k in ("N", "T", "B"):
        np.testing.assert_allclose(getattr(tn, k).numpy(),
                                   np.asarray(getattr(jn, k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    moved = ~np.isclose(tn.N.numpy(), js.N, atol=1e-3).all(-1)
    clamped = np.isclose(tn.N.numpy(), js.plane_N, atol=1e-7).all(-1)
    assert moved[mat == box].mean() > 0.5 and not moved[mat == 0].any()
    assert 0 < clamped.sum() < (mat == box).sum()
    # the rotation after the map, on materials turned by 0.25, 0 and 1.7
    turned_T = {}
    for rot in (0.25, 0.0, 1.7):
        jm = dict(jsc.materials, anisotropic_rotation=jnp.full_like(
            jsc.materials["anisotropic_rotation"], rot))
        tm = dict(tsc.materials, anisotropic_rotation=torch.full_like(
            tsc.materials["anisotropic_rotation"], rot))
        jr = JS.apply_tangent_rotation(
            dataclasses.replace(jsc, materials=jm),
            jnp.asarray(mat), jn)
        tr = TS.apply_tangent_rotation(
            dataclasses.replace(tsc, materials=tm),
            torch.from_numpy(mat), tn)
        for k in ("N", "T", "B"):
            np.testing.assert_allclose(getattr(tr, k).numpy(),
                                       np.asarray(getattr(jr, k)), rtol=0,
                                       atol=1e-6, err_msg=(rot, k))
        turned_T[rot] = tr.T.numpy()
    turned = ~np.isclose(turned_T[0.25], turned_T[0.0], atol=1e-3).all(-1)
    assert turned.all()  # every material turned by the same 0.25


@pytest.fixture(scope="module")
def jvp_reference():
    """ray_tpu's loss and its gradient in every float column and env_col,
    one forward-mode product per scalar."""
    sc, cam = textured_box(J_API)
    scene = sc.finalize()
    mat_f = {k: v for k, v in scene.materials.items()
             if jnp.issubdtype(v.dtype, jnp.floating)}

    def loss_fn(mats, env):
        s = dataclasses.replace(scene, materials={**scene.materials, **mats},
                                env_col=env)
        out = j_render(s, cam, None, jnp.int32(X0), jnp.int32(Y0),
                       jnp.uint32(1), jnp.uint32(0), width=W, height=H,
                       tile_w=RES, tile_h=RES, settings=JPass(**DEPTH),
                       use_filter_table=False)
        return jnp.sum(out["color"] ** 2) / (H * W * 3)

    flat, unravel = jax.flatten_util.ravel_pytree((mat_f, scene.env_col))

    def along(t):
        return jax.jvp(lambda x: loss_fn(*unravel(x)), (flat,), (t,))

    loss, dloss = jax.jit(jax.vmap(along))(
        jnp.eye(flat.shape[0], dtype=flat.dtype))
    mats, env = unravel(dloss)
    grads = {k: np.asarray(g) for k, g in mats.items()}
    grads["env_col"] = np.asarray(env)
    return float(loss[0]), grads


def test_textured_box_gradients_match_jax(jvp_reference):
    """On the tall box's front face (depth 3, 16x16)."""
    j_loss, j_g = jvp_reference
    sc, cam = textured_box(ts.port_api())
    t_loss, t_g = _port_grads(sc.finalize(device="cpu"), cam, X0, Y0)
    assert j_loss > 0.0
    _assert_matches_jax(t_loss, t_g, j_loss, j_g)
    for k in ("base_color", "roughness", "normal_map_intensity",
              "anisotropic", "anisotropic_rotation", "env_col"):
        assert np.abs(j_g[k]).max() > 0.0, k
