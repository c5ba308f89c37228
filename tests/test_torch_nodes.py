"""The port's REFRACTIVE, TRANSPARENT and MIX nodes and principled alpha
against ray_tpu's, on the CPU.

One material table, built through each package's public API: DIFFUSE,
GLOSSY, REFRACTIVE, a transmissive PRINCIPLED, TRANSPARENT, a Fresnel MIX
(ior 1.5) of GLOSSY and DIFFUSE, an additive MIX, a MIX nesting a MIX, and
PRINCIPLED materials with alpha 0.4, alpha 0 and an alpha texture (each
expanded into Mix(Transparent, root)).  1,024 synthetic lanes (numpy seed)
draw a material id, a UV, view and normal directions, a side, an outside
IOR and random numbers; ``resolve_mix`` (with and without Fresnel),
``shadow_transmittance``, ``gather_uber_params``, ``eval_uber`` and
``sample_uber`` take them in both packages.  Integer and bool outputs
must match exactly; floats within rtol 1e-5 / atol 1e-6
(``tests/test_torch_shading.py``'s tolerances), except where stated.

Gradients of a shading loss with respect to every float material column
are held against ``jax.grad`` at ``tests/test_torch_grad.py``'s tolerance
(rtol 1e-3, atol 1e-3 of the column's largest entry).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.render import surface as jsurf
from ray_tpu.render import uber as juber
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.scene import Scene as JScene
from ray_tpu_torch.render import surface as tsurf
from ray_tpu_torch.render import uber as tuber
from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
from ray_tpu_torch.scene.scene import Scene
from ray_tpu_torch.utils.test_scenes import alpha_box

import test_torch_scene  # noqa: F401  (one intra-op thread)

RTOL, ATOL = 1e-5, 1e-6
R = 1024
N = ShadingNode


def _materials(desc, tex):
    """The node table's materials, in add order (ids 0-10)."""
    return [
        desc(type=N.DIFFUSE, base_color=(0.7, 0.6, 0.5), roughness=0.3),
        desc(type=N.GLOSSY, base_color=(0.9, 0.8, 0.7), roughness=0.2),
        desc(type=N.REFRACTIVE, base_color=(0.95, 1.0, 0.9), roughness=0.1,
             ior=1.45),
        desc(type=N.PRINCIPLED, base_color=(0.8, 0.9, 1.0), roughness=0.25,
             transmission=0.8, transmission_roughness=0.3, ior=1.5,
             specular=0.6, clearcoat=0.3),
        desc(type=N.TRANSPARENT, base_color=(0.9, 0.4, 0.3)),
        desc(type=N.MIX, strength=0.3, ior=1.5, mix_materials=(0, 1)),
        desc(type=N.MIX, strength=0.6, ior=0.0, mix_add=True,
             mix_materials=(2, 4)),
        desc(type=N.MIX, strength=0.5, ior=1.33, mix_materials=(5, 6)),
        desc(type=N.PRINCIPLED, base_color=(0.8, 0.6, 0.2), roughness=0.3,
             alpha=0.4),
        desc(type=N.PRINCIPLED, base_color=(0.2, 0.6, 0.8), alpha=0.0),
        desc(type=N.PRINCIPLED, base_color=(0.5, 0.5, 0.5), metallic=0.5,
             alpha_texture=tex),
    ]


def _scene(port):
    sc = Scene() if port else JScene()
    desc = MaterialDesc if port else JMaterialDesc
    r = np.random.RandomState(11)
    tex = sc.add_texture(r.rand(8, 8, 4).astype(np.float32))
    ids = [sc.add_material(d) for d in _materials(desc, tex)]
    sc.add_mesh(vertices=[[-1, 0, -1], [1, 0, -1], [1, 0, 1]],
                indices=[[0, 1, 2]], material=ids[0])
    return sc, ids, sc.finalize(**({"device": "cpu"} if port else {}))


@pytest.fixture(scope="module")
def tables():
    (jsc, jids, js), (tsc, tids, ts) = _scene(False), _scene(True)
    assert jids == tids
    return js, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, mask=None, rtol=RTOL, atol=ATOL):
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if mask is not None:
        p, r = p[mask], r[mask]
    if p.dtype in (np.bool_, np.int32, np.int64):
        np.testing.assert_array_equal(p, r.astype(p.dtype))
    else:
        np.testing.assert_allclose(p, r, rtol=rtol, atol=atol)


def _lanes(n_mat, seed):
    r = np.random.RandomState(seed)
    unit = lambda v: (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(  # noqa: E731
        np.float32)
    Nn = unit(r.normal(size=(R, 3)))
    I = r.normal(size=(R, 3))
    I = unit(np.where((I * Nn).sum(1, keepdims=True) > 0, -I, I))
    a = np.where(np.abs(Nn[:, :1]) > 0.9, [[0, 1, 0]], [[1, 0, 0]])
    T = unit(np.cross(a, Nn))
    B = np.cross(Nn, T).astype(np.float32)
    return dict(
        mat=r.randint(-1, n_mat, R).astype(np.int32),
        uv=r.rand(R, 2).astype(np.float32),
        I=I, N=Nn, T=T, B=B,
        back=r.rand(R) < 0.3,
        ext_ior=np.where(r.rand(R) < 0.5, 1.0, 1.33).astype(np.float32),
        mix_rand=r.rand(R).astype(np.float32),
        tex_rand=r.rand(R, 2).astype(np.float32),
        rand2=r.rand(R, 2).astype(np.float32),
        L=unit(r.normal(size=(R, 3))),
    )


def _jx(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("use_fresnel", [True, False])
def test_resolve_mix(tables, use_fresnel):
    """Mix chains resolve to the same leaf with the same rescaled random
    number and weight, with the shade stage's Fresnel factor and with the
    trace stage's resolve (no Fresnel, IORs of one)."""
    js, ts = tables
    x = _lanes(js.materials["type"].shape[0], 0)
    ior = x["ext_ior"] if use_fresnel else np.ones(R, np.float32)
    jo = jsurf.resolve_mix(js, _jx(x["mat"]), _jx(x["uv"]), _jx(x["mix_rand"]),
                           _jx(x["I"]), _jx(x["N"]), _jx(ior),
                           _jx(x["back"]), _jx(x["tex_rand"]),
                           use_fresnel=use_fresnel)
    to = tsurf.resolve_mix(ts, _t(x["mat"]), _t(x["uv"]), _t(x["mix_rand"]),
                           _t(x["I"]), _t(x["N"]), _t(ior), _t(x["back"]),
                           _t(x["tex_rand"]), use_fresnel=use_fresnel)
    for a, b in zip(to, jo):
        _close(a, b)
    types = _np(ts.materials["type"])
    leaf = _np(to[0])
    assert not (types[leaf[leaf >= 0]] == N.MIX).any()
    was_mix = (x["mat"] >= 0) & (types[np.clip(x["mat"], 0, None)] == N.MIX)
    assert len(set(leaf[was_mix].tolist())) >= 5
    assert (_np(to[2])[was_mix] != 1.0).any()  # the additive Mix's weight


def test_shadow_transmittance(tables):
    """The deterministic Mix-weighted transparent color of every material
    (0 for a solid leaf), through nested Mix nodes and the alpha
    texture."""
    js, ts = tables
    x = _lanes(js.materials["type"].shape[0], 1)
    jc = jsurf.shadow_transmittance(js, _jx(x["mat"]), _jx(x["uv"]))
    tc = tsurf.shadow_transmittance(ts, _t(x["mat"]), _t(x["uv"]))
    _close(tc, jc)
    tc = _np(tc)
    assert (tc == 0.0).all(-1).any() and ((tc > 0.0) & (tc < 0.9)).any()


def _uber_inputs(js, ts, seed):
    """Leaf ids from the shade-stage resolve, then the uber block of each
    package on the same lanes."""
    x = _lanes(js.materials["type"].shape[0], seed)
    leaf, mix_rand, _ = tsurf.resolve_mix(
        ts, _t(x["mat"]), _t(x["uv"]), _t(x["mix_rand"]), _t(x["I"]),
        _t(x["N"]), _t(x["ext_ior"]), _t(x["back"]), _t(x["tex_rand"]))
    x["leaf"], x["mix_rand"] = _np(leaf), _np(mix_rand)
    return x


def _gather(uber_mod, scene, x, conv, materials=None):
    if materials is not None:
        scene = dataclasses.replace(scene, materials=materials)
    feats = uber_mod.mat_features(scene.mat_types)
    p = uber_mod.gather_uber_params(
        scene, conv(x["leaf"]), conv(x["uv"]), conv(x["I"]), conv(x["N"]),
        conv(x["back"]), conv(x["ext_ior"]), conv(x["tex_rand"]),
        feats=feats)
    return feats, p


def _params(js, ts, x):
    jf, jp = _gather(juber, js, x, _jx)
    tf, tp = _gather(tuber, ts, x, _t)
    return jf, tf, jp, tp


def test_mat_features_and_gather(tables):
    js, ts = tables
    tf = tuber.mat_features(ts.mat_types)
    jf = juber.mat_features(js.mat_types)
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    assert tf.refractive and tf.transparent and tf.any_refr
    x = _uber_inputs(js, ts, 2)
    _, _, jp, tp = _params(js, ts, x)
    for name in tp._fields:
        _close(getattr(tp, name), getattr(jp, name))
    assert bool(tp.is_transparent.any())
    assert bool(((tp.w_refraction == 1.0) & (tp.trans_fresnel == 0.0)).any())


@pytest.mark.parametrize("seed", [3, 4])
def test_eval_and_sample_uber(tables, seed):
    """NEE evaluation and BSDF sampling over every leaf type: refraction
    on both sides (``L`` below the surface), the Transparent pass-through
    (ray type 5, delta pdf, weight = base color)."""
    js, ts = tables
    x = _uber_inputs(js, ts, seed)
    jf, tf, jp, tp = _params(js, ts, x)
    jfc, jpdf = juber.eval_uber(jp, _jx(x["T"]), _jx(x["B"]), _jx(x["N"]),
                                _jx(x["I"]), _jx(x["L"]), feats=jf)
    tfc, tpdf = tuber.eval_uber(tp, _t(x["T"]), _t(x["B"]), _t(x["N"]),
                                _t(x["I"]), _t(x["L"]), feats=tf)
    _close(tfc, jfc)
    _close(tpdf, jpdf)
    jb = juber.sample_uber(jp, _jx(x["T"]), _jx(x["B"]), _jx(x["N"]),
                           _jx(x["I"]), _jx(x["rand2"]), _jx(x["mix_rand"]),
                           feats=jf)
    tb = tuber.sample_uber(tp, _t(x["T"]), _t(x["B"]), _t(x["N"]),
                           _t(x["I"]), _t(x["rand2"]), _t(x["mix_rand"]),
                           feats=tf)
    for name in tb._fields:
        _close(getattr(tb, name), getattr(jb, name))
    types = set(_np(tb.ray_type).tolist())
    assert {tuber.RAY_TYPE_REFR, 5} <= types
    refr_eval = (_np(tpdf) > 0) & ((x["L"] * x["N"]).sum(1) < 0)
    assert refr_eval.any()


def test_principled_alpha_expansion():
    """``add_material`` expands principled alpha as ray_tpu does: the
    material tables, the solidity, the static flags and ids are equal, bit
    for bit — on the alpha box and on the node table."""
    from ray_tpu.scene.materials import ShadingNode as JN
    from ray_tpu.utils.test_scenes import cornell_scene as j_cornell

    jsc, _ = j_cornell("rect", box_material=JMaterialDesc(
        type=JN.PRINCIPLED, base_color=(0.8, 0.6, 0.2), roughness=0.3,
        alpha=0.5))
    tsc, _ = alpha_box()
    pairs = [(jsc, tsc), (_scene(False)[0], _scene(True)[0])]
    for j, t in pairs:
        assert [dataclasses.asdict(d) for d in t._materials] == [
            dataclasses.asdict(d) for d in j._materials]
        np.testing.assert_array_equal(t._material_solidity(),
                                      j._material_solidity())
        js, ts = j.finalize(), t.finalize(device="cpu")
        assert set(ts.materials) == set(js.materials)
        for k, v in js.materials.items():
            np.testing.assert_array_equal(_np(ts.materials[k]), np.asarray(v),
                                          err_msg=k)
        np.testing.assert_array_equal(_np(ts.tri_solid), np.asarray(js.tri_solid))
        for k in ("has_transparency", "has_mix", "mat_types", "has_textures"):
            assert getattr(ts, k) == getattr(js, k), k
        assert ts.has_transparency and ts.has_mix


# gradients: every float column of a table with REFRACTIVE and a
# transmissive PRINCIPLED node through gather → eval + sample
def _grad_loss_terms(uber_mod, p, x, conv, feats):
    fc, pdf = uber_mod.eval_uber(p, conv(x["T"]), conv(x["B"]), conv(x["N"]),
                                 conv(x["I"]), conv(x["L"]), feats=feats)
    bs = uber_mod.sample_uber(p, conv(x["T"]), conv(x["B"]), conv(x["N"]),
                              conv(x["I"]), conv(x["rand2"]),
                              conv(x["mix_rand"]), feats=feats)
    return fc, pdf, bs.weight


@pytest.mark.parametrize("node", ["principled_transmission", "refractive"])
def test_refraction_gradients_match_jax(tables, node):
    """d/d(material columns) of sum(f_cos) + sum(weight) + 1e-3·sum(pdf)
    of the refractive lanes (the transmissive PRINCIPLED material, id 3,
    or the REFRACTIVE one, id 2), against ``jax.grad``."""
    js, ts = tables
    x = _lanes(js.materials["type"].shape[0], 7)
    x["leaf"] = np.full(R, 3 if node == "principled_transmission" else 2,
                        np.int32)
    jfl = {k: v for k, v in js.materials.items()
           if jnp.issubdtype(v.dtype, jnp.floating)}

    def jloss(params):
        merged = dict(js.materials)
        merged.update(params)
        jf, jp = _gather(juber, js, x, _jx, merged)
        fc, pdf, w = _grad_loss_terms(juber, jp, x, _jx, jf)
        return jnp.sum(fc) + jnp.sum(w) + 1e-3 * jnp.sum(jnp.minimum(pdf, 1e3))

    j_g = jax.grad(jloss)(jfl)
    params = {k: v.clone().requires_grad_(True)
              for k, v in ts.materials.items() if v.is_floating_point()}
    merged = dict(ts.materials)
    merged.update(params)
    tf, tp = _gather(tuber, ts, x, _t, merged)
    fc, pdf, w = _grad_loss_terms(tuber, tp, x, _t, tf)
    loss = fc.sum() + w.sum() + 1e-3 * torch.clamp_max(pdf, 1e3).sum()
    loss.backward()
    moved = 0
    for k, gj in j_g.items():
        gj = np.asarray(gj)
        g = params[k].grad
        gt = np.zeros_like(gj) if g is None else g.numpy()
        assert np.isfinite(gt).all(), k
        scale = float(np.abs(gj).max())
        np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=k)
        moved += scale > 0.0
    assert np.abs(np.asarray(j_g["base_color"])).max() > 0.0
    assert np.abs(np.asarray(j_g["roughness"])).max() > 0.0
    assert moved >= 3
