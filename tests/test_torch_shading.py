"""ray_tpu_torch's shading stages against ray_tpu's on the same inputs.

Each stage gets identical inputs — the flagship Cornell scene or the
instanced colonnade finalized by each package (bit-identical tables,
tests/test_torch_scene.py, tests/test_torch_tlas.py), primary hits traced
once by ``ray_tpu``, and random numbers drawn with numpy — so a difference
belongs to the stage under test.  The colonnade cases cover the tlas
surface transforms, the texture fetches, the PRINCIPLED uber-BSDF and the
sphere lights.  Integer and bool outputs
must match exactly; floats within rtol 1e-5 / atol 1e-6, except where a
test states a wider bound and its reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.traverse import trace_closest_soa as j_trace
from ray_tpu.render import light_sampling as jls
from ray_tpu.render import raygen as jrg
from ray_tpu.render import surface as jsurf
from ray_tpu.render import uber as juber
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.render import light_sampling as tls
from ray_tpu_torch.render import raygen as trg
from ray_tpu_torch.render import surface as tsurf
from ray_tpu_torch.render import uber as tuber
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.render.radcache import make_cache
from ray_tpu_torch.scene.lights import LightDesc, LightType
from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell

# one intra-op thread, as in tests/test_torch_scene.py
torch.set_num_threads(1)

W, H = 1920, 1080
TILE = dict(x0=928, y0=516, tile_w=64, tile_h=48)
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, rtol=RTOL, atol=ATOL, mask=None):
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if mask is not None:
        p, r = p[mask], r[mask]
    if p.dtype in (np.bool_, np.int32, np.int64, np.uint32):
        np.testing.assert_array_equal(p, r.astype(p.dtype))
    else:
        np.testing.assert_allclose(p, r, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def flagship():
    jsc, jcam = j_cornell()
    tsc, tcam = t_cornell()
    js = jsc.finalize()
    ts = tsc.finalize(device="cpu")
    jr = jrg.generate_primary_rays(
        jcam, None, jnp.int32(TILE["x0"]), jnp.int32(TILE["y0"]),
        jnp.uint32(3), jnp.uint32(5), width=W, height=H,
        tile_w=TILE["tile_w"], tile_h=TILE["tile_h"], use_filter_table=False)
    R = TILE["tile_w"] * TILE["tile_h"]
    hit = j_trace(js.bvh_soa, js.tri_soa, jr.ro, jr.rd, jnp.zeros(R),
                  jr.t_max, jnp.ones(R, bool), max_leaf=js.max_leaf)
    return dict(js=js, ts=ts, jcam=jcam, tcam=tcam, jr=jr, hit=hit, R=R)


def test_generate_primary_rays(flagship):
    f = flagship
    tr = trg.generate_primary_rays(
        f["tcam"], None, TILE["x0"], TILE["y0"], 3, 5, width=W, height=H,
        tile_w=TILE["tile_w"], tile_h=TILE["tile_h"], use_filter_table=False,
        device="cpu")
    jr = f["jr"]
    _close(tr.px, jr.px)
    _close(tr.py, jr.py)
    _close(tr.ro, jr.ro)
    _close(tr.rd, jr.rd)
    _close(tr.t_max, jr.t_max)
    _close(tr.cone_spread, jr.cone_spread)


@pytest.mark.parametrize("filt", [0, 1, 2])
def test_filter_table_and_filtered_rays(flagship, filt):
    """``build_filter_table`` is numpy on both sides: bit-exact.  Rays
    through the table: same tolerance as the unfiltered rays."""
    from ray_tpu.scene.camera import build_filter_table as j_table
    from ray_tpu_torch.scene.camera import build_filter_table as t_table

    jt, tt = j_table(filt, 1.5), t_table(filt, 1.5)
    assert jt.dtype == tt.dtype and jt.tobytes() == tt.tobytes()
    f = flagship
    jr = jrg.generate_primary_rays(
        f["jcam"], jnp.asarray(jt), jnp.int32(TILE["x0"]),
        jnp.int32(TILE["y0"]), jnp.uint32(2), jnp.uint32(9), width=W,
        height=H, tile_w=TILE["tile_w"], tile_h=TILE["tile_h"],
        use_filter_table=True)
    tr = trg.generate_primary_rays(
        f["tcam"], tt, TILE["x0"], TILE["y0"], 2, 9, width=W, height=H,
        tile_w=TILE["tile_w"], tile_h=TILE["tile_h"], use_filter_table=True,
        device="cpu")
    _close(tr.ro, jr.ro)
    _close(tr.rd, jr.rd)


def _surfaces(f):
    h = f["hit"]
    jr = f["jr"]
    js_ = jsurf.compute_surface(f["js"], h.prim, h.u, h.v, h.backface,
                                jr.ro, jr.rd, h.t)
    ts_ = tsurf.compute_surface(f["ts"], _t(h.prim), _t(h.u), _t(h.v),
                                _t(h.backface), _t(jr.ro), _t(jr.rd), _t(h.t))
    return js_, ts_


def test_compute_surface(flagship):
    js_, ts_ = _surfaces(flagship)
    hits = _np(flagship["hit"].prim) >= 0
    assert hits.mean() > 0.5
    for name in ("P", "N", "plane_N", "T", "B", "uv", "tri_area",
                 "lod_base", "raw_tangent"):
        _close(getattr(ts_, name), getattr(js_, name), mask=hits)
    _close(ts_.backfacing, js_.backfacing)


def test_pick_material_and_light_id(flagship):
    f = flagship
    h = f["hit"]
    _close(tsurf.pick_hit_material(f["ts"], _t(h.prim), _t(h.backface)),
           jsurf.pick_hit_material(f["js"], h.prim, h.backface))
    _close(tsurf.hit_light_id(f["ts"], _t(h.prim)),
           jsurf.hit_light_id(f["js"], h.prim))


def _shade_inputs(f, seed):
    """Hit surfaces plus numpy-drawn directions, material ids and random
    numbers."""
    js_, ts_ = _surfaces(f)
    r = np.random.RandomState(seed)
    R = f["R"]
    L = r.randn(R, 3).astype(np.float32)
    L /= np.linalg.norm(L, axis=1, keepdims=True)
    rand2 = r.rand(R, 2).astype(np.float32)
    mix = r.rand(R).astype(np.float32)
    # every material (emissive included) and the -1 "no material" id
    n_mat = f["ts"].materials["type"].shape[0]
    mat_j = jnp.asarray(r.randint(-1, n_mat, R).astype(np.int32))
    return js_, ts_, L, rand2, mix, mat_j


def _params(f, js_, ts_, mat_j):
    h, jr = f["hit"], f["jr"]
    R = f["R"]
    jf = juber.mat_features(f["js"].mat_types)
    tf = tuber.mat_features(f["ts"].mat_types)
    jp = juber.gather_uber_params(
        f["js"], mat_j, js_.uv, jr.rd, js_.N, h.backface, jnp.ones(R),
        jnp.zeros((R, 2)), regularize_alpha=jnp.zeros(R), feats=jf)
    tp = tuber.gather_uber_params(
        f["ts"], _t(mat_j), ts_.uv, _t(jr.rd), ts_.N, _t(h.backface),
        torch.ones(R), None, regularize_alpha=torch.zeros(R), feats=tf)
    return jf, tf, jp, tp


def test_gather_uber_params(flagship):
    f = flagship
    js_, ts_, _, _, _, mat_j = _shade_inputs(f, 0)
    _, _, jp, tp = _params(f, js_, ts_, mat_j)
    for name in tp._fields:
        _close(getattr(tp, name), getattr(jp, name))
    assert bool(tp.is_emissive.any()) and bool((tp.w_diffuse > 0).any())


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_uber_diffuse(flagship, seed):
    f = flagship
    js_, ts_, L, _, _, mat_j = _shade_inputs(f, seed)
    jf, tf, jp, tp = _params(f, js_, ts_, mat_j)
    jfc, jpdf = juber.eval_uber(jp, js_.T, js_.B, js_.N, f["jr"].rd,
                                jnp.asarray(L), feats=jf)
    tfc, tpdf = tuber.eval_uber(tp, ts_.T, ts_.B, ts_.N, _t(f["jr"].rd),
                                _t(L), feats=tf)
    _close(tfc, jfc)
    _close(tpdf, jpdf)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_uber_diffuse(flagship, seed):
    f = flagship
    js_, ts_, _, rand2, mix, mat_j = _shade_inputs(f, seed)
    jf, tf, jp, tp = _params(f, js_, ts_, mat_j)
    jb = juber.sample_uber(jp, js_.T, js_.B, js_.N, f["jr"].rd,
                           jnp.asarray(rand2), jnp.asarray(mix), feats=jf)
    tb = tuber.sample_uber(tp, ts_.T, ts_.B, ts_.N, _t(f["jr"].rd),
                           _t(rand2), _t(mix), feats=tf)
    for name in tb._fields:
        _close(getattr(tb, name), getattr(jb, name))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_light_source(flagship, seed):
    f = flagship
    js_, ts_, _, rand2, mix, _ = _shade_inputs(f, seed)
    hits = _np(f["hit"].prim) >= 0
    jl = jls.sample_light_source(f["js"], js_.P, js_.T, js_.B, js_.N,
                                 jnp.asarray(mix), jnp.asarray(rand2))
    tl = tls.sample_light_source(f["ts"], ts_.P, ts_.T, ts_.B, ts_.N,
                                 _t(mix), _t(rand2))
    # Arvo's inversion (sample_spherical_triangle) runs arccos close to ±1,
    # where d acos/dx = -1/sqrt(1-x²) amplifies the few-ulp differences
    # between XLA's and PyTorch's float32 acos.  Measured over seeds 0-2:
    # up to 4.2e-4 in L, 9.6e-4 in the light point lp (the light is 0.5
    # units wide) and 1.3e-5 relative in the pdf — bounded here with ~2x
    # headroom.  Every other field must match at the default tolerance.
    wide = {"L": dict(atol=1e-3), "lp": dict(atol=2e-3),
            "pdf": dict(rtol=5e-5)}
    for name in tl._fields:
        _close(getattr(tl, name), getattr(jl, name), mask=hits,
               **wide.get(name, {}))


@pytest.mark.parametrize("seed", [0, 1])
def test_pick_light_tree_and_pick_pdf(flagship, seed):
    f = flagship
    js_, ts_, _, _, mix, _ = _shade_inputs(f, seed)
    hits = _np(f["hit"].prim) >= 0
    ji, jpdf, ju = jls.pick_light_tree(f["js"], js_.P, jnp.asarray(mix))
    ti, tpdf, tu = tls.pick_light_tree(f["ts"], ts_.P, _t(mix))
    _close(ti, ji, mask=hits)
    _close(tpdf, jpdf, mask=hits)
    _close(tu, ju, mask=hits)
    lid = np.random.RandomState(seed).randint(0, f["ts"].num_lights, f["R"])
    _close(tls.light_pick_pdf(f["ts"], ts_.P, _t(lid.astype(np.int32))),
           jls.light_pick_pdf(f["js"], js_.P, jnp.asarray(lid, jnp.int32)),
           mask=hits)


@pytest.mark.parametrize("seed", [0, 1])
def test_tri_light_hit_pdf(flagship, seed):
    f = flagship
    r = np.random.RandomState(seed)
    R = f["R"]
    light_tris = _np(f["ts"].lights["tri_index"])
    prim = light_tris[r.randint(0, len(light_tris), R)].astype(np.int32)
    ro = (r.rand(R, 3).astype(np.float32) - 0.5) * 1.8
    t = (r.rand(R).astype(np.float32) + 0.1) * 2.0
    I = r.randn(R, 3).astype(np.float32)
    I /= np.linalg.norm(I, axis=1, keepdims=True)
    pick = r.rand(R).astype(np.float32)
    jp = jls.tri_light_hit_pdf(f["js"], jnp.asarray(prim), jnp.asarray(t),
                               jnp.asarray(I), jnp.asarray(pick),
                               ro=jnp.asarray(ro))
    tp = tls.tri_light_hit_pdf(f["ts"], _t(prim), _t(t), _t(I), _t(pick),
                               ro=_t(ro))
    # spherical-triangle solid angle from arccos: see test_sample_light_source
    _close(tp, jp, rtol=5e-5)


def test_env_color_constant():
    jsc, _ = j_cornell("env")
    tsc, _ = t_cornell("env")
    js, ts = jsc.finalize(), tsc.finalize(device="cpu")
    L = np.random.RandomState(0).randn(64, 3).astype(np.float32)
    _close(tls.env_color(ts, _t(L)), jls.env_color(js, jnp.asarray(L)))


@pytest.mark.parametrize("seed", [0, 1])
def test_glossy_uber_matches_ray_tpu(flagship, seed):
    """A GLOSSY node (the GGX specular lobe alone, anisotropic here): the
    Cornell scene with a glossy box in each package, on the flagship's hits
    (the geometry is the same) with numpy-drawn material ids, directions
    and random numbers; ``gather_uber_params``, ``eval_uber`` and
    ``sample_uber`` within the default tolerance."""
    from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc

    glossy = dict(type=ShadingNode.GLOSSY, base_color=(0.8, 0.6, 0.3),
                  roughness=0.3, anisotropic=0.5)
    f = dict(flagship, js=j_cornell(box_material=JMaterialDesc(**glossy))[0]
             .finalize(),
             ts=t_cornell(box_material=MaterialDesc(**glossy))[0]
             .finalize(device="cpu"))
    js_, ts_, L, rand2, mix, mat_j = _shade_inputs(f, seed)
    jf, tf, jp, tp = _params(f, js_, ts_, mat_j)
    assert tf.glossy and tf.diffuse and not tf.principled
    for name in tp._fields:
        _close(getattr(tp, name), getattr(jp, name))
    assert bool((tp.w_specular == 1.0).any())
    jfc, jpdf = juber.eval_uber(jp, js_.T, js_.B, js_.N, f["jr"].rd,
                                jnp.asarray(L), feats=jf)
    tfc, tpdf = tuber.eval_uber(tp, ts_.T, ts_.B, ts_.N, _t(f["jr"].rd),
                                _t(L), feats=tf)
    _close(tfc, jfc)
    _close(tpdf, jpdf)
    jb = juber.sample_uber(jp, js_.T, js_.B, js_.N, f["jr"].rd,
                           jnp.asarray(rand2), jnp.asarray(mix), feats=jf)
    tb = tuber.sample_uber(tp, ts_.T, ts_.B, ts_.N, _t(f["jr"].rd),
                           _t(rand2), _t(mix), feats=tf)
    for name in tb._fields:
        _close(getattr(tb, name), getattr(jb, name))
    assert bool((tb.ray_type == tuber.RAY_TYPE_SPECULAR).any())


def _render_small(sc, cam):
    return render_tile(sc.finalize(device="cpu"), cam, None, 0, 0, 1, 0,
                       width=8, height=8, tile_w=8, tile_h=8,
                       settings=PassSettings(), use_filter_table=False)


@pytest.mark.parametrize("kind", ["rect", "dir"])
def test_unported_light_kinds_raise(kind):
    """The rect and directional lights raised here until ROADMAP Queue 1
    item 30 was ported, an environment map beside them until item 31 was,
    and an RGBE-compressed map until item 16 was; now all three render."""
    sc, cam = t_cornell(kind)
    out = _render_small(sc, cam)
    assert bool(torch.isfinite(out["color"]).all())
    tex = sc.add_texture(np.ones((4, 8, 3), np.float32))
    sc.set_environment((1.0, 1.0, 1.0), map_id=tex)
    out = _render_small(sc, cam)
    assert bool(torch.isfinite(out["color"]).all())
    tex = sc.add_texture(np.ones((4, 8, 3), np.float32), compress="rgbe")
    sc.set_environment((1.0, 1.0, 1.0), map_id=tex)
    out = _render_small(sc, cam)
    assert bool(torch.isfinite(out["color"]).all())


@pytest.mark.parametrize("node", [ShadingNode.REFRACTIVE,
                                  ShadingNode.TRANSPARENT, ShadingNode.MIX])
def test_unported_node_types_raise(node):
    """These node types raised here until ROADMAP Queue 1 item 29 was
    ported, and a normal map on them until item 32 was; now both render."""
    sc, cam = t_cornell(box_material=MaterialDesc(type=node))
    out = _render_small(sc, cam)
    assert bool(torch.isfinite(out["color"]).all())
    sc, cam = t_cornell(box_material=MaterialDesc(type=node, normal_map=0))
    assert sc.add_texture(np.full((4, 4, 3), 0.5, np.float32)) == 0
    out = _render_small(sc, cam)
    assert bool(torch.isfinite(out["color"]).all())


def test_unported_render_options_raise():
    sc, cam = t_cornell()
    scene = sc.finalize(device="cpu")
    # the SH-L1 output raised here until ROADMAP Queue 1 item 33 was ported
    # (tests/test_torch_sh_output.py)
    out = render_tile(scene, cam, None, 0, 0, 1, 0, width=8, height=8,
                      tile_w=8, tile_h=8,
                      settings=PassSettings(output_sh=True),
                      use_filter_table=False)
    assert tuple(out["shl1"].shape) == (64, 4, 3)
    assert bool(torch.isfinite(out["shl1"]).all())
    # a line light raised here until ROADMAP Queue 1 item 30 was ported,
    # per-ray-type visibility masks until item 20 was, and the radiance
    # cache until item 24 was (tests/test_torch_radcache.py); without a
    # cache to update the cache modes refuse
    sc2, cam2 = t_cornell()
    sc2.add_light(LightDesc(type=LightType.LINE, radius=0.1, height=0.5))
    assert bool(torch.isfinite(_render_small(sc2, cam2)["color"]).all())
    sc2.add_instance(0, visibility=1)
    assert bool(torch.isfinite(_render_small(sc2, cam2)["color"]).all())
    kw = dict(width=8, height=8, tile_w=8, tile_h=8, settings=PassSettings(),
              use_filter_table=False)
    out = render_tile(scene, cam, None, 0, 0, 1, 0, cache_mode="update",
                      cache=make_cache(1 << 8, device="cpu"), **kw)
    assert int(out["cache"].cnt_curr.sum()) > 0
    with pytest.raises(ValueError, match="needs a cache"):
        render_tile(scene, cam, None, 0, 0, 1, 0, cache_mode="update", **kw)


# ---------------------------------------------------------------------------
# The colonnade: tlas surfaces, textures, PRINCIPLED, sphere lights
# ---------------------------------------------------------------------------

CTILE = dict(x0=912, y0=500, tile_w=64, tile_h=48)


@pytest.fixture(scope="module")
def colonnade():
    from ray_tpu.ops.traverse import trace_closest_tlas as j_trace_tlas
    from ray_tpu.utils.test_scenes import colonnade_scene as j_colonnade
    from ray_tpu_torch.utils.test_scenes import colonnade_scene as t_colonnade

    jsc, jcam = j_colonnade()
    tsc, _ = t_colonnade()
    js = jsc.finalize()
    ts = tsc.finalize(device="cpu")
    jr = jrg.generate_primary_rays(
        jcam, None, jnp.int32(CTILE["x0"]), jnp.int32(CTILE["y0"]),
        jnp.uint32(1), jnp.uint32(0), width=W, height=H,
        tile_w=CTILE["tile_w"], tile_h=CTILE["tile_h"], use_filter_table=False)
    R = CTILE["tile_w"] * CTILE["tile_h"]
    hit = j_trace_tlas(js.bvh_soa, js.tri_soa, js.inst, jr.ro, jr.rd,
                       jnp.zeros(R), jr.t_max, jnp.ones(R, bool),
                       max_leaf=js.max_leaf, stack_size=js.stack_size)
    return dict(js=js, ts=ts, jr=jr, hit=hit, R=R)


def _col_surfaces(c):
    h, jr = c["hit"], c["jr"]
    js_ = jsurf.compute_surface(c["js"], h.prim, h.u, h.v, h.backface, jr.ro,
                                jr.rd, h.t, inst=h.inst)
    ts_ = tsurf.compute_surface(c["ts"], _t(h.prim), _t(h.u), _t(h.v),
                                _t(h.backface), _t(jr.ro), _t(jr.rd), _t(h.t),
                                inst=_t(h.inst))
    return js_, ts_


def test_colonnade_compute_surface_and_light_id(colonnade):
    c = colonnade
    js_, ts_ = _col_surfaces(c)
    h = c["hit"]
    hits = _np(h.prim) >= 0
    inst = _np(h.inst)[hits]
    # columns (0-63), terrain tiles (64-79) and the floor (80) are all hit
    assert inst.min() < 64 and ((inst >= 64) & (inst < 80)).any()
    assert (inst == 80).any()
    for name in ("P", "N", "plane_N", "T", "B", "uv", "tri_area",
                 "lod_base", "raw_tangent", "duv_major_unit", "aniso_elong"):
        _close(getattr(ts_, name), getattr(js_, name), mask=hits)
    _close(tsurf.hit_light_id(c["ts"], _t(h.prim), _t(h.inst)),
           jsurf.hit_light_id(c["js"], h.prim, h.inst))


@pytest.mark.parametrize("mode", ["bilinear", "stochastic", "aniso"])
def test_texture_lod_and_sample_bilinear(colonnade, mode):
    """Wrapped UVs (negative and past 1), every mip, texture id -1 (white)
    and 0: the stochastic taps pick the same texel (exact); the bilinear
    weights within the default tolerance."""
    from ray_tpu.scene.textures import sample_bilinear as j_sample
    from ray_tpu.scene.textures import texture_lod as j_lod
    from ray_tpu_torch.scene.textures import sample_bilinear as t_sample
    from ray_tpu_torch.scene.textures import texture_lod as t_lod

    r = np.random.RandomState({"bilinear": 0, "stochastic": 1, "aniso": 2}[mode])
    R = 4096
    jtex = c_tex = colonnade["js"].textures
    ttex = colonnade["ts"].textures
    tex_id = r.randint(-1, 1, R).astype(np.int32)
    uv = r.uniform(-1.5, 2.5, (R, 2)).astype(np.float32)
    lam = r.uniform(-14.0, 2.0, R).astype(np.float32)
    jl = j_lod(jtex, jnp.asarray(tex_id), jnp.asarray(lam))
    tl = t_lod(ttex, _t(tex_id), _t(lam))
    _close(tl, jl)
    assert 0.0 < float(tl.min()) or float(tl.max()) > 1.0
    kw_j, kw_t = {}, {}
    if mode != "bilinear":
        rand = r.rand(R, 2).astype(np.float32)
        kw_j["rand"], kw_t["rand"] = jnp.asarray(rand), _t(rand)
    if mode == "aniso":
        duv = r.uniform(-0.05, 0.05, (R, 2)).astype(np.float32)
        ar = r.rand(R).astype(np.float32)
        kw_j.update(aniso_duv=jnp.asarray(duv), aniso_rand=jnp.asarray(ar))
        kw_t.update(aniso_duv=_t(duv), aniso_rand=_t(ar))
    del c_tex
    jo = j_sample(jtex, jnp.asarray(tex_id), jnp.asarray(uv), jl, **kw_j)
    to = t_sample(ttex, _t(tex_id), _t(uv), tl, **kw_t)
    _close(to, jo)
    assert bool((to[_t(tex_id) < 0] == 1.0).all())


def _col_inputs(c, seed):
    js_, ts_ = _col_surfaces(c)
    r = np.random.RandomState(seed)
    R = c["R"]
    L = r.randn(R, 3).astype(np.float32)
    L /= np.linalg.norm(L, axis=1, keepdims=True)
    rand2 = r.rand(R, 2).astype(np.float32)
    mix = r.rand(R).astype(np.float32)
    tex_rand = r.rand(R, 2).astype(np.float32)
    lam = r.uniform(-12.0, -4.0, R).astype(np.float32)
    n_mat = c["ts"].materials["type"].shape[0]
    mat = r.randint(-1, n_mat, R).astype(np.int32)
    ext_ior = np.where(r.rand(R) < 0.2, 1.5, 1.0).astype(np.float32)
    reg = np.where(r.rand(R) < 0.5, 0.03, 0.0).astype(np.float32)
    return js_, ts_, L, rand2, mix, tex_rand, lam, mat, ext_ior, reg


def _col_params(c, seed):
    js_, ts_, L, rand2, mix, tex_rand, lam, mat, ext_ior, reg = _col_inputs(
        c, seed)
    h, jr = c["hit"], c["jr"]
    jf = juber.mat_features(c["js"].mat_types)
    tf = tuber.mat_features(c["ts"].mat_types)
    assert tf.principled and not tf.diffuse
    jp = juber.gather_uber_params(
        c["js"], jnp.asarray(mat), js_.uv, jr.rd, js_.N, h.backface,
        jnp.asarray(ext_ior), jnp.asarray(tex_rand),
        regularize_alpha=jnp.asarray(reg), lam=jnp.asarray(lam),
        feats=jf, fetch_kw={"rand": jnp.asarray(tex_rand)})
    tp = tuber.gather_uber_params(
        c["ts"], _t(mat), ts_.uv, _t(jr.rd), ts_.N, _t(h.backface),
        _t(ext_ior), _t(tex_rand), regularize_alpha=_t(reg), lam=_t(lam),
        feats=tf, fetch_kw={"rand": _t(tex_rand)})
    return js_, ts_, L, rand2, mix, jf, tf, jp, tp


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_uber_params_principled(colonnade, seed):
    _, _, _, _, _, _, _, jp, tp = _col_params(colonnade, seed)
    hits = _np(colonnade["hit"].prim) >= 0
    for name in tp._fields:
        _close(getattr(tp, name), getattr(jp, name), mask=hits)
    # textured, metallic and coated lanes all occur
    assert len(np.unique(_np(tp.base_color)[hits], axis=0)) > 100
    assert bool((tp.metallic == 1.0).any()) and bool((tp.w_specular > 0).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_uber_principled(colonnade, seed):
    c = colonnade
    js_, ts_, L, _, _, jf, tf, jp, tp = _col_params(c, seed)
    hits = _np(c["hit"].prim) >= 0
    jfc, jpdf = juber.eval_uber(jp, js_.T, js_.B, js_.N, c["jr"].rd,
                                jnp.asarray(L), feats=jf)
    tfc, tpdf = tuber.eval_uber(tp, ts_.T, ts_.B, ts_.N, _t(c["jr"].rd),
                                _t(L), feats=tf)
    _close(tfc, jfc, mask=hits)
    _close(tpdf, jpdf, mask=hits)
    assert float(tpdf[_t(hits)].max()) > 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_uber_principled(colonnade, seed):
    c = colonnade
    js_, ts_, _, rand2, mix, jf, tf, jp, tp = _col_params(c, seed)
    hits = _np(c["hit"].prim) >= 0
    jb = juber.sample_uber(jp, js_.T, js_.B, js_.N, c["jr"].rd,
                           jnp.asarray(rand2), jnp.asarray(mix), feats=jf)
    tb = tuber.sample_uber(tp, ts_.T, ts_.B, ts_.N, _t(c["jr"].rd),
                           _t(rand2), _t(mix), feats=tf)
    for name in tb._fields:
        _close(getattr(tb, name), getattr(jb, name), mask=hits)
    types = set(_np(tb.ray_type)[hits].tolist())
    assert {tuber.RAY_TYPE_DIFFUSE, tuber.RAY_TYPE_SPECULAR} <= types


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_light_source_sphere(colonnade, seed):
    c = colonnade
    js_, ts_, _, rand2, mix, *_ = _col_inputs(c, seed)
    hits = _np(c["hit"].prim) >= 0
    jl = jls.sample_light_source(c["js"], js_.P, js_.T, js_.B, js_.N,
                                 jnp.asarray(mix), jnp.asarray(rand2))
    tl = tls.sample_light_source(c["ts"], ts_.P, ts_.T, ts_.B, ts_.N,
                                 _t(mix), _t(rand2))
    # The sampled direction L agrees within 2.4e-7 (sin/cos ulps of the
    # cone map), but the point lp is L projected onto a 0.15-radius sphere
    # ~10 units away: -b - sqrt(b² - c) cancels near the silhouette and
    # scales L's difference by ~|P - pos|² / (radius · sqrt(b² - c)).
    # Measured over seeds 0-2: up to 8.5e-4 in lp (about 30 of 9,216
    # coordinates past the default tolerance); bounded at 2e-3, as the
    # flagship's triangle-light lp.  Every other field: default tolerance.
    for name in tl._fields:
        _close(getattr(tl, name), getattr(jl, name), mask=hits,
               **(dict(atol=2e-3) if name == "lp" else {}))
    sphere = _np(tl.area)[hits] > 0.0
    assert sphere.mean() > 0.5 and _np(tl.from_env)[hits].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_area_lights(colonnade, seed):
    """Rays from across the hall aimed near the 12 sphere lights: about
    half hit one; the hit, the light and its MIS pdf agree."""
    c = colonnade
    r = np.random.RandomState(seed)
    R = 2048
    pos = _np(c["ts"].lights["pos"])[:12]
    ro = r.uniform(-10.0, 10.0, (R, 3)).astype(np.float32)
    ro[:, 1] = r.uniform(0.2, 5.0, R)
    aim = pos[r.randint(0, 12, R)] + r.normal(0.0, 0.2, (R, 3))
    rd = (aim - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = np.where(r.rand(R) < 0.2, r.uniform(1.0, 10.0, R), 1e30)
    t_max = t_max.astype(np.float32)
    jo = jls.intersect_area_lights(c["js"], jnp.asarray(ro), jnp.asarray(rd),
                                   jnp.asarray(t_max))
    to = tls.intersect_area_lights(c["ts"], _t(ro), _t(rd), _t(t_max))
    hit = _np(to[1]) >= 0
    assert 0.2 < hit.mean() < 0.9
    _close(to[1], jo[1])
    for k in (0, 2, 3):
        _close(to[k], jo[k], mask=hit)
