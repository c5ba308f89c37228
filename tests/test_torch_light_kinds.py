"""The port's directional, rect, disk and line lights and sky portals
against ray_tpu's, on the CPU.

One scene, built through each package's public API: a floor, a DIR light
with angular spread and a delta one, a single- and a double-sided RECT, a
DISK, a LINE, a spot SPHERE, a RECT and a DISK sky portal, and a constant
environment (ten lights: the light tree picks; ``light_tree_min_lights=99``
makes the power CDF pick).  1,024 synthetic shading points (numpy seed)
around the lights feed ``sample_light_source``; rays aimed at the lights
feed ``intersect_area_lights`` and ``portal_shadow_block``; points from
0.3 to 300 units away from a rect feed ``sample_spherical_rectangle`` on
both sides of ``SPHERICAL_AREA_THRESHOLD``.

Tolerances are ``tests/test_torch_shading.py``'s: integers and bools
exact, floats within rtol 1e-5 / atol 1e-6, except where stated.  A
discrete branch (the spherical-rect threshold, a light's facing test, the
tree descent) may flip on a lane whose deciding value lies within a few
ulps of its bound; such lanes are counted and bounded, and every float
field is compared on the lanes where both packages took the same branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.render import light_sampling as jls
from ray_tpu.scene.lights import LightDesc as JLightDesc
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.scene import Scene as JScene
from ray_tpu_torch.render import light_sampling as tls
from ray_tpu_torch.scene.lights import LightDesc, LightType
from ray_tpu_torch.scene.materials import MaterialDesc
from ray_tpu_torch.scene.scene import Scene

import test_torch_scene  # noqa: F401  (one intra-op thread)

RTOL, ATOL = 1e-5, 1e-6
R = 1024

LIGHTS = [
    dict(type=LightType.DIR, color=(3.0, 2.5, 2.0),
         direction=(0.3, -0.9, 0.2), angle=8.0),
    dict(type=LightType.DIR, color=(1.0, 1.0, 1.0),
         direction=(-0.4, -0.8, -0.3), angle=0.0),
    dict(type=LightType.RECT, color=(14.0, 13.0, 12.0),
         position=(-0.3, 0.96, 0.1), axis_u=(1, 0, 0), axis_v=(0, 0, 1),
         width=0.4, height=0.4),
    dict(type=LightType.RECT, color=(5.0, 6.0, 7.0),
         position=(0.6, 0.5, 0.6), axis_u=(0, 0, 1), axis_v=(0, 1, 0),
         width=0.3, height=0.5, doublesided=True),
    dict(type=LightType.DISK, color=(30.0, 32.0, 34.0),
         position=(0.5, 0.9, -0.4), axis_u=(0.894, 0.447, 0.0),
         axis_v=(0, 0, 1), width=0.3, height=0.3),
    dict(type=LightType.LINE, color=(40.0, 45.0, 50.0),
         position=(-0.6, 0.8, 0.0), axis_u=(1, 0, 0), axis_v=(0, 0, 1),
         radius=0.01, height=0.8),
    dict(type=LightType.SPHERE, color=(25.0, 20.0, 15.0),
         position=(0.5, 0.7, -0.5), radius=0.08,
         direction=(-0.5, -0.81, 0.3), spot_size=40.0, spot_blend=0.04),
    dict(type=LightType.RECT, color=(1.0, 1.0, 1.0),
         position=(0.0, 1.5, 0.0), axis_u=(1, 0, 0), axis_v=(0, 0, 1),
         width=1.0, height=0.8, sky_portal=True),
    dict(type=LightType.DISK, color=(1.0, 1.0, 1.0),
         position=(-1.5, 0.6, 0.0), axis_u=(0, 0, 1), axis_v=(0, 1, 0),
         width=0.6, height=0.6, sky_portal=True),
]


def _scene(port, tree):
    sc = Scene() if port else JScene()
    mat = (MaterialDesc if port else JMaterialDesc)(base_color=(0.6,) * 3)
    m = sc.add_material(mat)
    sc.add_mesh(vertices=[[-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4]],
                indices=[[0, 1, 2], [0, 2, 3]], material=m)
    desc = LightDesc if port else JLightDesc
    for d in LIGHTS:
        sc.add_light(desc(**d))
    sc.set_environment((0.3, 0.45, 0.7))
    kw = {} if tree else dict(light_tree_min_lights=99)
    if port:
        kw["device"] = "cpu"
    return sc.finalize(**kw)


@pytest.fixture(scope="module")
def scenes():
    out = {tree: (_scene(False, tree), _scene(True, tree))
           for tree in (True, False)}
    assert out[True][1].light_tree_depth > 0
    assert out[False][1].light_tree_depth == 0
    return out


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


# the spherical rectangle's solid angle is four angles summed minus 2π
# (Ureña's g0 + g1 - k): float32 leaves it an absolute error of a few ulps
# of 2π (4.8e-7 each) in either package, so its pdf = 1/Ω is compared as
# Ω = pick / pdf within 8 such ulps (1e-5 relative on top)
OMEGA_ATOL = 8 * 4.8e-7


def _omega_close(pdf_t, pdf_j, pick, mask):
    pick = _np(pick)[mask]
    o_t = pick / _np(pdf_t)[mask]
    o_j = pick / _np(pdf_j)[mask]
    np.testing.assert_allclose(o_t, o_j, rtol=1e-5, atol=OMEGA_ATOL)


def _frames(r, n):
    """Random unit normals and the tangent frames around them."""
    N = r.normal(size=(n, 3)).astype(np.float32)
    N /= np.linalg.norm(N, axis=1, keepdims=True)
    a = np.where(np.abs(N[:, :1]) > 0.9, [[0, 1, 0]], [[1, 0, 0]])
    T = np.cross(a, N)
    T /= np.linalg.norm(T, axis=1, keepdims=True)
    B = np.cross(N, T)
    return T.astype(np.float32), B.astype(np.float32), N


@pytest.mark.parametrize("tree", [True, False], ids=["tree", "cdf"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_light_source_kinds(scenes, tree, seed):
    """Every light of the table is picked; each field agrees lane by lane
    where the pick agrees.  The tree descent compares float importances:
    the pick may differ on a lane whose importances tie to a few ulps
    (≤ 2 of 1,024 lanes).  The sphere light's lp is bounded at 2e-3, as in
    ``tests/test_torch_shading.py``.  The rect lights' L, lp and pdf run
    through Ureña's inversion (arccos and rsqrt chains near ±1), which
    amplifies the ulp differences of the transcendentals by about
    1/sin(elevation) of the shading point over the rect's plane: measured
    over seeds 0-1 (~490 rect lanes) within 2.4e-5 in L and lp where the
    elevation is over 0.5°, and 1.0e-2 in L on the one lane at 0.06°.
    Bounds: L 1e-3 and lp 2e-3 (the shading test's bounds for the triangle
    light's Arvo inversion) above 0.5°, where the pdf is held as a solid
    angle (``OMEGA_ATOL``); below 0.5° (~1% of the rect lanes, ≤ 3%) only
    the discrete fields."""
    js, ts = scenes[tree]
    r = np.random.RandomState(seed)
    P = r.uniform([-1.8, -0.99, -1.8], [1.8, 1.4, 1.8], (R, 3))
    P = P.astype(np.float32)
    T, B, N = _frames(r, R)
    pick = r.rand(R).astype(np.float32)
    uv = r.rand(R, 2).astype(np.float32)
    jl = jls.sample_light_source(js, jnp.asarray(P), jnp.asarray(T),
                                 jnp.asarray(B), jnp.asarray(N),
                                 jnp.asarray(pick), jnp.asarray(uv))
    tl = tls.sample_light_source(ts, _t(P), _t(T), _t(B), _t(N), _t(pick),
                                 _t(uv))
    if tree:
        ji, _, _ = jls.pick_light_tree(js, jnp.asarray(P), jnp.asarray(pick))
        ti, pick_p, _ = tls.pick_light_tree(ts, _t(P), _t(pick))
    else:
        cdf = _np(js.lights["pick_cdf"])
        ji = ti = np.clip(np.searchsorted(cdf, pick, side="right"), 0,
                          cdf.shape[0] - 1)
        pick_p = _np(ts.lights["pick_pdf"])[ti]
    same = _np(ti) == _np(ji)
    assert (~same).sum() <= 2, (~same).sum()
    kinds = _np(ts.lights["type"])[np.clip(_np(ti), 0, None)]
    assert set(kinds[same].tolist()) == {0, 1, 2, 3, 4, 6}
    rect = kinds == LightType.RECT
    li = np.clip(_np(ti), 0, None)
    n = np.cross(_np(ts.lights["u"])[li], _np(ts.lights["v"])[li])
    off = P - _np(ts.lights["pos"])[li]
    sin_elev = np.abs((off * n).sum(1)) / np.linalg.norm(off, axis=1)
    grazing = rect & (sin_elev < np.sin(np.radians(0.5)))
    assert grazing.sum() <= 0.03 * rect.sum(), grazing.sum()
    wide = {"L": dict(atol=1e-3), "lp": dict(atol=2e-3)}
    for name in tl._fields:
        fp = getattr(tl, name)
        _close(fp, getattr(jl, name), mask=same & ~rect,
               **(dict(atol=2e-3) if name == "lp" else {}))
        if name == "pdf":
            ok = same & rect & ~grazing & (_np(fp) > 0.0)
            _omega_close(fp, jl.pdf, pick_p, ok)
            continue
        exact = fp.dtype == torch.bool
        _close(fp, getattr(jl, name),
               mask=same & (rect if exact else rect & ~grazing),
               **wide.get(name, {}))
    assert _np(tl.from_env)[same & rect].any()  # a portal's environment


def test_sample_spherical_rectangle_threshold():
    """Points from 0.3 to 300 units off a 0.4 x 0.4 rect: the solid angle
    falls through SPHERICAL_AREA_THRESHOLD (5e-5) near 57 units, so both
    branches are well populated.  ``valid`` is a comparison of a float
    area against the threshold: it may flip on lanes whose area lies within
    ulps of it (≤ 2 of 1,024).  On lanes valid in both packages and more
    than 0.5° above the rect's plane the solid angle 1/pdf agrees within
    ``OMEGA_ATOL`` and the direction to the point within 1e-3, the bound
    of L in ``test_sample_light_source_kinds`` (Ureña's inversion: at
    grazing elevation its arccos chain amplifies ulps — measured 3e-5 in
    the solid angle on one lane; the point itself, up to 57 units away,
    moves by up to 7.5e-3 along a direction error of 1.5e-4);
    the fallback lanes' pdf is the caller's, so only ``valid`` is compared
    there."""
    r = np.random.RandomState(3)
    d = np.exp(r.uniform(np.log(0.3), np.log(300.0), R)).astype(np.float32)
    w = r.normal(size=(R, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w[:, 1] = -np.abs(w[:, 1])  # below the rect (its front faces -y)
    pos = np.array([-0.3, 0.96, 0.1], np.float32)
    P = (pos + w * d[:, None]).astype(np.float32)
    u = np.broadcast_to(np.array([0.4, 0, 0], np.float32), (R, 3))
    v = np.broadcast_to(np.array([0, 0, 0.4], np.float32), (R, 3))
    lp = np.broadcast_to(pos, (R, 3))
    r1, r2 = r.rand(R).astype(np.float32), r.rand(R).astype(np.float32)
    jpdf, jp, jok = jls.sample_spherical_rectangle(
        *(jnp.asarray(a) for a in (P, lp, u, v, r1, r2)))
    tpdf, tp, tok = tls.sample_spherical_rectangle(
        *(_t(a) for a in (P, lp, u, v, r1, r2)))
    jok, tok = _np(jok), _np(tok)
    assert (jok != tok).sum() <= 2, (jok != tok).sum()
    both = jok & tok
    assert both.sum() > 200 and (~jok & ~tok).sum() > 200
    grazing = np.abs(w[:, 1]) < np.sin(np.radians(0.5))
    assert grazing.sum() <= 0.03 * R, grazing.sum()
    both = both & ~grazing
    _omega_close(tpdf, jpdf, np.ones(R, np.float32), both)
    def unit(p):
        d = _np(p) - P
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    _close(unit(tp), unit(jp), mask=both, atol=1e-3)
    # the points lie on the rect's plane, inside it
    on = _np(tp)[both]
    assert np.abs(on[:, 1] - pos[1]).max() < 1e-3
    assert (np.abs(on[:, [0, 2]] - pos[[0, 2]]) <= 0.2 + 1e-3).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_area_lights_kinds(scenes, seed):
    """Rays aimed near the rect, disk, line and sphere lights: the light
    hit agrees lane by lane (a hit at a light's edge decides on a float
    compare: ≤ 2 of 1,024 lanes may differ), and t, the MIS pdf and the
    spot factor agree where it does (a rect's pdf is the spherical-rect
    one: held as a solid angle, ``OMEGA_ATOL``)."""
    js, ts = scenes[True]
    r = np.random.RandomState(seed)
    pos = np.array([d.get("position", (0, 0, 0)) for d in LIGHTS[2:7]],
                   np.float32)
    ro = r.uniform(-1.5, 1.5, (R, 3)).astype(np.float32)
    ro[:, 1] = r.uniform(-0.9, 0.3, R)
    aim = pos[r.randint(0, len(pos), R)] + r.normal(0.0, 0.12, (R, 3))
    rd = (aim - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = np.where(r.rand(R) < 0.2, r.uniform(0.5, 2.0, R), 1e30)
    t_max = t_max.astype(np.float32)
    jo = jls.intersect_area_lights(js, jnp.asarray(ro), jnp.asarray(rd),
                                   jnp.asarray(t_max))
    to = tls.intersect_area_lights(ts, _t(ro), _t(rd), _t(t_max))
    same = _np(to[1]) == _np(jo[1])
    assert (~same).sum() <= 2, (~same).sum()
    hit = same & (_np(to[1]) >= 0)
    kinds = _np(ts.lights["type"])[_np(to[1])[hit]]
    assert set(kinds.tolist()) >= {LightType.RECT, LightType.DISK,
                                   LightType.LINE, LightType.SPHERE}
    is_rect = np.zeros(R, bool)
    is_rect[hit] = kinds == LightType.RECT
    pick = tls.light_pick_pdf(ts, _t(ro), to[1])
    _close(to[0], jo[0], mask=hit)
    _close(to[2], jo[2], mask=hit & ~is_rect)
    _omega_close(to[2], jo[2], pick, is_rect)
    _close(to[3], jo[3], mask=hit)


def test_portal_shadow_block(scenes):
    """Shadow rays from the floor toward the sky: the two portals block
    the rays that cross them from their back (emitting) side within the
    ray's length; a crossing right at the portal's edge is a float
    compare (≤ 2 of 1,024 lanes)."""
    js, ts = scenes[True]
    r = np.random.RandomState(5)
    ro = r.uniform([-2.0, -0.99, -1.0], [1.0, -0.5, 1.0], (R, 3))
    ro = ro.astype(np.float32)
    target = np.where(r.rand(R, 1) < 0.5, [[0.0, 1.5, 0.0]],
                      [[-1.5, 0.6, 0.0]])
    rd = target + r.normal(0.0, 0.4, (R, 3)) - ro
    rd = np.where(r.rand(R, 1) < 0.1, -rd, rd).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    dist = np.where(r.rand(R) < 0.3, r.uniform(0.5, 2.0, R), 3.4e30)
    dist = dist.astype(np.float32)
    jb = _np(jls.portal_shadow_block(js, jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.asarray(dist)))
    tb = _np(tls.portal_shadow_block(ts, _t(ro), _t(rd), _t(dist)))
    assert (jb != tb).sum() <= 2, (jb != tb).sum()
    assert 0.1 < tb.mean() < 0.9, tb.mean()
