"""Transparency in the port's integrator against ray_tpu's, on the CPU.

``alpha_box`` (``ray_tpu_torch.utils.test_scenes``): the rect-lit Cornell
box whose tall box is a PRINCIPLED material with alpha 0.5, expanded into
Mix(Transparent, principled).  A 32x24 tile of the 1920x1080 frame lies
wholly on the box, so every camera ray meets it: the closest-hit march
(``_trace_closest_through``) carries rays through its transparent sides,
the shadow march (``_trace_transmittance``) tints shadow rays through it,
and the shade stage resolves the Mix.  Depth 5, 1 spp, as
``tests/test_torch_render.py``.

The box stands on the floor: its bottom face lies in the floor's plane.
A ray leaving a point inside the transparent box downward meets both
triangles at one t, and which one it reports is decided by the last ulp of
the ray, which differs between XLA's and PyTorch's transcendentals
(tests/test_torch_render.py).  The two packages then shade different
materials on that lane.  Measured on this tile: 12 of 768 pixels past the
color bound (98.4% close), mean within 5.3e-4 relative, rays 0.26% apart;
and with the box lifted 2 mm off the floor every pixel agrees (mean within
1.5e-6, rays equal) on this and four other tiles.  So the box on the floor is
held at ``tests/test_torch_render.py``'s bounds except the close-pixel
fraction, ≥ 97%; the lifted box's tile at all of them.

The bench loss's gradient: ``tests/test_torch_transparency_grad.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu_torch.render import integrator as tint
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.utils import trace
from ray_tpu_torch.utils.test_scenes import alpha_box

import test_torch_scene  # noqa: F401  (one intra-op thread)

W, H = 1920, 1080
TILE = (1040, 760, 32, 24)
DEPTH = dict(max_total_depth=5, min_total_depth=2)
BOX_MAT = 5   # the Mix node: add order white, red, green, root, Transparent


def alpha_scene(port: bool, lift: float = 0.0):
    """``alpha_box(lift)`` from either package's public API: the port's
    builder, or ray_tpu's ``cornell_scene`` shell and box built alike
    (ray_tpu's ``cornell_scene`` cannot lift its box)."""
    if port:
        return alpha_box(lift)
    from ray_tpu.scene.camera import make_camera
    from ray_tpu.scene.lights import LightDesc, LightType
    from ray_tpu.scene.materials import MaterialDesc, ShadingNode
    from ray_tpu.scene.scene import Scene
    from ray_tpu.utils.geometry import make_box, make_quad

    sc = Scene()
    white, red, green = (sc.add_material(MaterialDesc(
        type=ShadingNode.DIFFUSE, base_color=c, roughness=0.0))
        for c in ((0.73, 0.73, 0.73), (0.65, 0.05, 0.05),
                  (0.12, 0.45, 0.15)))
    box = sc.add_material(MaterialDesc(
        type=ShadingNode.PRINCIPLED, base_color=(0.8, 0.6, 0.2),
        roughness=0.3, alpha=0.5))
    assert box == BOX_MAT
    for center, u, v, m in [
        ((0, -1, 0), (1, 0, 0), (0, 0, 1), white),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1), white),
        ((0, 0, 1), (1, 0, 0), (0, -1, 0), white),
        ((-1, 0, 0), (0, 0, 1), (0, -1, 0), red),
        ((1, 0, 0), (0, 0, -1), (0, -1, 0), green),
    ]:
        verts, idx, uvs = make_quad(center, u, v)
        sc.add_mesh(verts, idx, uvs=uvs, material=m)
    bv, bidx, bn = make_box(center=(-0.3, -0.65 + lift, 0.3),
                            size=(0.6, 0.7, 0.6))
    sc.add_mesh(bv, bidx, normals=bn, material=box)
    sc.add_light(LightDesc(
        type=LightType.RECT, color=(20.0, 20.0, 20.0),
        position=(0, 0.999, 0), axis_u=(1.0, 0.0, 0.0),
        axis_v=(0.0, 0.0, 1.0), width=0.5, height=0.5))
    cam = make_camera(origin=(0, 0, -2.9), look_at=(0, 0, 0), fov=45.0)
    return sc, cam


def _render_pair(lift):
    x0, y0, tw, th = TILE
    (jsc, jcam), (tsc, tcam) = alpha_scene(False, lift), alpha_scene(True, lift)
    ref = j_render(jsc.finalize(), jcam, None, jnp.int32(x0), jnp.int32(y0),
                   jnp.uint32(1), jnp.uint32(0), width=W, height=H,
                   tile_w=tw, tile_h=th, settings=JPass(**DEPTH),
                   use_filter_table=False)
    scene = tsc.finalize(device="cpu")
    tint.march_counts.clear()
    trace.host_syncs.clear()
    out = render_tile(scene, tcam, None, x0, y0, 1, 0, width=W, height=H,
                      tile_w=tw, tile_h=th, settings=PassSettings(**DEPTH),
                      use_filter_table=False)
    marches = dict(tint.march_counts,
                   syncs=(trace.host_syncs["march_closest"]
                          + trace.host_syncs["march_shadow"]))
    return ({k: v.numpy() for k, v in out.items()},
            {k: np.asarray(v) for k, v in ref.items()}, scene, tcam, marches)


def _box_coverage(scene, cam):
    """The share of the tile's camera rays whose first hit is the box."""
    import torch

    from ray_tpu_torch.render import surface
    from ray_tpu_torch.render.raygen import generate_primary_rays

    x0, y0, tw, th = TILE
    rays = generate_primary_rays(cam, None, x0, y0, 1, 0, width=W, height=H,
                                 tile_w=tw, tile_h=th, use_filter_table=False,
                                 device="cpu")
    hit, _ = tint._trace_closest(scene, rays.ro, rays.rd, rays.t_max,
                                 torch.ones(tw * th, dtype=torch.bool))
    mat = surface.pick_hit_material(scene, hit.prim, hit.backface)
    return float((mat == BOX_MAT).float().mean())


def test_alpha_box_is_ray_tpus():
    """The port's ``alpha_box()`` and this file's ray_tpu build of it give
    the same tables."""
    from test_torch_io import _assert_same_scene

    _assert_same_scene(alpha_box()[0].finalize(device="cpu"),
                       alpha_scene(False)[0].finalize())


@pytest.mark.parametrize("lift", [0.0, 0.002], ids=["alpha_box", "lifted"])
def test_alpha_box_tile_matches_ray_tpu(lift):
    out, ref, scene, cam, marches = _render_pair(lift)
    assert _box_coverage(scene, cam) == 1.0
    assert ref["color"].mean() > 0.0
    # both marches ran: continuations of the closest-hit march, shadow
    # traces, and a loop test before each trace and one to stop each loop
    assert marches["through"] > 0 and marches["transmittance"] > 0
    assert marches["syncs"] > marches["through"] + marches["transmittance"]
    _check_tile(out, ref, 0.97 if lift == 0.0 else 0.99)


def _check_tile(out, ref, close_frac):
    """``tests/test_torch_render.py``'s bounds, with the fraction of
    close color pixels as a parameter."""
    assert out["color"].shape == ref["color"].shape
    assert np.isfinite(out["color"]).all()
    for key in ("base_color", "depth_normal"):
        ok = np.isclose(out[key], ref[key], rtol=1e-5, atol=1e-6).all(-1)
        assert ok.mean() >= 0.999, (key, ok.mean())
    ok = np.isclose(out["color"], ref["color"], rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= close_frac, ok.mean()
    m_out, m_ref = out["color"].mean(), ref["color"].mean()
    assert abs(m_out - m_ref) <= 1e-3 * abs(m_ref), (m_out, m_ref)
    r_out, r_ref = int(out["rays_traced"]), int(ref["rays_traced"])
    assert abs(r_out - r_ref) <= 0.005 * r_ref, (r_out, r_ref)


@pytest.mark.parametrize("save_trace", [True, False])
def test_alpha_box_remat_replays_the_marches(save_trace):
    """Path replay of the alpha box: the forward traces a variable number
    of times a bounce (the marches); the backward replays them from the
    trace tape, in call order, and traces nothing
    (``remat_save_trace``), or traces every one again (without it); the
    gradient is the stored-residual one (tests/test_grad.py's gate)."""
    import dataclasses

    import torch

    from ray_tpu_torch.ops import traverse

    x0, y0 = TILE[:2]
    scene = alpha_box()[0].finalize(device="cpu")
    cam = alpha_box()[1]
    calls = []
    real = traverse.trace_brute

    def counting(*args, any_hit=False):
        calls.append(any_hit)
        return real(*args, any_hit=any_hit)

    def run(**settings):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in scene.materials.items()
                  if v.is_floating_point()}
        s = dataclasses.replace(scene, materials={**scene.materials,
                                                  **params})
        calls.clear()
        out = render_tile(s, cam, None, x0, y0, 1, 0, width=W, height=H,
                          tile_w=16, tile_h=16,
                          settings=PassSettings(**DEPTH, **settings),
                          use_filter_table=False)
        n_fwd = len(calls)
        (out["color"] ** 2).sum().backward()
        return n_fwd, len(calls), params["base_color"].grad

    traverse.trace_brute = counting
    try:
        n_stored, total_stored, g_stored = run()
        n_fwd, total, g = run(remat=True, remat_save_trace=save_trace)
    finally:
        traverse.trace_brute = real
    # 6 bounce traces and more than 6 march steps
    assert n_stored == total_stored == n_fwd > 12
    assert not any(calls)  # with transparency, shadows march closest hits
    assert total == (n_fwd if save_trace else 2 * n_fwd)
    torch.testing.assert_close(g, g_stored, rtol=1e-5, atol=1e-7)
