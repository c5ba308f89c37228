"""ray_tpu_torch.render.lightmap against ray_tpu.render.lightmap on the CPU.

* ``rasterize_uv_rays``: ``ro``, ``rd``, ``t_max``, ``px``, ``py``, the
  coverage mask and the covering triangles bit-equal to ``ray_tpu``'s (the
  same numpy float32 operations on the host) on
  ``tests/test_lightmap_ortho.py``'s floor-and-light scene, on the
  flagship floor's and back wall's prim ranges (triangles 0-1 and 14-15
  of the finalized ``cornell_scene("emissive_quad")``) and on the longest
  run of ``cornell_sphere``'s sphere triangles in BVH leaf order (0-330):
  the back wall and the sphere are what ``chip_smoke.py`` bakes (the
  floor's normals face out of the box, so its texels see its underside);
* ``render_tile(rays=..., cam=None)`` against ``ray_tpu``'s on the same
  batch, within ``tests/test_torch_render.py``'s tile bounds; a batch of
  the wrong length raises; path replay (``remat=True``) with a given batch;
* ``bake_lightmap`` against ``ray_tpu``'s at 16x16, 2 iterations, depth 2,
  ``output_sh``: the masks equal, ``color`` and ``shl1`` within the tile
  bounds' rtol 1e-3 / atol 1e-4 on ≥ 99% of texels and their means within
  1e-3.

  The rasterizer puts texels on integer UV coordinates, so many texels'
  rays run exactly through a mesh edge or vertex, where the last ulp of
  the triangle test decides whether a triangle takes the ray, and XLA's
  CPU code and the port's IEEE-sequential float32 differ in that ulp
  (ROADMAP).  On the floor a row of texels lies exactly above the quad's
  edge in a face of the scene's root box, looking straight down with ±0 x
  and z components: ``ray_tpu`` walks its BVH on the CPU (its Pallas
  brute-force kernel is for the TPU), and its slab test
  (``safe_invert(-0.0)`` is +1/eps) puts such a ray outside the root box,
  while the port traces ≤ 40 triangles by brute force on every device, as
  ``ray_tpu``'s TPU path does, and hits.  So the lanes whose primary ray
  one package hits and the other misses are held apart (``_flips``): each
  must hit within 1e-6 of a triangle edge in barycentrics, they are at
  most a row and a column of texels, and the rest is held to the bounds
  (``rays_traced`` to 0.5% plus 12 rays a flipped lane);
* ``tests/test_lightmap_ortho.py``'s bake properties on the port: coverage
  > 0.9, the texels under the light brighter than the corners, the SH L0
  band 0.282095 x color, the Y band positive.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.render.lightmap import bake_lightmap as j_bake
from ray_tpu.render.lightmap import rasterize_uv_rays as j_rasterize
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.render.lightmap import bake_lightmap, rasterize_uv_rays
from test_torch_render import _check
from test_torch_scene import cornell_sphere

torch.set_num_threads(1)


def _pkg(port, mod):
    return importlib.import_module(
        f"{'ray_tpu_torch' if port else 'ray_tpu'}.{mod}")


def _floor_light(port):
    """tests/test_lightmap_ortho.py's floor (the unit UV square) under a
    sphere light, built with either package."""
    scene, mats = _pkg(port, "scene.scene"), _pkg(port, "scene.materials")
    lights = _pkg(port, "scene.lights")
    sc = scene.Scene()
    m = sc.add_material(mats.MaterialDesc(type=mats.ShadingNode.DIFFUSE,
                                          base_color=(0.8, 0.8, 0.8)))
    v, idx, uv = _pkg(port, "utils.geometry").make_quad(
        (0, 0, 0), (0, 0, 1), (1, 0, 0))
    sc.add_mesh(v, idx, uvs=uv, material=m)
    sc.add_light(lights.LightDesc(
        type=lights.LightType.SPHERE, color=(40.0, 40.0, 40.0),
        position=(0.0, 1.2, 0.0), radius=0.1))
    return sc


def _flagship(port):
    return _pkg(port, "utils.test_scenes").cornell_scene("emissive_quad")[0]


def _sphere(port):
    return cornell_sphere(port)[0]


# scene, (width, height), prim range
CASES = {
    "floor_light": (_floor_light, (32, 32), (0, None)),
    "flagship floor": (_flagship, (64, 48), (0, 2)),
    "flagship back wall": (_flagship, (64, 48), (14, 16)),
    "cornell_sphere sphere": (_sphere, (64, 64), (0, 330)),
}


def _finalized(make):
    return make(False).finalize(), make(True).finalize(device="cpu")


def _rasterize_both(label, size=None):
    make, (w, h), (lo, hi) = CASES[label]
    w, h = size or (w, h)
    jsc, tsc = _finalized(make)
    ref = j_rasterize(np.asarray(jsc.vertices), np.asarray(jsc.normals),
                      np.asarray(jsc.uvs), np.asarray(jsc.tri_vidx), w, h,
                      lo, hi)
    out = rasterize_uv_rays(tsc.vertices, tsc.normals, tsc.uvs, tsc.tri_vidx,
                            w, h, lo, hi, device="cpu")
    return (jsc, tsc), ref, out


@pytest.mark.parametrize("label", sorted(CASES))
def test_rasterize_uv_rays_bit_equal(label):
    _, (jrays, jmask, jprim), (rays, mask, prim) = _rasterize_both(label)
    for f in rays._fields:
        a, b = getattr(rays, f).numpy(), np.asarray(getattr(jrays, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(prim.numpy(), np.asarray(jprim))
    assert 0.2 < float(mask.float().mean()) <= 1.0


def _flips(jsc, tsc, jrays, jmask, rays, mask):
    """The covered lanes whose primary ray one package's trace hits and the
    other's misses, as a numpy mask; each must be an edge hit (module
    docstring)."""
    from ray_tpu.ops import traverse as j_traverse
    from ray_tpu_torch.ops import traverse as t_traverse

    R = mask.shape[0]
    jh = j_traverse.trace_closest_soa(
        jsc.bvh_soa, jsc.tri_soa, jrays.ro, jrays.rd, jnp.zeros(R),
        jrays.t_max, jmask, max_leaf=jsc.max_leaf, stack_size=jsc.stack_size)
    th = t_traverse.trace_closest_soa(
        tsc.bvh_soa, tsc.tri_soa, rays.ro, rays.rd, torch.zeros(R),
        rays.t_max, mask, max_leaf=tsc.max_leaf, stack_size=tsc.stack_size)
    j_hit, t_hit = np.asarray(jh.prim) >= 0, th.prim.numpy() >= 0
    flips = mask.numpy() & (j_hit != t_hit)

    def edge(h):
        u, v = np.asarray(h.u), np.asarray(h.v)
        return np.minimum(np.minimum(u, v), 1.0 - u - v) <= 1e-6

    on_edge = np.where(t_hit, edge(th), edge(jh))
    assert on_edge[flips].all()
    w, h = int(rays.px.max()) + 1, int(rays.py.max()) + 1
    assert flips.sum() <= w + h, flips.sum()
    return flips


def _check_apart(out, ref, flips):
    """``_check`` on the lanes that are not ``flips``, ``rays_traced``
    within 0.5% plus 12 rays (6 bounces' closest and shadow rays) a
    flipped lane."""
    keep = ~flips
    r_out, r_ref = int(out["rays_traced"]), int(ref["rays_traced"])
    assert abs(r_out - r_ref) <= 0.005 * r_ref + 12 * flips.sum(), (
        r_out, r_ref)
    out = {k: v[keep] if v.ndim else ref[k] for k, v in out.items()}
    ref = {k: v[keep] if v.ndim else v for k, v in ref.items()}
    _check(out, ref)


@pytest.mark.parametrize("label", ["floor_light", "cornell_sphere sphere"])
def test_render_tile_with_rays_matches_ray_tpu(label):
    """One sample of a batch of 24x24 texels, the camera replaced by the
    batch."""
    (jsc, tsc), (jrays, jmask, _), (rays, mask, _) = _rasterize_both(
        label, (24, 24))
    w, h = 24, 24
    settings = dict(max_total_depth=3, min_total_depth=2)
    ref = j_render(jsc, None, None, jnp.int32(0), jnp.int32(0),
                   jnp.uint32(3), jnp.uint32(5), width=w, height=h,
                   tile_w=w, tile_h=h, settings=JPass(**settings),
                   use_filter_table=False, pixel_mask=jmask, rays=jrays)
    out = render_tile(tsc, None, None, 0, 0, 3, 5, width=w, height=h,
                      tile_w=w, tile_h=h, settings=PassSettings(**settings),
                      use_filter_table=False, pixel_mask=mask, rays=rays)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    assert ref["color"].mean() > 0.0
    _check_apart(out, ref, _flips(jsc, tsc, jrays, jmask, rays, mask))
    with pytest.raises(ValueError, match="lanes"):
        render_tile(tsc, None, None, 0, 0, 3, 5, width=w, height=h // 2,
                    tile_w=w, tile_h=h // 2,
                    settings=PassSettings(**settings),
                    use_filter_table=False, rays=rays)


def test_remat_replays_a_given_batch():
    """Path replay of a texel batch: the loss bit-identical to the stored
    residuals' and the ``base_color`` gradients equal to rounding."""
    _, _, (rays, mask, _) = _rasterize_both("floor_light")
    scene = _floor_light(True).finalize(device="cpu")
    grads, losses = [], []
    for remat in (False, True):
        leaf = scene.materials["base_color"].detach().clone() \
            .requires_grad_(True)
        sc = dataclasses.replace(
            scene, materials={**scene.materials, "base_color": leaf})
        out = render_tile(sc, None, None, 0, 0, 1, 0, width=32, height=32,
                          tile_w=32, tile_h=32,
                          settings=PassSettings(max_total_depth=2,
                                                remat=remat),
                          use_filter_table=False, pixel_mask=mask, rays=rays)
        loss = (out["color"] ** 2).mean()
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, leaf)[0])
    assert torch.equal(losses[0], losses[1])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-7)
    assert float(grads[0].abs().max()) > 0.0


@pytest.mark.parametrize("label", ["floor_light", "cornell_sphere sphere"])
def test_bake_lightmap_matches_ray_tpu(label):
    make, _, (lo, hi) = CASES[label]
    jsc, tsc = _finalized(make)
    settings = dict(max_total_depth=2, min_total_depth=2, output_sh=True)
    ref = j_bake(jsc, 16, 16, JPass(**settings), iterations=2, prim_lo=lo,
                 prim_hi=hi)
    out = bake_lightmap(tsc, 16, 16, PassSettings(**settings), iterations=2,
                        prim_lo=lo, prim_hi=hi)
    assert out.keys() == ref.keys()
    np.testing.assert_array_equal(out["mask"], ref["mask"])
    assert ref["color"].mean() > 0.0
    args = (np.asarray(jsc.vertices), np.asarray(jsc.normals),
            np.asarray(jsc.uvs), np.asarray(jsc.tri_vidx), 16, 16, lo, hi)
    flips = _flips(jsc, tsc, *j_rasterize(*args)[:2],
                   *rasterize_uv_rays(*args, device="cpu")[:2])
    flips = flips.reshape(16, 16)
    for key in ("color", "shl1"):
        a, b = out[key][~flips], ref[key][~flips]
        assert a.dtype == np.float32
        ok = np.isclose(a, b, rtol=1e-3, atol=1e-4).reshape(
            a.shape[0], -1).all(-1)
        assert ok.mean() >= 0.99, (key, ok.mean())
        assert abs(a.mean() - b.mean()) <= 1e-3 * abs(b.mean()), key


def test_bake_properties():
    """tests/test_lightmap_ortho.py's bake, on the port."""
    scene = _floor_light(True).finalize(device="cpu")
    settings = PassSettings(max_total_depth=2, min_total_depth=2,
                            use_path_termination=False, output_sh=True)
    out = bake_lightmap(scene, 16, 16, settings, iterations=32)
    mask, col, sh = out["mask"], out["color"], out["shl1"]
    assert mask.mean() > 0.9
    lum = col.sum(-1)
    assert (lum[mask] > 0).mean() > 0.9
    center = lum[7:9, 7:9].mean()
    corner = (lum[0, 0] + lum[0, -1] + lum[-1, 0] + lum[-1, -1]) / 4
    assert center > 2.0 * corner
    np.testing.assert_allclose(sh[..., 0, :], col * 0.282095, rtol=1e-3,
                               atol=1e-5)
    assert sh[mask][:, 1, :].sum() > 0
