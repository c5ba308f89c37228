"""Per-ray-type visibility masks against ray_tpu on the CPU.

An instance added with ``visibility=visibility_mask(...)`` is skipped by
the ray types it hides from.  In flatten mode each triangle carries its
instance's mask (``tri_vis``): ray_tpu's masked traces leave its Pallas
routing (``mode=None``) for the masked 8-wide walk when the scene has
``wrows`` and the masked BVH2 walk ``_traverse`` otherwise, and the port
routes alike (``trace_wide(has_vis=True)``, ``trace_bvh(tri_vis=...)``).
In tlas mode the instance's mask gates its entry (``trace_tlas`` or
``trace_tlas_bin``).  The integrator carries each lane's ray type as a
mask bit.

* ``trace_bvh_plain`` with masks against ``_traverse(tri_vis=...)`` on
  ``cornell_vis`` (flatten), and ``trace_tlas_plain(has_vis=True)`` on the
  flatten ``wrows`` against ``_traverse_wide(has_vis=True)`` on
  ``sphere_vis``, camera / shadow / diffuse masks, both modes: ``prim``,
  ``backface`` and occlusion exact, ``t`` / ``u`` / ``v`` within
  tests/test_torch_traverse.py's bounds.
* Routing: a masked 24-triangle scene takes the BVH2 walk, not the brute
  kernel, as ray_tpu's ``mode=None`` does.
* Compaction on and off, and path replay against stored residuals, on a
  masked tile: bit-identical.
* The array-of-structs wrappers ``trace_closest`` / ``trace_occlusion``
  and the O(R·T) spec ``trace_closest_brute`` against ray_tpu's.

(Tiles against ray_tpu: tests/test_torch_visibility_tiles.py.)
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import traverse as jtrav
from ray_tpu.scene.bvh import build_bvh2, tri_bounds
from ray_tpu.scene.camera import make_camera as j_camera
from ray_tpu.scene.lights import LightDesc as JLightDesc
from ray_tpu.scene.lights import LightType as JLightType
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.materials import ShadingNode as JShadingNode
from ray_tpu.scene.scene import Scene as JScene
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.ops import traverse as ttrav
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.scene.visibility import (
    RAY_ALL,
    RAY_CAMERA,
    RAY_DIFFUSE,
    RAY_SHADOW,
    visibility_mask,
)
from ray_tpu_torch.utils import test_scenes as ts
from test_torch_traverse import _check_closest

W, H = 1920, 1080
SETTINGS = dict(max_total_depth=5, min_total_depth=2)
MASKS = {"camera": RAY_CAMERA, "shadow": RAY_SHADOW, "diffuse": RAY_DIFFUSE}

J_API = types.SimpleNamespace(
    cornell_scene=j_cornell, MaterialDesc=JMaterialDesc,
    ShadingNode=JShadingNode, LightDesc=JLightDesc, LightType=JLightType,
    Scene=JScene, make_camera=j_camera)
T_API = ts.port_api()  # its Scene and make_camera too


def _rays(n, seed):
    r = np.random.default_rng(seed)
    ro = r.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = np.where(r.random(n) < 0.8, 1e30, r.random(n) * 2.0)
    active = r.random(n) < 0.95
    return (ro, rd, np.zeros(n, np.float32), t_max.astype(np.float32),
            active)


@pytest.fixture(scope="module")
def flat_scenes():
    """name → (ray_tpu's flatten scene, the port's)."""
    out = {}
    for build in (ts.cornell_vis, ts.sphere_vis):
        js = build(J_API)[0].finalize(instancing="flatten")
        tsc = build(T_API)[0].finalize(device="cpu", instancing="flatten")
        assert js.has_visibility and tsc.has_visibility
        np.testing.assert_array_equal(tsc.tri_vis.numpy(),
                                      np.asarray(js.tri_vis))
        out[build.__name__] = (js, tsc)
    return out


def _masked_both(flat_scenes, name, mask, any_hit):
    js, tsc = flat_scenes[name]
    R = 3000
    arrays = _rays(R, 23)
    ray_mask = np.full(R, MASKS[mask], np.int32)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    jm, tm = jnp.asarray(ray_mask), torch.from_numpy(ray_mask)
    if name == "cornell_vis":
        assert "wrows" not in tsc.bvh_soa
        ref = jtrav._traverse(js.bvh_soa, js.tri_soa, *j, js.max_leaf,
                              js.stack_size, any_hit, tri_vis=js.tri_vis,
                              ray_mask=jm)
        hit = ttrav.trace_bvh_plain(
            tsc.bvh_soa["packed"], tsc.tri_soa["packed"], *t, tsc.max_leaf,
            tsc.stack_size, any_hit, tri_vis=tsc.tri_vis, ray_mask=tm)
    else:
        ref = jtrav._traverse_wide(js.bvh_soa, *j, js.max_leaf,
                                   js.stack_size, any_hit, has_vis=True,
                                   ray_mask=jm)
        hit = ttrav.trace_wide(tsc.bvh_soa["wrows"], *t, tsc.max_leaf,
                               tsc.stack_size, any_hit=any_hit, ray_mask=tm,
                               has_vis=True)
    return hit, ref


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("name", ["cornell_vis", "sphere_vis"])
def test_masked_walks_match_ray_tpu(flat_scenes, name, mask, any_hit):
    hit, ref = _masked_both(flat_scenes, name, mask, any_hit)
    if any_hit:
        occ = hit.prim.numpy() >= 0
        np.testing.assert_array_equal(occ, np.asarray(ref.prim) >= 0)
        assert 0.05 < occ.mean() < 1.0
    else:
        _check_closest(hit, ref)


def test_masks_hide_what_they_should(flat_scenes):
    """The hidden instance does hide: camera rays never report
    ``sphere_vis``'s sphere, shadow rays do."""
    _, tsc = flat_scenes["sphere_vis"]
    t = [torch.from_numpy(a) for a in _rays(3000, 23)]
    on_sphere = tsc.tri_vis != RAY_ALL
    for mask, seen in ((RAY_CAMERA, False), (RAY_SHADOW, True)):
        m = torch.full((3000,), mask, dtype=torch.int32)
        h = ttrav.trace_wide(tsc.bvh_soa["wrows"], *t, tsc.max_leaf,
                             tsc.stack_size, ray_mask=m, has_vis=True)
        prim = h.prim[h.prim >= 0].long()
        assert bool(on_sphere[prim].any()) == seen


def test_masked_routing_follows_ray_tpu(monkeypatch):
    """A masked trace of the 24-triangle flagship (one instance of each
    mesh, the floor hidden from shadow rays) takes the BVH2 walk, as
    ray_tpu's ``mode=None`` takes ``_traverse``; the same scene unmasked
    takes the brute kernel."""
    sc, _ = ts.cornell_scene()
    sc.add_instance(0, visibility=visibility_mask(shadow=False))
    for m in range(1, len(sc._meshes)):
        sc.add_instance(m)
    scene = sc.finalize(device="cpu")
    assert scene.num_tris == 24 and scene.has_visibility
    seen = []
    for name in ("trace_brute", "trace_bvh"):
        real = getattr(ttrav, name)
        monkeypatch.setattr(
            ttrav, name,
            lambda *a, _n=name, _r=real, **k: seen.append(_n) or _r(*a, **k))
    rays = [torch.from_numpy(a) for a in _rays(64, 3)]
    mask = torch.full((64,), RAY_SHADOW, dtype=torch.int32)
    ttrav.trace_occlusion_soa(scene.bvh_soa, scene.tri_soa, *rays,
                              tri_vis=scene.tri_vis, ray_mask=mask)
    ttrav.trace_occlusion_soa(scene.bvh_soa, scene.tri_soa, *rays)
    assert seen == ["trace_bvh", "trace_brute"]


def _port_tile(scene, cam, **settings):
    return render_tile(scene, cam, None, 928, 500, 1, 0, width=W, height=H,
                       tile_w=32, tile_h=32,
                       settings=PassSettings(**{**SETTINGS, **settings}),
                       use_filter_table=False)


def test_compaction_with_masks_is_bit_identical():
    """The ray-type mask is compacted with the rest of the lane state: a
    32x32 ``cornell_vis`` tile (tlas) with compaction after bounce 2 equals
    the uncompacted one bit for bit."""
    sc, cam = ts.cornell_vis()
    scene = sc.finalize(device="cpu", instancing="tlas")
    a = _port_tile(scene, cam)
    b = _port_tile(scene, cam, compact_after=2, compact_factor=4)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_remat_with_masks_matches_stored():
    """Path replay keeps the ray-type mask as bounce state: the loss and
    the gradients of a masked flatten tile with ``remat=True`` equal the
    stored-residual ones."""
    sc, cam = ts.cornell_vis()
    scene = sc.finalize(device="cpu", instancing="flatten")
    grads = []
    for remat in (False, True):
        col = scene.materials["base_color"].clone().requires_grad_(True)
        s = dataclasses.replace(
            scene, materials={**scene.materials, "base_color": col})
        out = _port_tile(s, cam, remat=remat)
        loss = (out["color"] ** 2).sum()
        loss.backward()
        grads.append((loss.detach(), col.grad))
    assert float(grads[0][0]) > 0.0
    assert torch.equal(grads[0][0], grads[1][0])
    np.testing.assert_allclose(grads[1][1].numpy(), grads[0][1].numpy(),
                               rtol=1e-5, atol=1e-7)


def _aos(seed=2, n_tris=60):
    r = np.random.RandomState(seed)
    base = (r.rand(n_tris, 1, 3) - 0.5) * 4.0
    tris = (base + (r.rand(n_tris, 3, 3) - 0.5) * 1.5).astype(np.float32)
    v = tris.reshape(-1, 3)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    b = build_bvh2(*tri_bounds(v, idx), max_leaf=4)
    ro, rd, tmin, tmax, act = _rays(2000, seed + 1)
    ro = ro * 3.0
    return (b.child_lo, b.child_hi, b.child, b.prim_indices, v, idx), (
        ro, rd, tmin, tmax, act)


def test_aos_wrappers_match_ray_tpu():
    """``trace_closest`` (original triangle ids), ``trace_occlusion`` and
    ``trace_closest_brute`` against ray_tpu's on one BVH2 and its rays."""
    tables, rays = _aos()
    j = [jnp.asarray(a) for a in (*tables, *rays)]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (*tables, *rays)]
    ref = jtrav.trace_closest(*j)
    hit = ttrav.trace_closest(*t)
    _check_closest(hit, ref)
    np.testing.assert_array_equal(ttrav.trace_occlusion(*t).numpy(),
                                  np.asarray(jtrav.trace_occlusion(*j)))
    # the spec: every ray against every triangle of the vertex buffer
    spec = ttrav.trace_closest_brute(t[4], t[5], *t[6:])
    _check_closest(spec, jtrav.trace_closest_brute(j[4], j[5], *j[6:]))
    np.testing.assert_array_equal(spec.prim.numpy(), hit.prim.numpy())
