"""The binned trace and the 8-wide flatten walk against ray_tpu on the CPU.

* ``trace_binned_plain`` against ray_tpu's ``trace_flat_binned(...,
  interpret=True)`` on the 3,000-triangle cloud of
  tests/test_binned_interpret.py (S = 8 subtrees), closest and any-hit:
  ``prim`` and ``backface`` exact, ``t`` within rtol 1e-5 / atol 1e-5 and
  ``u``/``v`` within atol 1e-4 — tests/test_torch_traverse.py's bounds,
  since XLA's CPU code is not IEEE-sequential float32; closest hits the
  same against the XLA walk ``_traverse`` on more rays; the wrapper
  ``trace_binned`` gives the plain version's outputs bit for bit with ray
  sorting on and off.
* The wide route ``trace_wide`` (``trace_tlas_plain`` over a flatten
  ``wrows`` table) against ray_tpu's ``_traverse_wide``, both modes:
  ``prim`` exact, ``t`` within rtol 1e-5 / atol 1e-5.
* A 16x16 tile, depth 3, of a binned flatten scene (the Cornell box and a
  1,472-triangle sphere: 1,496 triangles, S = 5) and of its wide-route
  twin against ray_tpu's tile of the same scene, within
  tests/test_torch_render.py's bounds.  On the CPU ray_tpu walks both with
  ``_traverse_wide`` (its ``_pallas_mode`` is "xla" off a TPU); binned hits
  equal XLA hits in ``prim`` on these scenes, so both port tiles are held
  to that one.
* Routing: ≤ 40 triangles → brute, ≤ 512 rows → bvh, binned slabs →
  binned, ``wrows`` → wide, else the BVH2 walk at any size; a trace with
  per-triangle visibility takes the masked wide walk (``wrows``) or the
  masked BVH2 walk, never the binned kernel.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import traverse as jtrav
from ray_tpu.ops.traverse_pallas import pack_binned_scene as j_pack
from ray_tpu.ops.traverse_pallas import trace_flat_binned
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.scene import bvh as jbvh
from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.materials import ShadingNode as JShadingNode
from ray_tpu.scene.wbvh import build_wbvh as j_wbvh
from ray_tpu.utils.geometry import make_uv_sphere as j_sphere
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.ops import traverse as tt
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.scene.binned import CI, SUB_ROWS
from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
from ray_tpu_torch.utils.geometry import make_uv_sphere as t_sphere
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell
from test_torch_render import _check
from test_torch_traverse import _check_closest

W, H = 1920, 1080
# 16x16 lanes across the sphere's lower edge and the floor, whose primary
# hits lie in three of the five subtrees: no compaction (under 1,024 lanes)
TILE = dict(x0=930, y0=880, tile_w=16, tile_h=16)
SETTINGS = dict(max_total_depth=3, min_total_depth=2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.fixture(scope="module")
def cloud():
    """tests/test_binned_interpret.py's cloud, ray_tpu's tables (numpy
    builder, max_leaf 4) as numpy and as the port's tensors, and rays."""
    r = np.random.RandomState(3)
    n_tris = 3000
    base = r.rand(n_tris, 1, 3).astype(np.float32) * 10.0
    tris = base + r.rand(n_tris, 3, 3).astype(np.float32) * 0.6
    v = tris.reshape(-1, 3)
    t = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    b = jbvh.build_bvh2(*jbvh.tri_bounds(v, t), max_leaf=4,
                        use_native="never")
    tri_soa = jbvh.pack_tri_soa(v, t[b.prim_indices])
    binned = j_pack(b, tri_soa)
    assert binned["slab_i"].shape[0] // CI == 8

    def rays(R, seed):
        g = np.random.RandomState(seed)
        ro = g.rand(R, 3).astype(np.float32) * 30 - 10
        rd = g.rand(R, 3).astype(np.float32) * 10 - ro
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        t_max = np.where(g.rand(R) < 0.8, 1e30, g.rand(R) * 20.0)
        return (ro, rd, np.zeros(R, np.float32), t_max.astype(np.float32),
                g.rand(R) > 0.05)

    return dict(bvh=b, v=v, t=t, tri_soa=tri_soa, binned=binned,
                port={k: _t(a) for k, a in binned.items()}, rays=rays,
                stack=jbvh.bvh_depth(b) + 4)


def _holds(port, ref, any_hit):
    """prim, backface exact; the floats within the module's bounds."""
    prim = np.asarray(ref.prim)
    np.testing.assert_array_equal(port.prim.numpy(), prim)
    np.testing.assert_array_equal(port.backface.numpy(),
                                  np.asarray(ref.backface) != 0)
    hit = prim >= 0
    assert 0.1 < hit.mean() < 0.9, hit.mean()
    np.testing.assert_array_equal(port.t.numpy()[~hit], np.asarray(ref.t)[~hit])
    np.testing.assert_allclose(port.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5, atol=1e-5)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(port, k).numpy()[hit],
                                   np.asarray(getattr(ref, k))[hit],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_binned_plain_matches_pallas_interpret(cloud, any_hit):
    """256 rays in one block of 2 x 128 lanes: ray_tpu's interpret mode
    takes ~8 s a mode, most of it compiling (~16 s at its default 32-row
    blocks, which pad 256 rays to 4,096 lanes)."""
    ro, rd, tmn, tmx, act = cloud["rays"](256, 11)
    ref = trace_flat_binned(cloud["binned"], *map(jnp.asarray, (ro, rd, tmn,
                                                                tmx, act)),
                            max_leaf=4, any_hit=any_hit, block_rows=2,
                            interpret=True)
    rays = [_t(a) for a in (ro, rd, tmn, tmx, act)]
    port = tt.trace_binned_plain(cloud["port"], *rays, 4, any_hit)
    _holds(port, ref, any_hit)
    for sort_rays in (True, False):
        w = tt.trace_binned(cloud["port"], *rays, 4, any_hit,
                            sort_rays=sort_rays)
        for f in port._fields:
            assert torch.equal(getattr(w, f), getattr(port, f)), f


def test_trace_binned_plain_matches_xla_walk(cloud):
    """ray_tpu's XLA BVH2 walk (``force_xla``) on 4,096 rays: closest hits
    exact in ``prim``/``backface``.  (Any-hit is held to the Pallas kernel
    above; each XLA mode costs ~3 s of compiling.)"""
    b, v, t = cloud["bvh"], cloud["v"], cloud["t"]
    jb, jt = jtrav._soa_from_arrays(*map(jnp.asarray, (
        b.child_lo, b.child_hi, b.child, b.prim_indices, v, t)))
    arrays = cloud["rays"](4096, 12)
    j = [jnp.asarray(a) for a in arrays]
    rays = [_t(a) for a in arrays]
    ref = jtrav.trace_closest_soa(jb, jt, *j, max_leaf=4,
                                  stack_size=cloud["stack"], force_xla=True)
    _check_closest(tt.trace_binned(cloud["port"], *rays, 4), ref)


def test_trace_binned_work_counts(cloud):
    """The counts the kernel's bound is computed from: a lane scans S boxes
    once per subtree it walks and once more to find none left."""
    ro, rd, tmn, tmx, act = (_t(a) for a in cloud["rays"](512, 13))
    S = cloud["binned"]["slab_i"].shape[0] // CI
    counts = []
    for any_hit in (False, True):
        work = {}
        tt.trace_binned_plain(cloud["port"], ro, rd, tmn, tmx, act, 4,
                              any_hit, work=work)
        counts.append(work)
    closest, anyhit = counts
    assert set(closest) == {"rounds", "box_tests", "node_steps", "tri_tests"}
    assert closest["box_tests"] == S * (closest["rounds"] + int(act.sum()))
    assert closest["node_steps"] >= closest["rounds"] > 0
    for k in closest:
        assert 0 < anyhit[k] <= closest[k], k


def test_binned_sort_key(cloud):
    """The sort key is each active ray's first subtree along the ray in
    ray_tpu's pre-pass arithmetic, S for an inactive lane or a ray that
    enters no subtree box; rays whose walk finds a hit have a key < S."""
    ro, rd, tmn, tmx, act = (_t(a) for a in cloud["rays"](2048, 14))
    S = cloud["binned"]["slab_i"].shape[0] // CI
    key = tt.binned_sort_key(cloud["port"], ro, rd, tmn, tmx, act)
    assert key.dtype == torch.int32 and bool(((key >= 0) & (key <= S)).all())
    assert bool((key[~act] == S).all())
    hit = tt.trace_binned_plain(cloud["port"], ro, rd, tmn, tmx, act, 4)
    assert bool((key[hit.prim >= 0] < S).all())
    # the key is the box of least entry distance, first in sid order
    lo, hi = (cloud["port"]["sub_lo"], cloud["port"]["sub_hi"])
    for s in range(S):
        one = tt.binned_sort_key_plain(lo[s:s + 1], hi[s:s + 1], ro, rd, tmn,
                                       tmx, act)
        assert bool(((one == 0) | (key != s)).all()), s


@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_route_matches_traverse_wide(cloud, any_hit):
    """The flatten ``wrows`` of the cloud (max_leaf 4: 56 columns, no
    instance rows): ``trace_wide`` is ``trace_tlas`` with ``winst_base`` 0
    and no ray mask."""
    b = cloud["bvh"]
    rows = j_wbvh(b, cloud["tri_soa"]["packed"])["wrows"]
    arrays = cloud["rays"](2048, 15)
    ref = jtrav._traverse_wide({"wrows": jnp.asarray(rows)},
                               *map(jnp.asarray, arrays), 4, cloud["stack"],
                               any_hit)
    port = tt.trace_wide(_t(rows), *(_t(a) for a in arrays), 4,
                         cloud["stack"], any_hit)
    prim = np.asarray(ref.prim)
    if any_hit:
        np.testing.assert_array_equal(port.prim.numpy() >= 0, prim >= 0)
        return
    np.testing.assert_array_equal(port.prim.numpy(), prim)
    hit = prim >= 0
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(port.backface.numpy(),
                                  np.asarray(ref.backface))
    np.testing.assert_allclose(port.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5, atol=1e-5)


def binned_sphere(port: bool):
    """The Cornell box and a 1,472-triangle rough sphere: 1,496 triangles,
    234 BVH2 nodes, S = 5 subtrees when finalized with
    ``pallas_binned=True``, from the public API of either package."""
    cornell, sphere = (t_cornell, t_sphere) if port else (j_cornell, j_sphere)
    desc, node = ((MaterialDesc, ShadingNode) if port
                  else (JMaterialDesc, JShadingNode))
    sc, cam = cornell("emissive_quad")
    m = sc.add_material(desc(type=node.DIFFUSE, base_color=(0.2, 0.3, 0.8),
                             roughness=0.5))
    v, idx, n, uv = sphere(center=(0.4, -0.64, -0.3), radius=0.35, rings=24,
                           segments=32)
    sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)
    return sc, cam


def _port_tile(scene, cam):
    out = render_tile(scene, cam, None, TILE["x0"], TILE["y0"], 1, 0,
                      width=W, height=H, tile_w=TILE["tile_w"],
                      tile_h=TILE["tile_h"],
                      settings=PassSettings(**SETTINGS),
                      use_filter_table=False)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def sphere_tiles():
    """ray_tpu's tile (~10 s) and the port's scene, binned and wide."""
    jsc, jcam = binned_sphere(False)
    ref = j_render(jsc.finalize(pallas_binned=True), jcam, None,
                   jnp.int32(TILE["x0"]), jnp.int32(TILE["y0"]),
                   jnp.uint32(1), jnp.uint32(0), width=W, height=H,
                   tile_w=TILE["tile_w"], tile_h=TILE["tile_h"],
                   settings=JPass(**SETTINGS), use_filter_table=False)
    tsc, tcam = binned_sphere(True)
    scene = tsc.finalize(device="cpu", pallas_binned=True)
    wide = dataclasses.replace(scene, bvh_soa={
        k: v for k, v in scene.bvh_soa.items() if not k.startswith("binned_")})
    return dict(ref={k: np.asarray(v) for k, v in ref.items()}, scene=scene,
                wide=wide, cam=tcam)


def test_binned_tile_matches_ray_tpu(sphere_tiles, monkeypatch):
    scene, ref = sphere_tiles["scene"], sphere_tiles["ref"]
    assert scene.num_tris == 1496 and scene.bvh_soa["code0"].shape[0] == 234
    assert scene.bvh_soa["binned_slab_i"].shape[0] // CI == 5
    # the tile's primary hits land in several subtrees, its bounces' in all
    calls = []
    real = tt.trace_binned

    def spy(binned, ro, *args, **kw):
        hit = real(binned, ro, *args, **kw)
        calls.append(hit.prim)
        return hit

    monkeypatch.setattr(tt, "trace_binned", spy)
    out = _port_tile(scene, sphere_tiles["cam"])
    assert len(calls) == 2 * 4   # closest + any-hit, 4 bounces
    gmap = scene.bvh_soa["binned_slab_i"].view(5, CI // 4, SUB_ROWS)[:, 2]

    def subtrees(prim):
        # (prim 0 also pads every slab's map: leave it out)
        prim = prim[prim > 0]
        return {s for s in range(5) if bool(torch.isin(prim, gmap[s]).any())}

    assert len(subtrees(calls[0])) >= 3
    assert len(subtrees(torch.cat(calls[0::2]))) == 5
    assert 0.1 < np.isclose(ref["base_color"][:, 2], 0.8).mean() < 0.9
    _check(out, ref)


def test_wide_tile_matches_ray_tpu(sphere_tiles):
    wide, ref = sphere_tiles["wide"], sphere_tiles["ref"]
    assert "wrows" in wide.bvh_soa and "binned_slab_f" not in wide.bvh_soa
    _check(_port_tile(wide, sphere_tiles["cam"]), ref)


def test_routing_follows_ray_tpu(sphere_tiles, monkeypatch):
    """ray_tpu's ``_pallas_mode`` order, on a TPU: ≤ 40 triangles brute,
    ≤ 512 node and triangle rows bvh, binned slabs binned, ``wrows`` the
    8-wide walk, and without it the BVH2 walk (``_traverse``) at any size;
    ``tri_vis`` takes ``ray_tpu``'s ``mode=None`` route: the masked 8-wide
    walk where ``wrows`` exists (even beside binned slabs), else the masked
    BVH2 walk."""
    assert tt._trace_mode(100, 40, True, True) == "brute"
    assert tt._trace_mode(512, 512, True, True) == "bvh"
    assert tt._trace_mode(238, 1496, True, True) == "binned"
    assert tt._trace_mode(238, 1496, False, True) == "wide"
    assert tt._trace_mode(238, 1496, False, False) == "bvh"
    seen = []
    for name in ("trace_brute", "trace_bvh", "trace_binned", "trace_wide"):
        monkeypatch.setattr(
            tt, name, lambda *a, _n=name, **k: seen.append((_n, sorted(k))))
    ro = torch.zeros((4, 3))
    rd = torch.ones((4, 3))
    rays = (ro, rd, torch.zeros(4), torch.ones(4), torch.ones(4, dtype=bool))
    for key in ("scene", "wide"):
        sc = sphere_tiles[key]
        tt.trace_closest_soa(sc.bvh_soa, sc.tri_soa, *rays)
    assert [n for n, _ in seen] == ["trace_binned", "trace_wide"]
    seen.clear()
    sc = sphere_tiles["scene"]
    mask = torch.full((4,), 1, dtype=torch.int32)
    tt.trace_closest_soa(sc.bvh_soa, sc.tri_soa, *rays, tri_vis=sc.tri_vis,
                         ray_mask=mask)
    no_wide = {k: v for k, v in sc.bvh_soa.items() if k != "wrows"}
    tt.trace_closest_soa(no_wide, sc.tri_soa, *rays, tri_vis=sc.tri_vis,
                         ray_mask=mask)
    assert seen == [("trace_wide", ["any_hit", "has_vis", "ray_mask"]),
                    ("trace_bvh", ["any_hit", "ray_mask", "tri_vis"])]
