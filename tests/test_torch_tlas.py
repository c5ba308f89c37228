"""The two-level (TLAS) slice against ray_tpu on the CPU.

* ``colonnade_scene`` (8,388 unique triangles in 81 instances, a 256x256
  texture, PRINCIPLED materials, 12 sphere lights + env) finalized by the
  port carries ray_tpu's tables bit for bit: ``wrows_tlas``, the binary
  nodes, instance columns, ``tri_surf``, lights, light tree and textures.
* ``trace_tlas_plain`` against ray_tpu's ``_traverse_wide_tlas`` and
  ``trace_tlas_pallas(interpret=True)`` on the instanced generator scene of
  tests/test_traverse_tlas_pallas.py: ``prim``, ``inst``, ``backface`` and
  occlusion exact; ``t`` within rtol 1e-6 and ``u``/``v`` within rtol 1e-5
  / atol 1e-6 (1e-5 at 64 instances: ``UV_ATOL``), since XLA's CPU code is
  not IEEE-sequential float32.
* A 31x32 colonnade tile (992 lanes) against ``ray_tpu.render_tile`` at the
  big scene's settings, held to tests/test_torch_render.py's bounds except
  one, stated at :func:`test_colonnade_tile_matches_ray_tpu`.  Below 1,024
  lanes neither side compacts, so ray_tpu compiles its bounce once instead
  of three times; the port's 32x32 tile (3,040 rays: compaction engages)
  is bit-identical with compaction on and off, and through
  ``SceneFlat.from_numpy`` of ray_tpu's scene.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import traverse as jtrav
from ray_tpu.ops.traverse_pallas import trace_tlas_pallas
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.utils.test_scenes import colonnade_scene as j_colonnade
from ray_tpu_torch.ops import traverse as ttrav
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.scene.scene import SceneFlat
from ray_tpu_torch.utils.test_scenes import colonnade_scene as t_colonnade
from test_torch_render import _check
from test_torch_scene import _ARRAYS, _STATIC, _assert_scene_equal
from test_traverse_tlas_pallas import _instanced_scene, _rays

W, H = 1920, 1080
# bench.py's big-scene settings, without remat (a forward pass)
BIG = dict(max_total_depth=5, min_total_depth=2, compact_after=2,
           compact_factor=4)
TILE = dict(x0=944, y0=524, tile_w=32, tile_h=32)
# the tile held against ray_tpu: one column less, under 1,024 lanes
REF_TILE = dict(TILE, tile_w=31)
# every walk of the generator cases runs at this table height and stack, so
# that ray_tpu's jitted Pallas call (interpret mode, ~8 s to compile) is
# compiled once per mode and shared by the cases: the zero rows appended
# are never reached, and a stack at least as deep as the scene's changes no
# hit
ROWS, STACK = 256, 20


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def colonnade():
    jsc, jcam = j_colonnade()
    tsc, tcam = t_colonnade()
    return dict(js=jsc.finalize(), jcam=jcam, ts=tsc.finalize(device="cpu"),
                tcam=tcam)


def _render(scene, cam, tile=TILE, **settings):
    out = render_tile(scene, cam, None, tile["x0"], tile["y0"], 1, 0,
                      width=W, height=H, tile_w=tile["tile_w"],
                      tile_h=tile["tile_h"],
                      settings=PassSettings(**{**BIG, **settings}),
                      use_filter_table=False)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def port_tile(colonnade):
    return _render(colonnade["ts"], colonnade["tcam"])


def test_colonnade_tables_match_ray_tpu(colonnade):
    ts, js = colonnade["ts"], colonnade["js"]
    _assert_scene_equal(ts, js)
    assert ts.mode == "tlas" and ts.num_tris == 8388
    assert tuple(ts.bvh_soa["wrows_tlas"].shape) == (3478, 56)
    assert int(ts.bvh_soa["winst_base"]) == 32 and ts.stack_size == 25
    assert ts.inst["vis"].shape[0] == 81 and ts.num_lights == 13
    assert ts.mat_types == (6,) and ts.has_textures
    assert tuple(ts.textures["texels_t"].shape) == (4, 87381)


def _trace_all(any_hit, mask, n_inst, R, seed):
    sc = _instanced_scene(n_inst)
    rows = np.asarray(sc.bvh_soa["wrows_tlas"])
    assert rows.shape[0] <= ROWS and sc.stack_size <= STACK
    rows = np.concatenate(
        [rows, np.zeros((ROWS - rows.shape[0], rows.shape[1]), np.float32)])
    bvh = dict(sc.bvh_soa, wrows_tlas=jnp.asarray(rows))
    ro, rd, t_min, t_max, active = _rays(R, seed)
    jm = None if mask is None else jnp.asarray(mask)
    xla = jtrav._traverse_wide_tlas(bvh, ro, rd, t_min, t_max, active,
                                    jm, sc.max_leaf, STACK, any_hit=any_hit)
    pal = trace_tlas_pallas(bvh, ro, rd, t_min, t_max, active, jm,
                            max_leaf=sc.max_leaf, stack_size=STACK,
                            any_hit=any_hit, interpret=True)
    port = ttrav.trace_tlas_plain(
        _t(rows), int(sc.bvh_soa["winst_base"]), _t(ro),
        _t(rd), _t(t_min), _t(t_max), _t(active),
        None if mask is None else _t(mask), sc.max_leaf, STACK,
        any_hit=any_hit)
    pal_inst = jnp.where(pal[1] >= 0, pal[5] - sc.bvh_soa["winst_base"], -1)
    return xla, pal, pal_inst, port


def _assert_hits(port, xla, pal, pal_inst, any_hit, uv_atol=1e-6):
    p = {k: getattr(port, k).numpy() for k in port._fields}
    for ref, inst in ((xla, xla.inst), (None, pal_inst)):
        prim = np.asarray(pal[1] if ref is None else ref.prim)
        if any_hit:
            np.testing.assert_array_equal(p["prim"] >= 0, prim >= 0)
            continue
        np.testing.assert_array_equal(p["prim"], prim)
        np.testing.assert_array_equal(p["inst"], np.asarray(inst))
        t = np.asarray(pal[0] if ref is None else ref.t)
        u = np.asarray(pal[2] if ref is None else ref.u)
        v = np.asarray(pal[3] if ref is None else ref.v)
        bf = np.asarray(pal[4] != 0 if ref is None else ref.backface)
        np.testing.assert_array_equal(p["backface"], bf)
        np.testing.assert_allclose(p["t"], t, rtol=1e-6)
        np.testing.assert_allclose(p["u"], u, rtol=1e-5, atol=uv_atol)
        np.testing.assert_allclose(p["v"], v, rtol=1e-5, atol=uv_atol)


# u/v atol by instance count.  At 64 instances (scaled 0.5-1.4 and packed
# into the same 4-unit cube) 4 of 512 rays hit a triangle whose u is badly
# conditioned in float32: the port's u equals a numpy float32 sequential
# re-evaluation of the hit bit for bit (lane 60: 0.30923396; float64
# 0.30923974), XLA's CPU code gives 0.30923814, as does the Pallas kernel in
# interpret mode.  Measured up to 4.2e-6 in u and 3.8e-6 in v; bounded at
# 1e-5.
UV_ATOL = {6: 1e-6, 64: 1e-5}


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_inst", [6, 64])
def test_trace_tlas_plain_matches_ray_tpu(n_inst, any_hit):
    xla, pal, pal_inst, port = _trace_all(any_hit, None, n_inst, 512, 0)
    assert 0 < int((port.prim >= 0).sum()) < 512
    _assert_hits(port, xla, pal, pal_inst, any_hit, UV_ATOL[n_inst])
    if any_hit:  # the walk stops at the first hit: a hit record, not t_max
        hit = port.prim >= 0
        assert bool((port.inst[hit] >= 0).all())


@pytest.mark.parametrize("n_inst", [6, 64])
def test_trace_tlas_plain_ray_mask(n_inst):
    """Per-ray-type instance visibility gates BLAS entry identically."""
    mask = (np.arange(512) % 3 == 0).astype(np.int32) * 0x7fffffff
    xla, pal, pal_inst, port = _trace_all(False, mask, n_inst, 512, 5)
    _assert_hits(port, xla, pal, pal_inst, False, UV_ATOL[n_inst])
    assert not bool((port.prim[torch.from_numpy(mask == 0)] >= 0).any())


def test_trace_tlas_wrapper_runs_plain_on_cpu():
    sc = _instanced_scene(6)
    ro, rd, t_min, t_max, active = (_t(a) for a in _rays(128, 2))
    args = (_t(sc.bvh_soa["wrows_tlas"]), int(sc.bvh_soa["winst_base"]), ro,
            rd, t_min, t_max, active, None, sc.max_leaf, sc.stack_size)
    for any_hit in (False, True):
        a = ttrav.trace_tlas(*args, any_hit=any_hit)
        b = ttrav.trace_tlas_plain(*args, any_hit=any_hit)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_tlas_plain_padded_rows(any_hit):
    """``max_leaf`` 6 gives ``wrows_tlas`` width 66, not a multiple of 4
    floats: the kernel reads the cached copy padded to 68 columns
    (``check_tlas_rows``).  The plain walk on the padded and the unpadded
    table gives the same hits, bit for bit."""
    from ray_tpu_torch.utils.test_scenes import instanced_scene

    sc = instanced_scene(n_inst=6).finalize(device="cpu", max_leaf=6)
    rows = sc.bvh_soa["wrows_tlas"]
    padded = ttrav.check_tlas_rows(rows)
    assert rows.shape[1] == 66 and padded.shape[1] == 68
    assert torch.equal(padded[:, :66].view(torch.int32),
                       rows.view(torch.int32))
    assert not padded[:, 66:].any()
    assert ttrav.check_tlas_rows(rows) is padded  # cached
    rays = tuple(_t(a) for a in _rays(512, 4))
    a, b = (ttrav.trace_tlas_plain(r, int(sc.bvh_soa["winst_base"]), *rays,
                                   None, 6, sc.stack_size, any_hit=any_hit)
            for r in (rows, padded))
    assert int((a.prim >= 0).sum()) > 0
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f


def test_trace_tlas_plain_counts_work():
    """The work counts the bound is computed from: one per node step,
    instance entry and valid triangle slot tested."""
    sc = _instanced_scene(6)
    ro, rd, t_min, t_max, active = (_t(a) for a in _rays(64, 3))
    work = {}
    hit = ttrav.trace_tlas_plain(
        _t(sc.bvh_soa["wrows_tlas"]), int(sc.bvh_soa["winst_base"]), ro, rd,
        t_min, t_max, active, None, sc.max_leaf, sc.stack_size, work=work)
    assert set(work) == {"node_steps", "inst_entries", "tri_tests"}
    n_hit = int((hit.prim >= 0).sum())
    assert work["inst_entries"] >= n_hit > 0
    assert work["tri_tests"] >= n_hit
    assert work["node_steps"] >= int(active.sum())


def test_colonnade_tile_matches_ray_tpu(colonnade):
    """A 31x32 tile across columns, terrain and floor at bench.py's
    big-scene settings (992 lanes: no compaction on either side; the port's
    compacted tile is held to its uncompacted one below).

    All of test_torch_render.py's bounds hold except the normal part of
    ``depth_normal``, held to atol 1e-5 instead of 1e-6.  The cause: a
    primary ray meets a column triangle ~0.05 units wide from ~13 units
    away, so the barycentric u of the hit is conditioned ~1e4 in float32.
    The port computes it IEEE-sequentially (as its CUDA kernel does, bit
    for bit); XLA's CPU code does not.  On pixel 69 the port gets
    u = 0.32089567 (numpy float32, sequential: 0.32089567), ray_tpu
    0.32092616, float64 0.32092112; with the column's smooth vertex
    normals that moves N by up to 2.8e-6.  Depth stays within rtol 1e-5."""
    js = colonnade["js"]
    ref = j_render(js, colonnade["jcam"], None, jnp.int32(REF_TILE["x0"]),
                   jnp.int32(REF_TILE["y0"]), jnp.uint32(1), jnp.uint32(0),
                   width=W, height=H, tile_w=REF_TILE["tile_w"],
                   tile_h=REF_TILE["tile_h"], settings=JPass(**BIG),
                   use_filter_table=False)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = _render(colonnade["ts"], colonnade["tcam"], REF_TILE)
    # the tile shows the texture and all three materials
    assert len(np.unique(ref["base_color"], axis=0)) > 200
    assert ref["color"].mean() > 0.0
    n_close = np.isclose(out["depth_normal"][:, :3], ref["depth_normal"][:, :3],
                         rtol=0.0, atol=1e-5).all(-1)
    assert n_close.mean() >= 0.999, n_close.mean()
    out = dict(out, depth_normal=out["depth_normal"][:, 3:])
    ref = dict(ref, depth_normal=ref["depth_normal"][:, 3:])
    _check(out, ref)


def test_compaction_does_not_change_the_tile(colonnade, port_tile):
    off = _render(colonnade["ts"], colonnade["tcam"], compact_after=0)
    for k in ("color", "base_color", "depth_normal", "rays_traced"):
        assert np.array_equal(port_tile[k], off[k]), k


def test_from_numpy_colonnade_renders_like_the_port(colonnade, port_tile):
    """ray_tpu's finalized colonnade carried across by ``from_numpy``
    renders the port's own tile bit for bit."""
    js = colonnade["js"]
    arrays = {n: jax.tree_util.tree_map(np.asarray, getattr(js, n))
              for n in _ARRAYS}
    static = {n: getattr(js, n) for n in _STATIC}
    scene = SceneFlat.from_numpy(arrays, static, device="cpu")
    out = _render(scene, colonnade["tcam"])
    for k in ("color", "base_color", "depth_normal", "rays_traced"):
        assert np.array_equal(out[k], port_tile[k]), k


def test_small_tlas_scene_raises_for_the_binary_walk(monkeypatch):
    """A two-level scene of ≤ 256 unique triangles carries no
    ``wrows_tlas``; ray_tpu walks it with the binary ``_traverse_tlas``.
    The port raised here until ROADMAP Queue 1 item 19 was ported; now its
    traces take ``trace_tlas_bin`` (held against ray_tpu in
    tests/test_torch_tlas_binary.py)."""
    from ray_tpu_torch.utils.test_scenes import cornell_scene

    sc, cam = cornell_scene()
    sc.add_instance(0)
    sc.add_instance(0)
    scene = sc.finalize(device="cpu")
    assert scene.mode == "tlas" and "wrows_tlas" not in scene.bvh_soa
    calls = []
    real = ttrav.trace_tlas_bin
    monkeypatch.setattr(ttrav, "trace_tlas_bin",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = render_tile(scene, cam, None, 0, 0, 1, 0, width=8, height=8,
                      tile_w=8, tile_h=8, settings=PassSettings(),
                      use_filter_table=False)
    assert bool(torch.isfinite(out["color"]).all()) and len(calls) >= 2
