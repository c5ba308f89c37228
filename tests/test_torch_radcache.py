"""The spatial radiance cache (``ray_tpu_torch.render.radcache``) against
``ray_tpu.render.radcache``, on the CPU.

* ``compute_hash``: keys and slot hash bit-exact on seeded points (both
  signs, several grid levels) and normals.
* ``claim_entries`` on 20,000 colliding lanes over 2^6 entries: the key
  tables, entries and ok flags bit-equal to ray_tpu's (XLA keeps the last
  writer of a slot; the port picks the highest lane by a max-reduce).
* ``accumulate`` (``index_add_`` on the CPU), ``resolve`` and ``query`` on
  a state carried across from ray_tpu (``cache_from_numpy``): every table
  bit-equal, the count cap and aging included.
* ``Renderer`` with ``use_spatial_cache`` (update → resolve → query, 6
  samples of a 24x24 flagship) against ray_tpu's: the hit positions differ
  by ulps, so a few vertices land in a neighbouring voxel — at least 99%
  of either cache's keys are the other's, the warm-entry counts within
  10%, the image's pixels within rtol 1e-3 / atol 1e-4 on >= 99% and its
  mean within 1e-3 relative.
* ``tests/test_radcache.py``'s poison test on the port: every warm voxel
  painted red, a query render shows red query-terminated pixels.
* With ``remat`` a query render's replay makes the forward's queries: the
  loss is bit-identical to stored residuals and the gradients equal.
* ``save_state`` / ``load_state`` carry the cache, and ray_tpu's saved
  state loads.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.render import radcache as J
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.renderer import Renderer as JRenderer
from ray_tpu.render.renderer import RenderSettings as JRenderSettings
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.render import radcache as T
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.render.renderer import Renderer, RenderSettings
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell
import test_torch_scene  # noqa: F401  (one intra-op thread)

CAM = np.array([0.5, 1.0, -2.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_state(port, ref):
    for f in dataclasses.fields(T.CacheState):
        a = getattr(port, f.name).numpy()
        b = np.asarray(getattr(ref, f.name))
        if f.name.startswith("key"):
            b = b.astype(np.int64)
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8), b.view(np.uint8)), f.name


def _points(R, seed, scale=5.0):
    g = np.random.default_rng(seed)
    return ((g.standard_normal((R, 3)) * scale).astype(np.float32),
            g.standard_normal((R, 3)).astype(np.float32))


def test_hash_matches_ray_tpu():
    p, n = _points(20_000, 0)
    p[:50] *= 100.0       # far points: coarse levels
    p[50:100] *= 0.01     # near the camera anchor: level 1
    ref = J.compute_hash(jnp.asarray(p), jnp.asarray(n), jnp.asarray(CAM))
    port = T.compute_hash(_t(p), _t(n), _t(CAM))
    for a, b, name in zip(port, ref, ("key_lo", "key_hi", "slot_hash")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
            np.int64), err_msg=name)
    levels = T.grid_level(_t(p), _t(CAM)).numpy()
    assert len(np.unique(levels)) >= 5
    np.testing.assert_array_equal(
        levels, np.asarray(J.grid_level(jnp.asarray(p), jnp.asarray(CAM))))


def _claimed(entries=1 << 6, R=20_000, seed=1):
    g = np.random.default_rng(seed)
    p = (g.integers(-40, 40, (R, 3)) * 0.05).astype(np.float32)
    n = g.standard_normal((R, 3)).astype(np.float32)
    act = g.random(R) < 0.9
    rs, re, rok = J.claim_entries(J.make_cache(entries, CAM), jnp.asarray(p),
                                  jnp.asarray(n), jnp.asarray(act))
    ps, pe, pok = T.claim_entries(T.make_cache(entries, CAM, device="cpu"),
                                  _t(p), _t(n), _t(act))
    return (rs, re, rok), (ps, pe, pok), g


def test_claims_match_ray_tpu_under_collisions():
    (rs, re, rok), (ps, pe, pok), _ = _claimed()
    _same_state(ps, rs)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(re))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
    # every slot claimed, most lanes turned away
    assert int((ps.key_hi[:-1] != 0).sum()) == 64
    assert 64 <= int(pok.sum()) < 1_000


def test_accumulate_resolve_query_on_carried_states():
    (rs, re, rok), _, g = _claimed(entries=1 << 8, R=4_000, seed=2)
    R = re.shape[0]
    rad = (g.random((R, 3)) * 3).astype(np.float32)
    cnt = g.integers(1, 200, R).astype(np.int32)   # past the cap of 128
    ref = J.accumulate(rs, re, jnp.asarray(rad), jnp.asarray(cnt), rok)
    ref = J.resolve(ref)
    assert int(np.asarray(ref.cnt_prev).max()) == J.RAD_CACHE_SAMPLE_COUNT_MAX
    # one more frame on top of the resolved one, carried across
    p2, n2 = _points(R, 6, scale=2.0)
    rs2, re2, rok2 = J.claim_entries(ref, jnp.asarray(p2), jnp.asarray(n2),
                                     jnp.ones((R,), bool))
    port = T.cache_from_numpy({f: np.asarray(getattr(rs2, f))
                               for f in rs2._fields}, device="cpu")
    _same_state(port, rs2)
    ra = J.accumulate(rs2, re2, jnp.asarray(rad), jnp.asarray(cnt), rok2)
    pa = T.accumulate(port, _t(np.asarray(re2)), _t(rad), _t(cnt),
                      _t(np.asarray(rok2)))
    _same_state(pa, ra)
    rr, pr = J.resolve(ra), T.resolve(pa)
    _same_state(pr, rr)
    # aging frees untouched entries
    for _ in range(T.RAD_CACHE_STALE_FRAME_NUM_MAX + 1):
        rr, pr = J.resolve(rr), T.resolve(pr)
    _same_state(pr, rr)
    assert int((pr.key_hi != 0).sum()) == 0
    # query on the first resolved state, carried across
    port_q = T.cache_from_numpy([np.asarray(a) for a in ref], device="cpu")
    p, n = _points(R, 3, scale=2.0)
    p[: R // 2] = (np.random.default_rng(1).integers(-40, 40, (R // 2, 3))
                   * 0.05).astype(np.float32)
    act = np.random.default_rng(4).random(R) < 0.8
    jq = J.query(ref, jnp.asarray(p), jnp.asarray(n), jnp.asarray(act))
    tq = T.query(port_q, _t(p), _t(n), _t(act))
    np.testing.assert_array_equal(tq[0].numpy(), np.asarray(jq[0]))
    np.testing.assert_array_equal(tq[1].numpy(), np.asarray(jq[1]))


def test_accumulate_plain_adds_in_lane_order():
    """The plain version's sums are a sequential float32 loop's, bit for
    bit, on repeated entries (the order the CUDA kernel keeps)."""
    g = np.random.default_rng(5)
    R, N = 5_000, 16
    entry = g.integers(0, N, R)
    valid = g.random(R) < 0.7
    rad = (g.standard_normal((R, 3)) * 1e3).astype(np.float32)
    cnt = g.integers(0, 5, R).astype(np.int32)
    table = g.standard_normal((N + 1, 3)).astype(np.float32)
    cnt_t = g.integers(0, 9, N + 1).astype(np.int32)
    out_r, out_c = T.accumulate_segments(_t(table), _t(cnt_t), _t(entry),
                                         _t(rad), _t(cnt), _t(valid))
    exp_r, exp_c = table.copy(), cnt_t.copy()
    for i in range(R):
        if valid[i]:
            exp_r[entry[i]] += rad[i]
            exp_c[entry[i]] += cnt[i]
    np.testing.assert_array_equal(out_r.numpy(), exp_r)
    np.testing.assert_array_equal(out_c.numpy(), exp_c)


def test_accumulate_entries_outside_the_table():
    """A valid lane outside the table raises ``IndexError`` (the CUDA
    wrapper keeps the same contract); an invalid lane's entry, in range or
    not, is never read."""
    g = np.random.default_rng(6)
    R, N = 300, 8
    entry = g.integers(0, N + 1, R)
    valid = g.random(R) < 0.5
    rad = g.standard_normal((R, 3)).astype(np.float32)
    cnt = g.integers(0, 5, R).astype(np.int32)
    table = np.zeros((N + 1, 3), np.float32)
    cnt_t = np.zeros(N + 1, np.int32)
    wild = entry.copy()
    wild[~valid] = np.where(np.arange(R)[~valid] % 2, -7, N + 40)
    out = T.accumulate_segments(_t(table), _t(cnt_t), _t(wild), _t(rad),
                                _t(cnt), _t(valid))
    ref = T.accumulate_plain(_t(table), _t(cnt_t), _t(entry), _t(rad),
                             _t(cnt), _t(valid))
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    for bad in (N + 1, -1):
        wrong = entry.copy()
        wrong[np.flatnonzero(valid)[3]] = bad
        with pytest.raises(IndexError, match="outside the table"):
            T.accumulate_segments(_t(table), _t(cnt_t), _t(wrong), _t(rad),
                                  _t(cnt), _t(valid))


def test_cache_lives_on_cuda_by_default():
    """``make_cache`` / ``cache_from_numpy`` without ``device``: CUDA, or
    a raise where there is none (``resolve_device``)."""
    fields = T.make_cache(4, device="cpu").to_numpy()
    if torch.cuda.is_available():
        assert T.make_cache(4).key_lo.device.type == "cuda"
        assert T.cache_from_numpy(fields).rad_curr.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.make_cache(4)
        with pytest.raises(RuntimeError, match="CUDA"):
            T.cache_from_numpy(fields)


@pytest.fixture(scope="module")
def cached_renderers():
    """6 cached samples of a 24x24 flagship in each package (~20 s)."""
    (jsc, jcam), (tsc, tcam) = j_cornell("emissive_quad"), t_cornell(
        "emissive_quad")
    kw = dict(use_spatial_cache=True, cache_entries=1 << 14,
              cache_downsample=1)
    jr = JRenderer(JRenderSettings(24, 24, **kw),
                   JPass(max_total_depth=5, min_total_depth=2))
    tr = Renderer(RenderSettings(24, 24, **kw),
                  PassSettings(max_total_depth=5, min_total_depth=2),
                  device="cpu")
    jimg = np.asarray(jr.render(jsc.finalize(), jcam, 6))
    timg = tr.render(tsc.finalize(device="cpu"), tcam, 6).numpy()
    return jr, tr, jimg, timg


def test_cached_renderer_matches_ray_tpu(cached_renderers):
    jr, tr, jimg, timg = cached_renderers
    assert tr.cache_iteration == jr.cache_iteration == 6
    jk = set(zip(np.asarray(jr.cache.key_lo).tolist(),
                 np.asarray(jr.cache.key_hi).tolist())) - {(0, 0)}
    tk = set(zip(tr.cache.key_lo.tolist(), tr.cache.key_hi.tolist())) - {
        (0, 0)}
    shared = len(jk & tk)
    assert len(jk) > 1_000 and shared >= 0.99 * max(len(jk), len(tk))
    warm_j = int((np.asarray(jr.cache.cnt_prev)
                  >= J.RAD_CACHE_SAMPLE_COUNT_MIN).sum())
    warm_t = int((tr.cache.cnt_prev >= T.RAD_CACHE_SAMPLE_COUNT_MIN).sum())
    assert warm_j > 0 and abs(warm_t - warm_j) <= 0.1 * warm_j
    ok = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert ok >= 0.99, ok
    assert abs(timg.mean() - jimg.mean()) <= 1e-3 * jimg.mean()


def test_cached_state_round_trip(cached_renderers, tmp_path):
    """``save_state`` writes ray_tpu's layout: the port loads ray_tpu's
    file, and its own file back, cache included."""
    jr, tr, _, _ = cached_renderers
    jr.save_state(str(tmp_path / "ray_tpu.npz"))
    tr.save_state(str(tmp_path / "port.npz"))
    for name, ref in (("ray_tpu.npz", jr.cache), ("port.npz", None)):
        r = Renderer(RenderSettings(24, 24, use_spatial_cache=True,
                                    cache_entries=1 << 14), device="cpu")
        r.load_state(str(tmp_path / name))
        assert r.cache_iteration == 6 and r.iteration == tr.iteration
        if ref is not None:
            _same_state(r.cache, ref)
        else:
            for f in dataclasses.fields(T.CacheState):
                assert torch.equal(getattr(r.cache, f.name),
                                   getattr(tr.cache, f.name)), f.name


def test_cache_queries_terminate_paths():
    """tests/test_radcache.py's poison test on the port: paint every warm
    voxel bright red; a query render shows red pixels where paths ended on
    the cache."""
    sc, cam = t_cornell("emissive_quad")
    flat = sc.finalize(device="cpu")
    ps = PassSettings(max_total_depth=5, min_total_depth=2)
    rs = RenderSettings(32, 32, use_spatial_cache=True,
                        cache_entries=1 << 16, cache_downsample=1)
    r = Renderer(rs, ps, device="cpu")
    for i in range(16):
        r.update_spatial_cache(flat, cam, rand_seed=i)
        r.resolve_spatial_cache()
    cnts = r.cache.cnt_prev
    assert int((cnts >= T.RAD_CACHE_SAMPLE_COUNT_MIN).sum()) > 100
    red = torch.stack([cnts * 10.0, cnts * 0.0, cnts * 0.0], -1)
    pois = r.cache.replace(rad_prev=torch.where((cnts > 0)[:, None], red,
                                                r.cache.rad_prev))
    r2 = Renderer(rs, ps, device="cpu")
    r2.cache = pois
    img = r2.render_sample(flat, cam)["color"].reshape(32, 32, 3).numpy()
    frac = (img[..., 0] > 5.0).mean()
    assert frac > 0.2, frac


def test_remat_replays_the_same_queries():
    """A query render's gradients with remat (path replay) equal stored
    residuals': the cache is constant within a call, so the replay makes
    the forward's queries."""
    sc, cam = t_cornell("emissive_quad")
    scene = sc.finalize(device="cpu")
    r = Renderer(RenderSettings(16, 16, use_spatial_cache=True,
                                cache_entries=1 << 12, cache_downsample=1),
                 PassSettings(max_total_depth=3), device="cpu")
    for i in range(10):
        r.update_spatial_cache(scene, cam, rand_seed=i)
        r.resolve_spatial_cache()
    results = []
    for remat in (False, True):
        leaf = scene.materials["base_color"].clone().requires_grad_(True)
        s = dataclasses.replace(scene, materials={**scene.materials,
                                                  "base_color": leaf})
        out = render_tile(s, cam, None, 0, 0, 1, 0, width=16, height=16,
                          tile_w=16, tile_h=16,
                          settings=PassSettings(max_total_depth=3,
                                                remat=remat),
                          use_filter_table=False, cache=r.cache,
                          cache_mode="query")
        loss = (out["color"] ** 2).sum()
        loss.backward()
        results.append((loss.detach(), leaf.grad.clone()))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert torch.equal(g0, g1) and bool((g0 != 0).any())
