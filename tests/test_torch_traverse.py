"""ray_tpu_torch's traces against ray_tpu's traversal on the CPU.

On the CPU, ``ray_tpu.ops.traverse.trace_closest_soa`` runs its XLA BVH walk
(``_traverse``), not a Pallas kernel; the port's CPU path runs the plain
PyTorch version of the kernel its router picks: ``trace_brute_plain`` up to
40 triangles, ``trace_bvh_plain`` (a tensor port of ``_traverse``) up to
512 node or triangle rows.  Both sides pick the same triangle for every
ray, so ``prim``, ``backface`` and the occlusion verdict must be identical.

The hit floats are NOT compared bit for bit: XLA's CPU code generation does
not evaluate the Möller–Trumbore expressions as IEEE-sequential float32
(it fuses and reassociates), while the port's plain version does.  Measured
on this generator: about half of the hit ``t``/``u``/``v`` differ by a few
ulps.  Over seeds 0-5 at 8, 24 and 40 triangles (20k rays each) the
largest differences were 5.1e-5 absolute in ``t`` (2.3e-5 relative, at a
small ``t``: the error follows the scene's coordinate scale, ~10 units, not
``t`` itself) and 5.3e-5 absolute in ``u``/``v``.  So a hit's ``t`` is held
to rtol 1e-5 plus atol 1e-5 — rtol alone fails on the shortest hits — and
``u``/``v`` to atol 1e-4; a miss returns ``t_max`` exactly on both sides.  The
bit-exact gate lives on the card, where the CUDA kernel is held against the
same plain version with IEEE arithmetic and no contraction on both sides
(``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.traverse import _soa_from_arrays
from ray_tpu.ops.traverse import trace_closest_soa as j_closest
from ray_tpu.ops.traverse import trace_occlusion_soa as j_occlusion
from ray_tpu.scene.bvh import build_bvh2, tri_bounds
from ray_tpu_torch.ops import traverse as tt

# one intra-op thread, as in tests/test_torch_scene.py
torch.set_num_threads(1)


def _scene(n_tris, seed, max_leaf=4):
    """tests/test_traverse_pallas.py's generator: reference SoA tables and
    the port's (same leaf order).  No ``wrows``: ray_tpu walks the BVH2."""
    r = np.random.RandomState(seed)
    base = (r.rand(n_tris, 1, 3) - 0.5) * 10.0
    size = max(0.8, 12.0 / np.sqrt(n_tris))
    tris = base + (r.rand(n_tris, 3, 3) - 0.5) * size
    v = tris.reshape(-1, 3).astype(np.float32)
    t = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    lo, hi = tri_bounds(v, t)
    b = build_bvh2(lo, hi, max_leaf=max_leaf)
    bvh, tsoa = _soa_from_arrays(
        jnp.asarray(b.child_lo), jnp.asarray(b.child_hi),
        jnp.asarray(b.child), jnp.asarray(b.prim_indices),
        jnp.asarray(v), jnp.asarray(t),
    )
    port_bvh = {k: torch.from_numpy(np.array(x)) for k, x in bvh.items()}
    port_tris = {k: torch.from_numpy(np.array(x)) for k, x in tsoa.items()}
    return (bvh, tsoa, b.max_leaf), (port_bvh, port_tris)


def _rays(n, seed):
    r = np.random.RandomState(seed)
    ro = (r.rand(n, 3).astype(np.float32) - 0.5) * 12.0
    target = (r.rand(n, 3).astype(np.float32) - 0.5) * 6.0
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t_max = np.where(r.rand(n) < 0.8, 1e30, r.rand(n) * 8.0).astype(np.float32)
    active = r.rand(n) < 0.95
    return ro, rd.astype(np.float32), np.zeros(n, np.float32), t_max, active


def _both(n_tris, seed, n_rays=20000, max_leaf=4, t_window=False):
    (jb, jt, ml), (tb, tt_) = _scene(n_tris, seed, max_leaf)
    ro, rd, tmin, tmax, act = _rays(n_rays, seed + 7)
    if t_window:
        # a t_min window on a third of the lanes (t_max varies in _rays)
        r = np.random.RandomState(seed + 8)
        tmin = np.where(r.rand(n_rays) < 0.3, r.rand(n_rays) * 4.0,
                        0.0).astype(np.float32)
    j = [jnp.asarray(a) for a in (ro, rd, tmin, tmax, act)]
    t = [torch.from_numpy(a) for a in (ro, rd, tmin, tmax, act)]
    return (jb, jt, ml, j), (tb, tt_, t)


def _check_closest(hit, ref):
    prim = hit.prim.numpy()
    # discrete outputs: exact
    np.testing.assert_array_equal(prim, np.asarray(ref.prim))
    hits = prim >= 0
    assert 0.02 < hits.mean() < 0.98, hits.mean()
    np.testing.assert_array_equal(hit.backface.numpy()[hits],
                                  np.asarray(ref.backface)[hits])
    # floats: a few ulps apart (module docstring); misses return t_max
    np.testing.assert_array_equal(hit.t.numpy()[~hits], np.asarray(ref.t)[~hits])
    np.testing.assert_allclose(hit.t.numpy()[hits], np.asarray(ref.t)[hits],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hit.u.numpy()[hits], np.asarray(ref.u)[hits],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(hit.v.numpy()[hits], np.asarray(ref.v)[hits],
                               rtol=0, atol=1e-4)
    assert hit.prim.dtype == torch.int32 and hit.backface.dtype == torch.bool


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_tris", [8, 24, 40])
def test_closest_hit_matches_ray_tpu(n_tris, seed):
    (jb, jt, ml, j), (tb, tt_, t) = _both(n_tris, seed)
    ref = j_closest(jb, jt, *j, max_leaf=ml)
    hit = tt.trace_closest_soa(tb, tt_, *t, max_leaf=ml)
    _check_closest(hit, ref)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_tris", [8, 24, 40])
def test_occlusion_matches_ray_tpu(n_tris, seed):
    (jb, jt, ml, j), (tb, tt_, t) = _both(n_tris, seed)
    ref = np.asarray(j_occlusion(jb, jt, *j, max_leaf=ml))
    occ = tt.trace_occlusion_soa(tb, tt_, *t, max_leaf=ml).numpy()
    assert occ.dtype == np.bool_
    np.testing.assert_array_equal(occ, ref)
    assert 0.02 < occ.mean() < 0.98


def test_intersect_tri_matches_ray_tpu():
    """``intersect_tri`` (one triangle per ray, broadcast): the verdict and
    backface exact, the floats within the bounds of the module docstring."""
    from ray_tpu.ops.intersect import intersect_tri as j_isect
    from ray_tpu_torch.ops.intersect import intersect_tri as t_isect

    r = np.random.RandomState(5)
    n = 20000
    ro, rd, tmin, tmax, _ = _rays(n, 6)
    p = ((r.rand(n, 1, 3) - 0.5) * 4.0
         + (r.rand(n, 3, 3) - 0.5) * 6.0).astype(np.float32)
    args = (ro, rd, p[:, 0], p[:, 1], p[:, 2], tmin, tmax)
    ref = [np.asarray(x) for x in j_isect(*[jnp.asarray(a) for a in args])]
    out = [x.numpy() for x in t_isect(*[torch.from_numpy(a) for a in args])]
    hit = ref[0]
    assert 0.02 < hit.mean() < 0.98, hit.mean()
    np.testing.assert_array_equal(out[0], hit)
    np.testing.assert_array_equal(out[4][hit], ref[4][hit])
    np.testing.assert_allclose(out[1][hit], ref[1][hit], rtol=1e-5, atol=1e-5)
    for k in (2, 3):
        np.testing.assert_allclose(out[k][hit], ref[k][hit], rtol=0, atol=1e-4)


def test_plain_misses_and_inactive_lanes():
    """Misses and inactive lanes return t = t_max, prim = -1, u = v = 0,
    backface = False — in both modes."""
    _, (tb, tt_) = _scene(24, 3)
    ro, rd, tmin, tmax, act = (torch.from_numpy(a) for a in _rays(4000, 11))
    act[:] = False
    for any_hit in (False, True):
        h = tt.trace_brute_plain(tt_["packed"], ro, rd, tmin, tmax, act, any_hit)
        assert torch.equal(h.t, tmax)
        assert bool((h.prim == -1).all()) and not bool(h.backface.any())
        assert not bool(h.u.any()) and not bool(h.v.any())


def test_any_hit_takes_first_passing_triangle():
    """Any-hit returns the lowest-index triangle that passes t < t_max;
    its verdict equals the closest-hit's."""
    _, (tb, tt_) = _scene(40, 4)
    ro, rd, tmin, tmax, act = (torch.from_numpy(a) for a in _rays(8000, 12))
    tris = tt_["packed"]
    closest = tt.trace_brute_plain(tris, ro, rd, tmin, tmax, act, False)
    anyhit = tt.trace_brute_plain(tris, ro, rd, tmin, tmax, act, True)
    assert torch.equal(closest.prim >= 0, anyhit.prim >= 0)
    hit = anyhit.prim >= 0
    assert bool((anyhit.prim[hit] <= closest.prim[hit]).all())
    for k in range(tris.shape[0]):
        # no lower-index triangle passes for a lane whose first hit is k
        lanes = anyhit.prim == k
        if k and bool(lanes.any()):
            lower = tt.trace_brute_plain(tris[:k], ro[lanes], rd[lanes],
                                         tmin[lanes], tmax[lanes], act[lanes])
            assert bool((lower.prim < 0).all())


@pytest.mark.parametrize("max_leaf", [4, 8])
@pytest.mark.parametrize("n_tris", [100, 300, 500])
def test_bvh_closest_hit_matches_ray_tpu(n_tris, max_leaf):
    """Past 40 triangles the port walks the BVH2 (``trace_bvh_plain``), as
    ray_tpu's ``_traverse`` does; inactive lanes and a t_min/t_max window
    included.  Same bounds as the brute-force case."""
    (jb, jt, ml, j), (tb, tt_, t) = _both(n_tris, 10 + n_tris, n_rays=10000,
                                          max_leaf=max_leaf, t_window=True)
    assert tt._trace_mode(tb["code0"].shape[0], n_tris) == "bvh"
    ref = j_closest(jb, jt, *j, max_leaf=ml)
    hit = tt.trace_closest_soa(tb, tt_, *t, max_leaf=ml)
    _check_closest(hit, ref)


@pytest.mark.parametrize("max_leaf", [4, 8])
@pytest.mark.parametrize("n_tris", [100, 300, 500])
def test_bvh_occlusion_matches_ray_tpu(n_tris, max_leaf):
    (jb, jt, ml, j), (tb, tt_, t) = _both(n_tris, 20 + n_tris, n_rays=10000,
                                          max_leaf=max_leaf, t_window=True)
    ref = np.asarray(j_occlusion(jb, jt, *j, max_leaf=ml))
    occ = tt.trace_occlusion_soa(tb, tt_, *t, max_leaf=ml).numpy()
    np.testing.assert_array_equal(occ, ref)
    assert 0.02 < occ.mean() < 0.98


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_stack_overflow_matches_ray_tpu(any_hit):
    """A stack shallower than the tree: a push at ``sp >= S`` is dropped but
    counted, and its pop yields EMPTY — the far subtree is skipped exactly
    as ray_tpu skips it."""
    from ray_tpu.ops.traverse import _traverse

    (jb, jt, ml, j), (tb, tt_, t) = _both(300, 5, n_rays=10000)
    ref = _traverse(jb, jt, *j, ml, 2, any_hit)
    hit = tt.trace_bvh_plain(tb["packed"], tt_["packed"], *t, ml, 2, any_hit)
    full = tt.trace_bvh_plain(tb["packed"], tt_["packed"], *t, ml, 64,
                              any_hit)
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    # the shallow stack loses hits the full one finds
    assert int((hit.prim < 0).sum()) > int((full.prim < 0).sum())


def test_bvh_work_counts():
    """``work`` counts node steps and triangle tests (the kernel bound's
    inputs); any-hit stops early, so it never does more."""
    _, (tb, tt_) = _scene(300, 2, max_leaf=8)
    ro, rd, tmin, tmax, act = (torch.from_numpy(a) for a in _rays(4000, 3))
    counts = []
    for any_hit in (False, True):
        work = {}
        tt.trace_bvh_plain(tb["packed"], tt_["packed"], ro, rd, tmin, tmax,
                           act, 8, 64, any_hit, work=work)
        counts.append(work)
    closest, anyhit = counts
    assert closest["node_steps"] >= int(act.sum())
    assert 0 < anyhit["tri_tests"] <= closest["tri_tests"]
    assert 0 < anyhit["node_steps"] <= closest["node_steps"]


def test_bigger_scenes_raise():
    """Past 512 node or triangle rows without an 8-wide table (only
    hand-built tables: finalize adds ``wrows`` past 256 triangles) the
    router raised until ROADMAP Queue 1 item 19 was ported; now it takes
    the BVH2 walk, as ray_tpu's XLA ``_traverse`` does, and matches it."""
    (jb, jt, ml, j), (tb, tt_, t) = _both(513, 0, n_rays=2000)
    assert tt._trace_mode(tb["code0"].shape[0], 513) == "bvh"
    _check_closest(tt.trace_closest_soa(tb, tt_, *t, max_leaf=ml),
                   j_closest(jb, jt, *j, max_leaf=ml))
    np.testing.assert_array_equal(
        tt.trace_occlusion_soa(tb, tt_, *t, max_leaf=ml).numpy(),
        np.asarray(j_occlusion(jb, jt, *j, max_leaf=ml)))
