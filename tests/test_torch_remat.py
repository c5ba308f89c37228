"""Path replay (``PassSettings.remat``) on the CPU.

* With ``remat_save_trace`` (the default) the backward replays each
  bounce's shading from its saved trace outputs and calls no trace; without
  it the replay calls exactly the forward's traces again.  Counted on the
  plain trace functions, which the wrappers run on the CPU.
* The colonnade's 32x32 tile that ``tests/test_torch_tlas.py`` compacts,
  at bench.py's big-scene settings (the settings bench.py runs the
  colonnade's fwd+bwd with, remat included): ``remat=True`` gives the loss
  of ``remat=False`` bit for bit and its gradients within rtol 1e-5.
* The colonnade's PRINCIPLED shading gradients against ``jax.grad``:
  ``gather_uber_params`` → ``eval_uber`` and ``sample_uber`` on synthetic
  lanes (numpy seed) over the colonnade's material table and texture,
  differentiated w.r.t. every float material column.  ``jax.grad`` of a
  whole colonnade tile takes minutes on this CPU; this holds the same
  shading math at the module level.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.render import uber as juber
from ray_tpu.utils.test_scenes import colonnade_scene as j_colonnade
from ray_tpu_torch.ops import traverse
from ray_tpu_torch.render import uber as tuber
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.utils.test_scenes import colonnade_scene as t_colonnade
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell
import test_torch_scene  # noqa: F401  (one intra-op thread)

W, H = 1920, 1080
# bench.py's big-scene fwd+bwd settings (bench.py:154-159)
BIG = dict(max_total_depth=5, min_total_depth=2, compact_after=2,
           compact_factor=4, remat=True)
# tests/test_torch_tlas.py's compacted colonnade tile
TILE = dict(x0=944, y0=524, tile_w=32, tile_h=32)
PLAIN_TRACES = ("trace_brute_plain", "trace_bvh_plain", "trace_tlas_plain")


@pytest.fixture
def trace_calls(monkeypatch):
    """Counts calls of the plain trace functions, and the lane counts they
    see."""
    calls = collections.Counter()
    lanes = []
    for name in PLAIN_TRACES:
        real = getattr(traverse, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            # ro follows the tables: one for brute, two for bvh and tlas
            ro = args[1 if _name == "trace_brute_plain" else 2]
            lanes.append(ro.shape[0])
            return _real(*args, **kw)
        monkeypatch.setattr(traverse, name, counted)
    return calls, lanes


@pytest.fixture(scope="module")
def colonnade():
    """The colonnade finalized by each package (the port's on the CPU)."""
    jsc, _ = j_colonnade()
    tsc, tcam = t_colonnade()
    return jsc.finalize(), tsc.finalize(device="cpu"), tcam


def _fwd_bwd(scene, cam, tile, calls, **settings):
    """The bench loss and its gradients w.r.t. every float material column
    and env_col; the trace calls of the forward and of the backward."""
    params = {k: v.clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    env = scene.env_col.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, materials={**scene.materials, **params},
                             env_col=env)
    calls.clear()
    out = render_tile(sc, cam, None, tile["x0"], tile["y0"], 1, 0, width=W,
                      height=H, tile_w=tile["tile_w"], tile_h=tile["tile_h"],
                      settings=PassSettings(**settings),
                      use_filter_table=False)
    loss = (out["color"] ** 2).sum() / (H * W * 3)
    fwd = collections.Counter(calls)
    loss.backward()
    bwd = collections.Counter(calls) - fwd
    grads = {k: p.grad for k, p in params.items()}
    grads["env_col"] = env.grad
    return loss.detach(), grads, fwd, bwd


@pytest.mark.parametrize("save_trace", [True, False])
def test_remat_backward_trace_calls(trace_calls, save_trace):
    """A 16x16 flagship tile at depth 3: 4 closest + 4 shadow traces
    forward; the backward adds none with ``remat_save_trace``, the same 8
    without it, and none without remat."""
    calls, _ = trace_calls
    sc, cam = t_cornell()
    scene = sc.finalize(device="cpu")
    tile = dict(x0=952, y0=116, tile_w=16, tile_h=16)
    depth = dict(max_total_depth=3, min_total_depth=3)
    _, _, fwd, bwd = _fwd_bwd(scene, cam, tile, calls, remat=True,
                              remat_save_trace=save_trace, **depth)
    assert fwd == {"trace_brute_plain": 8}
    assert bwd == ({} if save_trace else fwd)
    _, _, fwd0, bwd0 = _fwd_bwd(scene, cam, tile, calls, **depth)
    assert fwd0 == fwd and bwd0 == {}


def test_colonnade_remat_matches_stored_residuals(trace_calls, colonnade):
    """Compaction engages (the last bounces trace fewer lanes than the
    tile's); remat's loss is bit-identical and its gradients within rtol
    1e-5 (backward sums in another order); its backward traces nothing."""
    calls, lanes = trace_calls
    _, scene, cam = colonnade
    loss_r, g_r, fwd, bwd = _fwd_bwd(scene, cam, TILE, calls, **BIG)
    R = TILE["tile_w"] * TILE["tile_h"]
    assert fwd == {"trace_tlas_plain": 12} and bwd == {}
    assert min(lanes) < R == max(lanes), lanes
    loss_s, g_s, _, _ = _fwd_bwd(scene, cam, TILE, calls,
                                 **dict(BIG, remat=False))
    assert float(loss_s) > 0.0
    assert torch.equal(loss_r, loss_s)
    assert g_s["base_color"].abs().max() > 0.0
    assert g_s["env_col"].abs().max() > 0.0
    for k, g in g_s.items():
        if g is None:
            assert g_r[k] is None, k
            continue
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g_r[k].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# PRINCIPLED shading gradients against jax.grad
# ---------------------------------------------------------------------------

LANES = 1024


def _lanes(n_mat, seed):
    """Synthetic shading lanes: orthonormal frames, view and light
    directions, uvs, material ids (-1 included) and random numbers."""
    r = np.random.RandomState(seed)

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
            np.float32)

    N = unit(r.randn(LANES, 3))
    T = unit(np.cross(N, unit(r.randn(LANES, 3))))
    B = np.cross(N, T).astype(np.float32)
    # mostly from the front side, some from behind
    I = unit(-N * np.where(r.rand(LANES, 1) < 0.85, 1.0, -1.0)
             + 0.8 * r.randn(LANES, 3))
    L = unit(N * np.where(r.rand(LANES, 1) < 0.8, 1.0, -1.0)
             + 0.8 * r.randn(LANES, 3))
    return dict(
        mat=r.randint(-1, n_mat, LANES).astype(np.int32),
        uv=r.uniform(-0.5, 1.5, (LANES, 2)).astype(np.float32),
        T=T, B=B, N=N, I=I, L=L,
        backface=r.rand(LANES) < 0.1,
        ext_ior=np.where(r.rand(LANES) < 0.2, 1.5, 1.0).astype(np.float32),
        tex_rand=r.rand(LANES, 2).astype(np.float32),
        reg=np.where(r.rand(LANES) < 0.5, 0.03, 0.0).astype(np.float32),
        lam=r.uniform(-12.0, -4.0, LANES).astype(np.float32),
        rand2=r.rand(LANES, 2).astype(np.float32),
        mix=r.rand(LANES).astype(np.float32),
        # the loss's weights of f_cos, the NEE pdf, the sample's
        # throughput weight, direction and pdf
        w=r.rand(LANES, 11).astype(np.float32),
    )


def _shade(mod, xp, scene, lanes, feats):
    """Sum of weighted gather → eval and gather → sample outputs."""
    a = {k: xp(v) for k, v in lanes.items()}
    p = mod.gather_uber_params(
        scene, a["mat"], a["uv"], a["I"], a["N"], a["backface"],
        a["ext_ior"], a["tex_rand"], regularize_alpha=a["reg"],
        lam=a["lam"], feats=feats, fetch_kw={"rand": a["tex_rand"]})
    f_cos, pdf = mod.eval_uber(p, a["T"], a["B"], a["N"], a["I"], a["L"],
                               feats=feats)
    bs = mod.sample_uber(p, a["T"], a["B"], a["N"], a["I"], a["rand2"],
                         a["mix"], feats=feats)
    w = a["w"]
    # the pdfs enter through a bounded function (a delta lobe's is ~1e6)
    return ((f_cos * w[:, 0:3]).sum() + (pdf / (1.0 + pdf) * w[:, 3]).sum()
            + (bs.weight * w[:, 4:7]).sum() + (bs.dir * w[:, 7:10]).sum()
            + (bs.pdf / (1.0 + bs.pdf) * w[:, 10]).sum())


@pytest.mark.parametrize("seed", [0])
def test_principled_shading_gradients_match_jax(colonnade, seed):
    """Every float material column of the colonnade (its texture read
    through ``base_texture``) within ``rtol 1e-4, atol 3e-4 · max |g_jax|``
    of ``jax.grad``: the gather is exact and the lobe math agrees to
    float32 rounding.  Measured max |diff| / max |g|: 8.6e-5 on
    ``roughness`` (a GGX-sampled direction on a grazing lane amplifies an
    ulp), at most 8.2e-7 on every other column (and at most 9.5e-7 on
    every column at seed 1)."""
    js, ts, _ = colonnade
    lanes = _lanes(ts.materials["type"].shape[0], seed)
    jf = juber.mat_features(js.mat_types)
    tf = tuber.mat_features(ts.mat_types)
    assert tf.principled and not tf.diffuse

    j_cols = {k: v for k, v in js.materials.items()
              if jnp.issubdtype(v.dtype, jnp.floating)}

    def j_loss(cols):
        sc = dataclasses.replace(js, materials={**js.materials, **cols})
        return _shade(juber, jnp.asarray, sc, lanes, jf)

    j_g = jax.grad(j_loss)(j_cols)

    t_cols = {k: v.clone().requires_grad_(True)
              for k, v in ts.materials.items() if v.is_floating_point()}
    sc = dataclasses.replace(ts, materials={**ts.materials, **t_cols})
    loss = _shade(tuber, lambda v: torch.from_numpy(np.array(v)), sc, lanes,
                  tf)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss(j_cols)),
                               rtol=1e-5)
    assert set(t_cols) == set(j_g)
    nonzero = 0
    for k, gj in j_g.items():
        gj = np.asarray(gj)
        gt = t_cols[k].grad
        gt = np.zeros_like(gj) if gt is None else gt.numpy()
        scale = float(np.abs(gj).max())
        nonzero += scale > 0.0
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=3e-4 * scale,
                                   err_msg=k)
    assert nonzero >= 8, nonzero
