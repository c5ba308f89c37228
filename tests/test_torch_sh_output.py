"""The SH-L1 radiance output (``PassSettings(output_sh=True)``) on the CPU.

* A 16x16 flagship tile's ``shl1`` (R, 4, 3) against ray_tpu's
  ``render_tile``: each pixel's 12 coefficients within rtol 1e-3 /
  atol 1e-4 on ≥ 99% of pixels (tests/test_torch_render.py's color
  bound), the tile's other outputs within that file's bounds.
* tests/test_passes_tonemap.py:106-121's checks on the port: L0 is
  0.282095 × color (rtol 1e-4, atol 1e-5) and |L1| ≤ L0 × 0.488603 /
  0.282095.
* Compaction is off with ``output_sh``, as in ray_tpu: a 32x32 tile with
  ``compact_after=1`` gives the tile without it, bit for bit.
* Path replay carries the SH state (ray_tpu's ``jax.checkpoint`` of the
  bounce keeps it in the scan carry): with ``remat=True`` the loss
  sum(shl1²) and its gradients equal the stored-residual ones (the policy
  gate of tests/test_torch_grad.py: rtol 1e-5, atol 1e-7).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import test_torch_scene  # noqa: F401  (one torch thread)
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell
from test_torch_render import _check

W, H = 1920, 1080
SETTINGS = dict(max_total_depth=5, min_total_depth=2, output_sh=True)


def _tile(scene, cam, x0, y0, tw, th, **settings):
    return render_tile(scene, cam, None, x0, y0, 1, 0, width=W, height=H,
                       tile_w=tw, tile_h=th, settings=PassSettings(**settings),
                       use_filter_table=False)


def test_shl1_tile_matches_ray_tpu():
    jsc, jcam = j_cornell()
    tsc, tcam = t_cornell()
    x0, y0 = 928, 516
    ref = j_render(jsc.finalize(), jcam, None, jnp.int32(x0), jnp.int32(y0),
                   jnp.uint32(1), jnp.uint32(0), width=W, height=H,
                   tile_w=16, tile_h=16, settings=JPass(**SETTINGS),
                   use_filter_table=False)
    out = _tile(tsc.finalize(device="cpu"), tcam, x0, y0, 16, 16, **SETTINGS)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    assert out["shl1"].shape == ref["shl1"].shape == (256, 4, 3)
    ok = np.isclose(out["shl1"], ref["shl1"], rtol=1e-3,
                    atol=1e-4).all(axis=(1, 2))
    assert ok.mean() >= 0.99, ok.mean()
    assert np.abs(ref["shl1"][:, 1:]).max() > 0.0
    _check({k: v for k, v in out.items() if k != "shl1"},
           {k: v for k, v in ref.items() if k != "shl1"})

    # tests/test_passes_tonemap.py:106-121 on the port's tile
    sh, color = out["shl1"], out["color"]
    np.testing.assert_allclose(sh[:, 0, :], color * 0.282095, rtol=1e-4,
                               atol=1e-5)
    l0 = np.abs(sh[:, 0, :])
    l1 = np.abs(sh[:, 1:, :]).max(axis=1)
    assert (l1 <= l0 * (0.488603 / 0.282095) + 1e-5).all()


def test_compaction_is_off_with_output_sh():
    sc, cam = t_cornell()
    scene = sc.finalize(device="cpu")
    plain = _tile(scene, cam, 900, 500, 32, 32, **SETTINGS)
    compact = _tile(scene, cam, 900, 500, 32, 32, compact_after=1,
                    compact_factor=4, **SETTINGS)
    for k in plain:
        assert torch.equal(plain[k], compact[k]), k


def _sh_loss_grads(scene, cam, **settings):
    params = {k: v.clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    sc = dataclasses.replace(scene, materials={**scene.materials, **params})
    out = _tile(sc, cam, 952, 116, 16, 16, **settings)
    loss = (out["shl1"] ** 2).sum()
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in params.items()}


def test_remat_replays_the_sh_state():
    sc, cam = t_cornell()
    scene = sc.finalize(device="cpu")
    s_loss, s_g = _sh_loss_grads(scene, cam, **SETTINGS)
    for policy in (dict(remat=True), dict(remat=True, remat_save_trace=False)):
        r_loss, r_g = _sh_loss_grads(scene, cam, **policy, **SETTINGS)
        assert r_loss == s_loss > 0.0
        for k, g in s_g.items():
            if g is None:
                assert r_g[k] is None, k
                continue
            np.testing.assert_allclose(r_g[k].numpy(), g.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert float(s_g["base_color"].abs().max()) > 0.0
