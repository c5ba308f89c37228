"""The port's backward pass against ``jax.grad`` on the CPU.

The bench loss (``bench.py``: ``sum(color²) / (H·W·3)`` over a tile of the
1920x1080 frame) is differentiated with respect to every float column of
``scene.materials`` and ``env_col``, set as ``bench.py`` sets them: leaf
tensors merged in with ``dataclasses.replace``.  A 16x16 tile at depth 3
(``tests/test_grad.py``'s settings) for the flagship, on the light's lower
edge, and for the 248-triangle ``cornell_sphere``, on the sphere.

Both sides follow the same paths (bit-exact RNG, same hits up to a few
ulps), so the gradients agree to float32 rounding: measured within 1.3e-5
relative to the column's largest entry.  Each column is held to
``rtol=1e-3, atol=1e-3·max|g_jax|``.  Columns that no ported node type
reads get no gradient in the port (``None``) and an all-zero one from JAX.

Path replay (``remat=True``, with ``remat_save_dots`` and without
``remat_save_trace``) is held to the same ``jax.grad`` values, computed
once per scene for the module, and the port's policies to each other at
``tests/test_grad.py::test_grad_checkpoint_policies_agree``'s gate
(rtol 1e-5, atol 1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell
from test_torch_scene import cornell_sphere

W, H, RES = 1920, 1080, 16
DEPTH = dict(max_total_depth=3, min_total_depth=3)


def _jax_grads(scene, cam, x0, y0):
    mat_float = {k: v for k, v in scene.materials.items()
                 if jnp.issubdtype(v.dtype, jnp.floating)}

    def loss_fn(params):
        merged = dict(scene.materials)
        merged.update(params["materials"])
        sc = dataclasses.replace(scene, materials=merged,
                                 env_col=params["env_col"])
        out = j_render(sc, cam, None, jnp.int32(x0), jnp.int32(y0),
                       jnp.uint32(1), jnp.uint32(0), width=W, height=H,
                       tile_w=RES, tile_h=RES, settings=JPass(**DEPTH),
                       use_filter_table=False)
        return jnp.sum(out["color"] ** 2) / (H * W * 3)

    loss, g = jax.value_and_grad(loss_fn)(
        {"materials": mat_float, "env_col": scene.env_col})
    grads = {k: np.asarray(v) for k, v in g["materials"].items()}
    grads["env_col"] = np.asarray(g["env_col"])
    return float(loss), grads


# tile origins: the flagship's light quad's lower edge (emission strength
# gets a gradient), cornell_sphere's sphere (roughness 0.5 drives the
# Oren-Nayar term)
ORIGIN = {"flagship": (952, 116), "cornell_sphere": (740, 860)}
REMAT = {"remat": dict(remat=True),
         "remat_save_dots": dict(remat=True, remat_save_dots=True),
         "remat_no_save_trace": dict(remat=True, remat_save_trace=False)}


@pytest.fixture(scope="module")
def reference():
    """scene name → (ray_tpu's loss and gradients, the port's CPU scene and
    camera, the port's stored-residual loss and gradients), each computed
    once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "flagship":
                (jsc, jcam), (tsc, tcam) = j_cornell(), t_cornell()
            else:
                (jsc, jcam), (tsc, tcam) = (cornell_sphere(port, rings=8)
                                            for port in (False, True))
            scene = tsc.finalize(device="cpu")
            cache[name] = (_jax_grads(jsc.finalize(), jcam, *ORIGIN[name]),
                           scene, tcam,
                           _port_grads(scene, tcam, *ORIGIN[name]))
        return cache[name]
    return get


def _assert_matches_jax(t_loss, t_g, j_loss, j_g):
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    assert set(t_g) == set(j_g)
    for k, gj in j_g.items():
        gt = np.zeros_like(gj) if t_g[k] is None else t_g[k]
        assert np.isfinite(gt).all(), k
        scale = float(np.abs(gj).max())
        np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=k)


def _port_grads(scene, cam, x0, y0, **settings):
    params = {k: v.clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    env = scene.env_col.clone().requires_grad_(True)
    merged = dict(scene.materials)
    merged.update(params)
    sc = dataclasses.replace(scene, materials=merged, env_col=env)
    out = render_tile(sc, cam, None, x0, y0, 1, 0, width=W, height=H,
                      tile_w=RES, tile_h=RES,
                      settings=PassSettings(**DEPTH, **settings),
                      use_filter_table=False)
    loss = (out["color"] ** 2).sum() / (H * W * 3)
    loss.backward()
    params["env_col"] = env
    return float(loss.detach()), {
        k: None if p.grad is None else p.grad.numpy() for k, p in params.items()}


@pytest.mark.parametrize("scene_name,x0,y0,nonzero", [
    ("flagship", 952, 116, ("base_color", "strength", "env_col")),
    ("cornell_sphere", 740, 860, ("base_color", "roughness", "env_col")),
])
def test_bench_loss_gradients_match_jax(reference, scene_name, x0, y0,
                                        nonzero):
    assert (x0, y0) == ORIGIN[scene_name]
    (j_loss, j_g), _, _, (t_loss, t_g) = reference(scene_name)
    assert j_loss > 0.0
    _assert_matches_jax(t_loss, t_g, j_loss, j_g)
    for k in nonzero:
        assert np.abs(j_g[k]).max() > 0.0, k


@pytest.mark.parametrize("policy", sorted(REMAT))
@pytest.mark.parametrize("scene_name", sorted(ORIGIN))
def test_remat_gradients_match_jax(reference, scene_name, policy):
    """Each path-replay policy gives ``jax.grad``'s gradients (ray_tpu
    without remat: its policies agree, tests/test_grad.py) and the port's
    own stored-residual gradients within the policy gate."""
    (j_loss, j_g), scene, cam, (s_loss, s_g) = reference(scene_name)
    t_loss, t_g = _port_grads(scene, cam, *ORIGIN[scene_name],
                              **REMAT[policy])
    _assert_matches_jax(t_loss, t_g, j_loss, j_g)
    assert t_loss == s_loss
    for k, g in s_g.items():
        if g is None:
            assert t_g[k] is None, k
            continue
        np.testing.assert_allclose(t_g[k], g, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_remat_still_raises():
    """``remat=True`` raised here until path replay was ported (ROADMAP
    Queue 1 item 10); now it renders, and without gradients a tile is
    the one ``remat=False`` renders, bit for bit."""
    sc, cam = t_cornell()
    scene = sc.finalize(device="cpu")
    outs = [render_tile(scene, cam, None, 0, 0, 1, 0, width=W, height=H,
                        tile_w=8, tile_h=8,
                        settings=PassSettings(remat=remat),
                        use_filter_table=False) for remat in (False, True)]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
