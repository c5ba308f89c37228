"""The bench loss's gradient through transparency against JAX, on the CPU.

The bench loss (``bench.py``: ``sum(color²) / (H·W·3)``) of a 16x16 tile
of the alpha box at depth 3 (``tests/test_torch_grad.py``'s settings),
differentiated with respect to every float material column and
``env_col``, with stored residuals and with path replay (remat).

``ray_tpu`` cannot take this gradient in reverse mode: its transparency
marches are ``lax.while_loop`` loops, which ``jax.grad`` refuses ("Reverse-mode
differentiation does not work for lax.while_loop").  Forward mode goes
through them, so the reference gradient is ``jax.jvp`` of ``ray_tpu``'s loss
along every basis vector of those columns (153 scalars), batched with
``jax.vmap`` into one compiled call: the full gradient, entry by entry.
Each column of the port's gradient is held to it at
``tests/test_torch_grad.py``'s tolerance, ``rtol=1e-3,
atol=1e-3·max|g_jax|``.  The Transparent node's color (row 4, reached
only through the shadow march's ``shadow_transmittance``, in both
packages) and the principled root's color must get a non-zero gradient.
Remat and stored residuals agree at ``tests/test_grad.py``'s policy gate
(rtol 1e-5, atol 1e-7), the loss bit for bit.

The scene is ``tests/test_torch_transparency.py``'s lifted alpha box: its
box 2 mm off the floor, where every pixel of the two packages agrees (on
the box standing on the floor, a ray from inside it meets the box bottom
and the floor at one t, and the last ulp of the ray picks one).
"""

import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu_torch.render.integrator import PassSettings, render_tile

import test_torch_scene  # noqa: F401  (one intra-op thread)
from test_torch_transparency import alpha_scene

W, H, RES = 1920, 1080, 16
X0, Y0 = 1040, 760
DEPTH = dict(max_total_depth=3, min_total_depth=3)
LIFT = 0.002
ROOT_MAT, TRANSP_MAT = 3, 4   # the box's principled root and Transparent leaf


@pytest.fixture(scope="module")
def reference():
    """ray_tpu's loss and its gradient in every float column and env_col,
    one forward-mode product per scalar."""
    sc, cam = alpha_scene(False, LIFT)
    scene = sc.finalize()
    mat_f = {k: v for k, v in scene.materials.items()
             if jnp.issubdtype(v.dtype, jnp.floating)}

    def loss_fn(mats, env):
        merged = dict(scene.materials)
        merged.update(mats)
        s = dataclasses.replace(scene, materials=merged, env_col=env)
        out = j_render(s, cam, None, jnp.int32(X0), jnp.int32(Y0),
                       jnp.uint32(1), jnp.uint32(0), width=W, height=H,
                       tile_w=RES, tile_h=RES, settings=JPass(**DEPTH),
                       use_filter_table=False)
        return jnp.sum(out["color"] ** 2) / (H * W * 3)

    flat, unravel = jax.flatten_util.ravel_pytree((mat_f, scene.env_col))

    def along(t):
        return jax.jvp(lambda x: loss_fn(*unravel(x)), (flat,), (t,))

    loss, dloss = jax.jit(jax.vmap(along))(
        jnp.eye(flat.shape[0], dtype=flat.dtype))
    mats, env = unravel(dloss)
    return (float(loss[0]), {k: np.asarray(g) for k, g in mats.items()},
            np.asarray(env))


def _port_grads(**settings):
    sc, cam = alpha_scene(True, LIFT)
    scene = sc.finalize(device="cpu")
    params = {k: v.clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    env = scene.env_col.clone().requires_grad_(True)
    merged = dict(scene.materials)
    merged.update(params)
    s = dataclasses.replace(scene, materials=merged, env_col=env)
    out = render_tile(s, cam, None, X0, Y0, 1, 0, width=W, height=H,
                      tile_w=RES, tile_h=RES,
                      settings=PassSettings(**DEPTH, **settings),
                      use_filter_table=False)
    loss = (out["color"] ** 2).sum() / (H * W * 3)
    loss.backward()
    grads = {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                 else p.grad.numpy()) for k, p in params.items()}
    return float(loss.detach()), grads, env.grad.numpy()


@pytest.fixture(scope="module")
def stored():
    return _port_grads()


def _assert_column_matches(gt, gj, name):
    assert np.isfinite(gt).all(), name
    scale = float(np.abs(gj).max())
    np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=1e-3 * scale,
                               err_msg=name)


@pytest.mark.parametrize("policy", ["stored", "remat"])
def test_transparency_gradient_matches_jax_jvp(reference, stored, policy):
    j_loss, j_grads, j_env = reference
    if policy == "stored":
        t_loss, grads, env_grad = stored
    else:
        t_loss, grads, env_grad = _port_grads(remat=True)
        assert t_loss == stored[0]
        for k, g in stored[1].items():
            np.testing.assert_allclose(grads[k], g, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        np.testing.assert_allclose(env_grad, stored[2], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    assert set(grads) == set(j_grads)
    for k, gj in j_grads.items():
        _assert_column_matches(grads[k], gj, k)
    _assert_column_matches(env_grad, j_env, "env_col")
    # the shadow march carries the Transparent color's gradient
    assert np.abs(grads["base_color"][TRANSP_MAT]).max() > 0.0
    assert np.abs(grads["base_color"][ROOT_MAT]).max() > 0.0
