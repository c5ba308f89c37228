"""The physical sky's gradients against ``jax.grad`` on the CPU.

The gradient of the mean bake w.r.t. ``atmosphere_density`` (16x8, the
atmosphere only: tests/test_sky.py:70's setting) and of the clouds' mean
in-scatter w.r.t. ``clouds_density`` (128 directions, 6 steps, 2 light
steps: tests/test_sky_extras.py:131's), each a 0-dim tensor with
``requires_grad`` in :class:`AtmosphereParams`, within 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_scene  # noqa: F401  (one torch thread)
from ray_tpu.render import sky as J
from ray_tpu_torch.render import sky as T

SUN_COL = (20.0, 20.0, 20.0)


def test_bake_gradient_of_atmosphere_density():
    def j_mean(density):
        p = J.AtmosphereParams(atmosphere_density=density).jnp_params()
        return jnp.mean(J.bake_sky_env(p, (0.0, 0.8, 0.6), SUN_COL, width=16,
                                       height=8, include_sun_disk=False))

    g_ref = float(jax.grad(j_mean)(jnp.float32(1.0)))
    density = torch.tensor(1.0, requires_grad=True)
    img = T.bake_sky_env(T.AtmosphereParams(atmosphere_density=density),
                         (0.0, 0.8, 0.6), SUN_COL, width=16, height=8,
                         include_sun_disk=False, device="cpu")
    img.mean().backward()
    g = float(density.grad)
    assert g != 0.0 and np.isfinite(g)
    assert abs(g - g_ref) <= 1e-4 * abs(g_ref), (g, g_ref)


def test_clouds_gradient_of_density():
    r = np.random.default_rng(5)
    d = r.normal(size=(128, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 1] = np.abs(d[:, 1])
    d = d.astype(np.float32)
    sun = np.array([0.3, 0.8, 0.2])
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)
    jp = J.AtmosphereParams().jnp_params()
    jl = J.build_transmittance_lut(jp)

    def j_mean(density):
        pp = dataclasses.replace(jp, clouds_density=density)
        L, _ = J.clouds_march(pp, jl, jnp.asarray(d), jnp.asarray(sun),
                              jnp.asarray(SUN_COL, jnp.float32), steps=6,
                              light_steps=2)
        return jnp.mean(L)

    g_ref = float(jax.grad(j_mean)(jnp.float32(0.5)))
    density = torch.tensor(0.5, requires_grad=True)
    tp = T.AtmosphereParams(clouds_density=density).torch_params(device="cpu")
    L, _ = T.clouds_march(tp, torch.from_numpy(np.array(jl)),
                          torch.from_numpy(d), torch.from_numpy(sun),
                          torch.tensor(SUN_COL), steps=6, light_steps=2)
    L.mean().backward()
    g = float(density.grad)
    assert g != 0.0 and np.isfinite(g)
    assert abs(g - g_ref) <= 1e-4 * abs(g_ref), (g, g_ref)
