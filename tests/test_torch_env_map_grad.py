"""The bench loss's gradients under a latlong environment map against
``jax.grad`` on the CPU.

w.r.t. ``env_col`` (which scales the map) and every float material column,
on a 16x16 tile at depth 3 (tests/test_torch_grad.py's settings and
gates: rtol 1e-3, atol 1e-3 of the column's largest entry), on the
flagship Cornell box with its light quad off, lit only by
``env_map_image`` through its open front (``cornell_env_map``): the
environment reaches the tile by importance-sampled NEE and by BSDF rays
weighted by the map's MIS pdf.  Not ``env_map`` itself: its PRINCIPLED
ball makes ``jax.grad``'s compile take over a minute and ray_tpu's
anisotropic column NaN.
"""

import types

import numpy as np

from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.utils import test_scenes as ts
from test_torch_grad import _assert_matches_jax, _jax_grads, _port_grads


def cornell_env_map(api):
    """The flagship Cornell box, its light quad off, lit by
    :func:`~ray_tpu_torch.utils.test_scenes.env_map_image` through the
    open front.  Returns (Scene, Camera)."""
    sc, cam = api.cornell_scene("emissive_quad", light_power=0.0)
    tex = sc.add_texture(ts.env_map_image(), srgb=False, generate_mips=False)
    sc.set_environment((1.0, 1.0, 1.0), map_id=tex, rotation=0.7)
    return sc, cam


def test_env_map_gradients_match_jax():
    """On the floor and the tall box near the open front (depth 3, 16x16:
    tests/test_torch_grad.py's tile settings)."""
    (jsc, jcam), (tsc, tcam) = (cornell_env_map(api) for api in (
        types.SimpleNamespace(cornell_scene=j_cornell), ts.port_api()))
    x0, y0 = 800, 900
    j_loss, j_g = _jax_grads(jsc.finalize(), jcam, x0, y0)
    t_loss, t_g = _port_grads(tsc.finalize(device="cpu"), tcam, x0, y0)
    assert j_loss > 0.0
    _assert_matches_jax(t_loss, t_g, j_loss, j_g)
    for k in ("base_color", "env_col"):
        assert np.abs(j_g[k]).max() > 0.0, k
