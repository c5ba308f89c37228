"""Tiles of scenes with per-ray-type visibility against ray_tpu on the
CPU: ``cornell_vis`` (the flagship and three boxes, each hidden from one
ray type: the masked BVH2 walk in flatten mode, the binary two-level walk
with ray masks in tlas mode) and ``sphere_vis`` (``cornell_sphere`` with
a camera-invisible sphere: the masked 8-wide walk, and ``trace_tlas``
with ray masks), in both modes, against ray_tpu's ``render_tile`` within
tests/test_torch_render.py's bounds.  (The walks themselves:
tests/test_torch_visibility.py; tests/test_instancing.py's visibility
scenes: tests/test_torch_visibility_instancing.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.utils import test_scenes as ts
from test_torch_render import _check
from test_torch_visibility import J_API, SETTINGS, T_API, H, W


def _tiles(build, mode, x0, y0, tw, th, **settings):
    (jsc, jcam), (tsc, tcam) = build(J_API), build(T_API)
    st = {**SETTINGS, **settings}
    ref = j_render(
        jsc.finalize(instancing=mode), jcam, None, jnp.int32(x0),
        jnp.int32(y0), jnp.uint32(1), jnp.uint32(0), width=W, height=H,
        tile_w=tw, tile_h=th, settings=JPass(**st), use_filter_table=False)
    out = render_tile(
        tsc.finalize(device="cpu", instancing=mode), tcam, None, x0, y0, 1,
        0, width=W, height=H, tile_w=tw, tile_h=th,
        settings=PassSettings(**st), use_filter_table=False)
    return ({k: v.numpy() for k, v in out.items()},
            {k: np.asarray(v) for k, v in ref.items()})


# tiles: cornell_vis's across the floating camera-invisible box, its
# shadow and the shadow-invisible box; sphere_vis's across the hidden
# sphere's shadow on the floor
TILES = {"cornell_vis": (1040, 560), "sphere_vis": (1080, 880)}


@pytest.mark.parametrize("mode", ["flatten", "tlas"])
@pytest.mark.parametrize("name", sorted(TILES))
def test_masked_tiles_match_ray_tpu(name, mode):
    out, ref = _tiles(getattr(ts, name), mode, *TILES[name], 24, 24)
    assert ref["color"].mean() > 0.0
    _check(out, ref)
