"""ray_tpu_torch.render_tile against ray_tpu.render_tile on the CPU.

A 64x48 tile of the 1920x1080 flagship frame (Cornell box, emissive-quad
lights, hierarchical NEE, depth 5, 1 spp) at the same tile origin,
iteration and seed.  The RNG is bit-exact and the scene tables are
identical, so both follow the same paths — except that the hit floats and
the transcendentals differ by a few ulps between XLA's CPU code and
PyTorch's (tests/test_torch_traverse.py, tests/test_torch_shading.py).
Such a difference can rarely flip a Russian-roulette or lobe decision and
send one pixel down another path; the bounds below are per-pixel fractions
for that reason: ``base_color`` and ``depth_normal`` within rtol 1e-5 on
≥ 99.9% of pixels, ``color`` within rtol 1e-3 / atol 1e-4 on ≥ 99%, the
tile mean within 1e-3 relative and ``rays_traced`` within 0.5%.

The ``cornell_sphere`` tile (248 triangles: ray_tpu walks its BVH2 on the
CPU, the port ``trace_bvh_plain``) is held to the same bounds, and so is a
1 spp 32x24 tile of each scene of ray_tpu's CPU goldens
(``tests/cpu_golden_scenes.py``: rect and disk lights; sphere, spot and
line lights; a directional light and a constant environment over 2,210
triangles, the port's 8-wide walk; an emissive triangle and a REFRACTIVE
box) at the goldens' pass settings, each scene built by each package's
own builder (``ray_tpu_torch.utils.test_scenes.GOLDEN_SCENES``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.integrator import render_tile as j_render
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.render.integrator import PassSettings, render_tile
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell
from ray_tpu_torch.utils.test_scenes import GOLDEN_SCENES
from test_torch_scene import cornell_sphere

W, H = 1920, 1080


def _render_both(light_kind, x0, y0, tw, th, iteration, seed, **settings):
    if light_kind == "sphere_rings8":
        (jsc, jcam), (tsc, tcam) = (cornell_sphere(port, rings=8)
                                    for port in (False, True))
    elif light_kind in GOLDEN_SCENES:
        from cpu_golden_scenes import SCENES

        (jsc, jcam), (tsc, tcam) = (SCENES[light_kind](),
                                    GOLDEN_SCENES[light_kind]())
    else:
        (jsc, jcam), (tsc, tcam) = j_cornell(light_kind), t_cornell(light_kind)
    ref = j_render(
        jsc.finalize(), jcam, None, jnp.int32(x0), jnp.int32(y0),
        jnp.uint32(iteration), jnp.uint32(seed), width=W, height=H,
        tile_w=tw, tile_h=th, settings=JPass(**settings),
        use_filter_table=False)
    out = render_tile(
        tsc.finalize(device="cpu"), tcam, None, x0, y0, iteration, seed,
        width=W, height=H, tile_w=tw, tile_h=th,
        settings=PassSettings(**settings), use_filter_table=False)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    return out, ref


def _check(out, ref):
    assert out["color"].shape == ref["color"].shape
    assert np.isfinite(out["color"]).all()
    for key in ("base_color", "depth_normal"):
        ok = np.isclose(out[key], ref[key], rtol=1e-5, atol=1e-6).all(-1)
        assert ok.mean() >= 0.999, (key, ok.mean())
    ok = np.isclose(out["color"], ref["color"], rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    m_out, m_ref = out["color"].mean(), ref["color"].mean()
    assert abs(m_out - m_ref) <= 1e-3 * abs(m_ref), (m_out, m_ref)
    r_out, r_ref = int(out["rays_traced"]), int(ref["rays_traced"])
    assert abs(r_out - r_ref) <= 0.005 * r_ref, (r_out, r_ref)


def test_flagship_tile_matches_ray_tpu():
    out, ref = _render_both("emissive_quad", 928, 516, 64, 48, 1, 0,
                            max_total_depth=5, min_total_depth=2)
    assert ref["color"].mean() > 0.0
    _check(out, ref)


def test_cornell_sphere_tile_matches_ray_tpu():
    """A 64x48 tile across the sphere's edge, the wall behind it and the
    floor: BVH2 traces, the rough (Oren-Nayar) sphere material."""
    out, ref = _render_both("sphere_rings8", 900, 840, 64, 48, 1, 0,
                            max_total_depth=5, min_total_depth=2)
    assert ref["color"].mean() > 0.0
    on_sphere = np.isclose(ref["base_color"][:, 2], 0.8).mean()
    assert 0.2 < on_sphere < 0.8, on_sphere
    _check(out, ref)


@pytest.mark.parametrize("light_kind,settings", [
    # the floor under the light quad; a clamp on indirect light
    ("emissive_quad", dict(max_total_depth=3, clamp_indirect=0.5,
                           nan_check=True)),
    # constant environment: one ENV light, CDF picking, env MIS on miss
    ("env", dict(max_total_depth=3, no_background=True)),
    # the CPU goldens' scenes at their pass settings
    *((name, dict(max_total_depth=5, min_total_depth=3))
      for name in sorted(GOLDEN_SCENES)),
])
def test_variant_tiles_match_ray_tpu(light_kind, settings):
    out, ref = _render_both(light_kind, 960, 700, 32, 24, 2, 7, **settings)
    assert ref["color"].mean() > 0.0
    _check(out, ref)
    if settings.get("nan_check"):
        assert int(out["nonfinite"]) == int(ref["nonfinite"]) == 0
