"""The user's entry point on the CPU: view transforms, ``Renderer`` and
``create_renderer``, against ``ray_tpu``.

* All ten view transforms, through their LUTs and through the analytic
  curves (``use_lut=False``), with and without exposure and gamma, on a
  seeded HDR array holding 0 and values up to 1e30: within atol 1e-6 of
  ``ray_tpu.render.tonemap``, except the analytic AgX and filmic curves
  (``ANALYTIC_ATOL``).
* ``Renderer`` against ``ray_tpu``'s on the flagship at 32x24, 4 samples,
  depth 3, adaptive sampling on (min 2 samples): radiance, ``pixels(AGX)``
  and ``variance_image`` with tests/test_torch_render.py's color bounds
  (rtol 1e-3 / atol 1e-4 on ≥ 99% of pixels, the mean within 1e-3), the
  AUX buffers with its AUX bounds (rtol 1e-5 / atol 1e-6 on ≥ 99.9%), and
  the per-pixel sample counts and active mask equal on ≥ 99% of pixels (a
  pixel whose path flips on an ulp, as the color bound allows, changes its
  variance).
* ``save_state`` / ``load_state`` round-trips; ``create_renderer()``
  raises without a card and takes the CPU only when the caller names it;
  the README quickstart runs through ``import ray_tpu_torch as ray_tpu``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.render import tonemap as jtm
from ray_tpu.render.integrator import PassSettings as JPass
from ray_tpu.render.renderer import Renderer as JRenderer
from ray_tpu.render.renderer import RenderSettings as JSettings
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.api import RendererType, create_renderer
from ray_tpu_torch.render import tonemap as ttm
from ray_tpu_torch.render.integrator import PassSettings
from ray_tpu_torch.render.renderer import Renderer, RenderSettings
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell
import test_torch_scene  # noqa: F401  (one intra-op thread)

VIEW = sorted(v for k, v in vars(ttm.ViewTransform).items()
              if not k.startswith("_"))


def _hdr(seed=0):
    """(4096, 3) linear radiance over 40 stops, exact zeros, a black row,
    and values up to 1e30."""
    r = np.random.RandomState(seed)
    c = np.exp2(r.uniform(-20.0, 20.0, (4096, 3))).astype(np.float32)
    c[r.rand(4096, 3) < 0.05] = 0.0
    c[7] = 0.0
    c[11] = (1e30, 2e20, 5e10)
    c[13] = 1e30
    return c


# The bound of the analytic AgX and filmic curves (the LUTs and the
# standard transform keep 1e-6: measured 1.8e-7).  Both curves start from
# log2, whose last ulp differs between the packages on 30% of inputs
# (XLA's CPU log2 is log · 1/ln 2, and its log is not PyTorch's on 2% of
# inputs), and both amplify it: AgX's sigmoid polynomial sums float32
# terms of up to ~25 that cancel to below 1 (its own rounding noise is
# ~2e-6, an ulp of 25), AgX punchy raises that to the power 1.35 and
# saturates by 1.4, and the filmic S-curve's power of strength < 1 is steep
# near black.  Measured max |diff| over six seeded arrays: 9.6e-6 (AgX),
# 1.8e-5 (AgX punchy), 1.0e-5 (filmic, very low contrast).
ANALYTIC_ATOL = 5e-5


@pytest.mark.parametrize("use_lut", [True, False], ids=["lut", "analytic"])
@pytest.mark.parametrize("view", VIEW)
def test_view_transform_matches_ray_tpu(view, use_lut):
    c = _hdr(view)
    curve = view != ttm.ViewTransform.STANDARD and not use_lut
    atol = ANALYTIC_ATOL if curve else 1e-6
    for exposure, gamma in ((0.0, 1.0), (0.75, 2.2), (-1.5, 0.8)):
        ref = np.asarray(jtm.apply_view_transform(
            jnp.asarray(c), view, exposure, gamma, use_lut=use_lut))
        out = ttm.apply_view_transform(torch.from_numpy(c), view, exposure,
                                       gamma, use_lut=use_lut)
        assert out.dtype == torch.float32 and out.shape == c.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol,
                                   err_msg=f"exposure {exposure} gamma {gamma}")
    # both ends of the range are reached
    assert float(out.min()) < 1e-3 and float(out.max()) > 0.9


def test_lut_data_and_reversible_tonemap():
    """The port reads its own copy of the LUTs, byte for byte
    ``ray_tpu``'s, and raises when it is missing and a LUT is asked for."""
    ref = ttm.LUT_PATH.parent.parent.parent / "ray_tpu" / "data" / \
        "tonemap_luts.npz"
    assert ttm.LUT_PATH.read_bytes() == ref.read_bytes()
    c = _hdr(3)
    np.testing.assert_allclose(
        ttm.reversible_tonemap(torch.from_numpy(c)).numpy(),
        np.asarray(jtm.reversible_tonemap(jnp.asarray(c))), rtol=1e-6)
    x = np.random.RandomState(4).rand(256, 3).astype(np.float32) * 0.9
    np.testing.assert_allclose(
        ttm.reversible_tonemap_invert(torch.from_numpy(x)).numpy(),
        np.asarray(jtm.reversible_tonemap_invert(jnp.asarray(x))), rtol=1e-6)


def test_missing_lut_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(ttm, "LUT_PATH", tmp_path / "missing.npz")
    ttm._load_lut.cache_clear()
    try:
        c = torch.ones(4, 3)
        with pytest.raises(FileNotFoundError):
            ttm.apply_view_transform(c, ttm.ViewTransform.AGX)
        # no LUT is read for the analytic curves or the standard transform
        ttm.apply_view_transform(c, ttm.ViewTransform.AGX, use_lut=False)
        ttm.apply_view_transform(c, ttm.ViewTransform.STANDARD)
    finally:
        ttm._load_lut.cache_clear()


# ---------------------------------------------------------------------------
# Renderer
# ---------------------------------------------------------------------------

SMALL = dict(width=32, height=24, min_samples=2, variance_threshold=0.02)
DEPTH = dict(max_total_depth=3, min_total_depth=2)
SAMPLES = 4


@pytest.fixture(scope="module")
def renderers():
    jsc, jcam = j_cornell()
    tsc, tcam = t_cornell()
    jr = JRenderer(JSettings(**SMALL), JPass(**DEPTH))
    jr.render(jsc.finalize(), jcam, SAMPLES)
    tr = Renderer(RenderSettings(**SMALL), PassSettings(**DEPTH), device="cpu")
    tr.render(tsc.finalize(device="cpu"), tcam, SAMPLES)
    return jr, tr, jcam, tcam


def _frac_close(a, b, rtol, atol):
    a, b = np.asarray(a).reshape(-1, a.shape[-1]), np.asarray(b).reshape(
        -1, b.shape[-1])
    return np.isclose(a, b, rtol=rtol, atol=atol).all(-1).mean()


def test_renderer_matches_ray_tpu(renderers):
    jr, tr, jcam, tcam = renderers
    assert tr.iteration == jr.iteration == SAMPLES
    rad = tr.radiance_image()
    assert rad.shape == (24, 32, 3) and rad.device.type == "cpu"
    ref = np.asarray(jr.radiance_image())
    assert np.isfinite(rad.numpy()).all() and ref.mean() > 0.0
    assert _frac_close(rad.numpy(), ref, 1e-3, 1e-4) >= 0.99
    assert abs(rad.numpy().mean() - ref.mean()) <= 1e-3 * ref.mean()
    assert _frac_close(tr.pixels(tcam, ttm.ViewTransform.AGX).numpy(),
                       jr.pixels(jcam, jtm.ViewTransform.AGX), 1e-3,
                       1e-4) >= 0.99
    assert _frac_close(tr.variance_image().numpy(), jr.variance_image(),
                       1e-3, 1e-4) >= 0.99
    for k in ("aux_base", "aux_dn"):
        assert _frac_close(getattr(tr, k).numpy(), getattr(jr, k), 1e-5,
                           1e-6) >= 0.999, k


def test_renderer_adaptive_sampling_matches_ray_tpu(renderers):
    jr, tr, _, _ = renderers
    counts, j_counts = tr.sample_counts.numpy(), np.asarray(jr.sample_counts)
    active, j_active = tr.active_px.numpy(), np.asarray(jr.active_px)
    # adaptive sampling stopped some pixels and kept others
    assert 0.0 < j_active.mean() < 1.0 and counts.min() < SAMPLES
    assert (counts == j_counts).mean() >= 0.99
    assert (active == j_active).mean() >= 0.99


def test_save_and_load_state_round_trip(tmp_path):
    """A renderer restored from ``save_state`` continues exactly as the one
    that saved it; wrong shapes and a saved cache raise."""
    sc, cam = t_cornell()
    scene = sc.finalize(device="cpu")
    settings = RenderSettings(width=8, height=6, min_samples=1,
                              variance_threshold=0.05)
    a = Renderer(settings, PassSettings(max_total_depth=2), device="cpu")
    a.render(scene, cam, 2)
    path = tmp_path / "state.npz"
    a.save_state(str(path))
    b = Renderer(settings, PassSettings(max_total_depth=2), device="cpu")
    b.load_state(str(path))
    assert b.iteration == 2
    for r in (a, b):
        r.render(scene, cam, 1)
    for k in Renderer._STATE_KEYS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    wrong = Renderer(dataclasses.replace(settings, width=4), device="cpu")
    with pytest.raises(ValueError):
        wrong.load_state(str(path))
    data = dict(np.load(path))
    data["cache_key_lo"] = np.zeros(4, np.uint32)
    np.savez(tmp_path / "cached.npz", **data)
    with pytest.raises(NotImplementedError, match="item 24"):
        b.load_state(str(tmp_path / "cached.npz"))


def test_unported_renderer_parts_raise():
    sc, cam = t_cornell()
    scene = sc.finalize(device="cpu")
    r = Renderer(RenderSettings(width=4, height=4), device="cpu")
    with pytest.raises(NotImplementedError, match="item 24"):
        r.update_spatial_cache(scene, cam)
    with pytest.raises(NotImplementedError, match="item 24"):
        r.resolve_spatial_cache()
    with pytest.raises(NotImplementedError, match="item 26"):
        r.denoise_image("nlm")
    with pytest.raises(NotImplementedError, match="item 27"):
        r.denoise_image("unet")
    cached = Renderer(RenderSettings(width=4, height=4,
                                     use_spatial_cache=True), device="cpu")
    with pytest.raises(NotImplementedError, match="item 24"):
        cached.render(scene, cam, 1)
    # a scene on another device than the renderer's
    other = Renderer(RenderSettings(width=4, height=4), device="meta")
    with pytest.raises(ValueError, match="renderer"):
        other.render(scene, cam, 1)


def test_create_renderer_takes_the_cpu_only_when_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: create_renderer() uses it")
    with pytest.raises(RuntimeError, match="no renderer backend"):
        create_renderer()
    with pytest.raises(RuntimeError, match="no renderer backend"):
        create_renderer(enabled_types=(RendererType.TPU, RendererType.GPU))
    with pytest.raises(RuntimeError, match="no renderer backend"):
        create_renderer(preferred_device="H100")
    for kw in (dict(enabled_types=("cpu",)), dict(enabled_types=("ref",)),
               dict(preferred_device="cpu"),
               dict(enabled_types=("gpu", "cpu"))):
        r = create_renderer(RenderSettings(width=4, height=4), **kw)
        assert r.device == torch.device("cpu"), kw
    assert [d.platform for d in ray_tpu_torch.query_available_devices()] \
        == ["cpu"]
    assert ray_tpu_torch.match_device_names("NVIDIA H100 80GB HBM3", "h100")
    assert ray_tpu_torch.version() == ray_tpu_torch.__version__


def test_readme_quickstart_runs_on_the_port():
    """The README quickstart through ``import ray_tpu_torch as ray_tpu``
    (2 triangles with a GLOSSY material, a sphere light), at 32x32 and 4
    samples, with the CPU named."""
    import ray_tpu_torch as ray_tpu

    sc = ray_tpu.Scene()
    mat = sc.add_material(ray_tpu.MaterialDesc(type=1,
                                               base_color=(.7, .7, .7)))
    sc.add_mesh(vertices=[[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
                indices=[[0, 1, 2], [0, 2, 3]], material=mat)
    sc.add_light(ray_tpu.LightDesc(type=0, position=(0, 3, 0), radius=.3,
                                   color=(20, 20, 20)))
    scene = sc.finalize(device="cpu")
    cam = ray_tpu.make_camera(origin=(0, 2, 6), look_at=(0, 0, 0), fov=50)
    r = ray_tpu.create_renderer(ray_tpu.RenderSettings(width=32, height=32),
                                enabled_types=("cpu",))
    img = r.render(scene, cam, samples=4)
    pixels = r.pixels(cam, ray_tpu.ViewTransform.AGX)
    assert img.shape == pixels.shape == (32, 32, 3)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    assert bool(((pixels >= 0) & (pixels <= 1)).all())
    assert set(ray_tpu.__all__) >= {"create_renderer", "Renderer",
                                    "ViewTransform", "PassSettings"}
