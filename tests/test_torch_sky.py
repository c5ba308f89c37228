"""The physical sky's model against ray_tpu.render.sky on the CPU.

* The noise hash: ``_hash_u32`` and ``_lattice`` on seeded int32
  coordinates, negative ones and the int32 extremes included, bit-exact
  (ray_tpu's uint32 words are int64 words in [0, 2^32) here).
* ``value_noise3`` / ``fbm3`` within 1e-6.
* The transmittance LUT (64x256x3, 40 steps): every texel's optical
  depth tau = -log T within 1e-5 relative + 2e-7 (float32's resolution
  of T near 1), the worst row printed (measured: 2.7e-7 relative).  The
  port rounds every ``sqrt`` of the sky correctly, as XLA does:
  PyTorch's vectorised CPU ``sqrt`` is an ulp off on ~1% of inputs, and
  at r ≈ 6.37e6 m an ulp of a height (0.5 m) moves the Mie density
  exp(-h / 1200 m) by 4e-4.
* The multiscatter LUT (64 Fibonacci directions, a batch dimension here,
  ``jax.vmap`` in ray_tpu) on ray_tpu's transmittance LUT, by band of the
  sun's height: the columns with the sun above the horizon within 1e-5
  relative (measured: 1.7e-6).  The columns with the sun below it hold
  values at most 2e-2 of the table's largest, whose relative gaps reach
  8e-3 where the values are smallest; they are held to 1e-6 of the
  largest entry (measured: 1.4e-7).
* ``sky_radiance`` (with and without the sun's disk), ``moon_radiance``,
  ``stars_radiance`` and ``cirrus_coverage`` on 512 seeded directions,
  all given ray_tpu's LUTs: within 1e-5 relative + 1e-7 of the largest
  value, the worst band of view elevation printed (measured: 2.7e-6
  for ``sky_radiance``).
* ``clouds_march``: against ray_tpu run op by op (``jax.disable_jit``),
  transmittance and in-scatter within 1e-5 (measured: 1.0e-7 and
  6.3e-7).  Against ray_tpu as it runs, its ``lax.fori_loop`` body is
  compiled as one XLA computation, which moves the sample positions by
  ulps (ray_tpu against its own op-by-op run: 1.9e-5 and 1.7e-4): the
  directions that see no cloud exactly equal, the cloudy ones within
  5e-5 in transmittance and 5e-4 in in-scatter.

The bakes and the gradients: tests/test_torch_sky_bake.py;
``Scene.set_physical_sky`` and a tile: tests/test_torch_sky_scene.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_scene  # noqa: F401  (one torch thread)
from ray_tpu.render import sky as J
from ray_tpu_torch.render import sky as T

SUN = np.array([0.6, 0.3, 0.2], np.float32) / np.float32(
    np.linalg.norm([0.6, 0.3, 0.2]))
SUN_COL = np.array([20.0, 20.0, 20.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _dirs(n, seed, up_only=False):
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if up_only:
        d[:, 1] = np.abs(d[:, 1])
    return d.astype(np.float32)


@pytest.fixture(scope="module")
def luts():
    """(ray_tpu's params, the port's, ray_tpu's LUTs, the port's LUTs)."""
    jp = J.AtmosphereParams().jnp_params()
    tp = T.AtmosphereParams().torch_params(device="cpu")
    jl = J.build_transmittance_lut(jp)
    jm = J.build_multiscatter_lut(jp, jl)
    tl = T.build_transmittance_lut(tp)
    tm = T.build_multiscatter_lut(tp, _t(jl))
    return jp, tp, jl, jm, tl, tm


def test_hash_and_lattice_bit_exact():
    r = np.random.default_rng(3)
    c = r.integers(-2**31, 2**31, size=(3, 4096), dtype=np.int64).astype(
        np.int32)
    c[:, :6] = [[-1, 0, 2**31 - 1, -2**31, -7, 5]] * 3
    a = np.asarray(J._hash_u32(jnp.asarray(c[0])))
    b = T._hash_u32(_t(c[0])).numpy()
    assert b.dtype == np.int64 and (b >= 0).all() and (b < 2**32).all()
    np.testing.assert_array_equal(b, a.astype(np.int64))
    for seed in (0, 17, 101, 307):
        a = np.asarray(J._lattice(*(jnp.asarray(x) for x in c), seed))
        b = T._lattice(*(_t(x) for x in c), seed).numpy()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32))


def test_value_noise_and_fbm():
    r = np.random.default_rng(4)
    pos = r.uniform(-300.0, 300.0, (4096, 3)).astype(np.float32)
    np.testing.assert_allclose(
        T.value_noise3(_t(pos), 7).numpy(),
        np.asarray(J.value_noise3(jnp.asarray(pos), 7)), rtol=0, atol=1e-6)
    for octaves, seed in ((4, 7), (5, 53)):
        np.testing.assert_allclose(
            T.fbm3(_t(pos), octaves=octaves, seed=seed).numpy(),
            np.asarray(J.fbm3(jnp.asarray(pos), octaves=octaves, seed=seed)),
            rtol=0, atol=1e-6)


def test_transmittance_lut(luts):
    _, _, jl, _, tl, _ = luts
    assert tuple(tl.shape) == (64, 256, 3) and tl.dtype == torch.float32
    tau_ref = -np.log(np.asarray(jl, np.float64))
    tau = -np.log(tl.numpy().astype(np.float64))
    rel = np.maximum(np.abs(tau - tau_ref) - 2e-7, 0.0) / tau_ref
    row = rel.max(axis=(1, 2))
    print("worst row", int(row.argmax()), float(row.max()))
    assert (row <= 1e-5).all(), row


def test_multiscatter_lut(luts):
    _, _, _, jm, _, tm = luts
    jm = np.asarray(jm, np.float64)
    tm = tm.numpy().astype(np.float64)
    assert tuple(tm.shape) == (32, 32, 3)
    # columns: the sun's cosine (u * 2 - 1 at texel centres)
    sun_up = (np.arange(32) + 0.5) / 32 * 2.0 - 1.0 > 0.0
    rel = np.abs(tm - jm)[:, sun_up] / jm[:, sun_up]
    print("sun up: worst", float(rel.max()))
    assert (rel <= 1e-5).all(), rel.max(axis=(0, 2))
    below = np.abs(tm - jm)[:, ~sun_up] / jm.max()
    print("sun down: worst of the largest", float(below.max()))
    assert (below <= 1e-6).all(), below.max(axis=(0, 2))


def _close(out, ref, rtol, atol_frac=1e-7, mu=None):
    """``out`` within ``rtol`` of ``ref`` + ``atol_frac`` of its largest
    value; with ``mu`` (the directions' elevation), the worst of eight
    bands of it printed."""
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape and np.isfinite(out).all()
    atol = atol_frac * max(np.abs(ref).max(), 1e-30)
    if mu is not None:
        err = (np.abs(out - ref) / (np.abs(ref) + atol)).reshape(
            len(mu), -1).max(axis=1)
        band = np.minimum(((mu + 1.0) * 4.0).astype(int), 7)
        worst = {b: float(err[band == b].max()) for b in np.unique(band)}
        print("worst by band of mu (8 bands over [-1, 1]):", worst)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("disk", [False, True])
def test_sky_radiance(luts, disk):
    jp, tp, jl, jm, _, _ = luts
    d = _dirs(512, 1)
    # two directions inside the sun's disk
    d[:2] = SUN
    ref = J.sky_radiance(jp, jl, jm, jnp.asarray(d), jnp.asarray(SUN),
                         jnp.asarray(SUN_COL), steps=8, include_sun_disk=disk)
    out = T.sky_radiance(tp, _t(jl), _t(jm), _t(d), _t(SUN), _t(SUN_COL),
                         steps=8, include_sun_disk=disk)
    _close(out, ref, 1e-5, mu=d[:, 1])
    if disk:
        assert float(out[:2].min()) > 1e3  # the disk's radiance


def test_moon_stars_cirrus(luts):
    _, tp, _, _, _, _ = luts
    moon = (0.0, 0.5, 0.8)
    jp = J.AtmosphereParams(moon_dir=moon).jnp_params()
    tp = T.AtmosphereParams(moon_dir=moon).torch_params(device="cpu")
    d = _dirs(512, 2)
    # directions across the moon's disk
    m = np.asarray(moon, np.float32) / np.float32(np.linalg.norm(moon))
    d[:64] = m + 0.01 * np.random.default_rng(6).normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = np.array([0.2, -0.5, 0.1], np.float32)
    sun /= np.linalg.norm(sun)
    jrad, jin = J.moon_radiance(jp, jnp.asarray(d), jnp.asarray(sun))
    trad, tin = T.moon_radiance(tp, _t(d), _t(sun))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    assert 0 < int(tin.sum()) < 512
    _close(trad, jrad, 1e-5)
    _close(T.stars_radiance(tp, _t(d)), J.stars_radiance(jp, jnp.asarray(d)),
           1e-5)
    r0 = np.full(512, 6371000.0 + 700.0, np.float32)
    _close(T.cirrus_coverage(tp, _t(d), _t(r0)),
           J.cirrus_coverage(jp, jnp.asarray(d), jnp.asarray(r0)), 1e-5)


def test_clouds_march(luts):
    jp, tp, jl, _, _, _ = luts
    d = _dirs(512, 5, up_only=True)
    sun = np.array([0.3, 0.8, 0.2], np.float32)
    sun /= np.linalg.norm(sun)
    args = (jnp.asarray(d), jnp.asarray(sun), jnp.asarray(SUN_COL))
    jL, jT = J.clouds_march(jp, jl, *args, steps=4, light_steps=2)
    with jax.disable_jit():
        eL, eT = J.clouds_march(jp, jl, *args, steps=4, light_steps=2)
    tL, tT = T.clouds_march(tp, _t(jl), _t(d), _t(sun), _t(SUN_COL),
                            steps=4, light_steps=2)
    assert float(tT.min()) < 0.9  # some directions see cloud
    # ray_tpu op by op
    _close(tT, eT, 1e-5)
    _close(tL, eL, 1e-5)
    # ray_tpu as it runs: the cloud-free directions exact
    clear = np.asarray(jT) == 1.0
    assert 0 < clear.sum() < 512
    np.testing.assert_array_equal(tT.numpy()[clear], np.asarray(jT)[clear])
    np.testing.assert_array_equal(tL.numpy()[clear], np.asarray(jL)[clear])
    _close(tT, jT, 5e-5)
    _close(tL, jL, 5e-4)
