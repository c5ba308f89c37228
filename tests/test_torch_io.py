"""The port's image and scene files against ray_tpu's, on the CPU.

``write_tga`` / ``write_pfm`` of the same image (numpy in ray_tpu; numpy
and a tensor in the port) write byte-equal files; ``read_tga`` reads a
hand-made RLE (type 10) file and a bottom-up one as ray_tpu does, and both
readers give back what was written.  A scene saved by either package's
``save_scene`` loads in the other's ``load_scene`` with every table equal,
bit for bit, and every static field equal; the port's load lands on the
device it is given (``device="cpu"`` here).
"""

import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.scene.scene import SceneFlat as JSceneFlat
from ray_tpu.utils import image_io as jio
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.scene.materials import MaterialDesc as TMaterialDesc
from ray_tpu_torch.scene.materials import ShadingNode as TN
from ray_tpu_torch.utils import image_io as tio
from ray_tpu_torch.utils.test_scenes import alpha_box
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell

import test_torch_scene  # noqa: F401  (one intra-op thread)

_STATIC = [f.name for f in dataclasses.fields(JSceneFlat)
           if f.metadata.get("static")]


def _images():
    r = np.random.RandomState(0)
    return {
        "rgb_float": r.uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32),
        "rgba_u8": r.randint(0, 256, (4, 6, 4)).astype(np.uint8),
        "gray_float": r.rand(3, 5).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_tga_bytes_equal_ray_tpus(tmp_path, name):
    img = _images()[name]
    jio.write_tga(str(tmp_path / "j.tga"), img)
    tio.write_tga(str(tmp_path / "t.tga"), img)
    tio.write_tga(str(tmp_path / "tt.tga"), torch.from_numpy(img))
    ref = (tmp_path / "j.tga").read_bytes()
    assert (tmp_path / "t.tga").read_bytes() == ref
    assert (tmp_path / "tt.tga").read_bytes() == ref
    back = tio.read_tga(str(tmp_path / "t.tga"))
    np.testing.assert_array_equal(back, jio.read_tga(str(tmp_path / "j.tga")))
    if img.dtype == np.uint8:
        np.testing.assert_array_equal(back, img)


def test_read_tga_rle_and_bottom_up(tmp_path):
    """A type-10 file of run and raw packets, 24 and 32 bits, both
    origins."""
    r = np.random.RandomState(1)
    for bpp, desc in ((24, 0x20), (32, 0x00), (32, 0x20)):
        c = bpp // 8
        w, h = 9, 4
        px = r.randint(0, 256, (w * h, c)).astype(np.uint8)
        px[3:9] = px[3]            # a run of 6
        px[20:36] = px[20]         # a run of 16
        body = bytearray()
        i = 0
        while i < w * h:
            run = 1
            while i + run < w * h and run < 128 and (px[i + run] == px[i]).all():
                run += 1
            if run > 1:
                body += bytes([0x80 | (run - 1)]) + px[i].tobytes()
                i += run
            else:
                j = i
                while j < w * h and j - i < 128 and not (
                        j + 1 < w * h and (px[j + 1] == px[j]).all()):
                    j += 1
                n = max(j - i, 1)
                body += bytes([n - 1]) + px[i:i + n].tobytes()
                i += n
        hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h,
                          bpp, desc)
        path = tmp_path / f"rle{bpp}_{desc}.tga"
        path.write_bytes(hdr + bytes(body))
        got = tio.read_tga(str(path))
        np.testing.assert_array_equal(got, jio.read_tga(str(path)))
        want = px.reshape(h, w, c)[..., [2, 1, 0] + ([3] if c == 4 else [])]
        if not desc & 0x20:
            want = want[::-1]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(5, 7, 3), (6, 4)])
def test_pfm_bytes_equal_ray_tpus(tmp_path, shape):
    img = np.random.RandomState(2).normal(size=shape).astype(np.float32)
    jio.write_pfm(str(tmp_path / "j.pfm"), img)
    tio.write_pfm(str(tmp_path / "t.pfm"), torch.from_numpy(img))
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(tio.read_pfm(str(tmp_path / "t.pfm")), img)
    np.testing.assert_array_equal(jio.read_pfm(str(tmp_path / "t.pfm")), img)


def _np_tree(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_same_scene(a, b):
    """Every field of two scenes (either package) equal, bit for bit."""
    for name in _STATIC:
        assert getattr(a, name) == getattr(b, name), name
    for f in dataclasses.fields(JSceneFlat):
        if f.name in _STATIC:
            continue
        x, y = _np_tree(getattr(a, f.name)), _np_tree(getattr(b, f.name))
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif isinstance(x, dict):
            assert set(x) == set(y), (f.name, set(x) ^ set(y))
            for k in x:
                assert x[k].dtype == y[k].dtype, (f.name, k)
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{f.name}.{k}")
        else:
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("scene_name", ["flagship", "alpha_box"])
def test_scene_files_cross_load(tmp_path, scene_name):
    """ray_tpu's file loads in the port and the port's in ray_tpu; each
    equals the scene its own package finalizes."""
    from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
    from ray_tpu.scene.materials import ShadingNode as JN

    if scene_name == "flagship":
        (jsc, _), (tsc, _) = j_cornell(), t_cornell()
    else:
        jsc, _ = j_cornell("rect", box_material=JMaterialDesc(
            type=JN.PRINCIPLED, base_color=(0.8, 0.6, 0.2), roughness=0.3,
            alpha=0.5))
        tsc, _ = alpha_box()
    js, ts = jsc.finalize(), tsc.finalize(device="cpu")
    _assert_same_scene(ts, js)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    ray_tpu.save_scene(jpath, js)
    ray_tpu_torch.save_scene(tpath, ts)
    from_j = ray_tpu_torch.load_scene(jpath, device="cpu")
    assert from_j.device.type == "cpu"
    _assert_same_scene(from_j, ts)
    from_t = ray_tpu.load_scene(tpath)
    _assert_same_scene(from_t, js)
    assert isinstance(from_t.materials["base_color"], jnp.ndarray)
    _assert_same_scene(ray_tpu_torch.load_scene(tpath, device="cpu"), ts)


def test_loaded_scene_renders(tmp_path):
    """A scene read back by the port renders the tile its source renders,
    bit for bit."""
    from ray_tpu_torch.render.integrator import PassSettings, render_tile

    sc, cam = t_cornell(box_material=TMaterialDesc(
        type=TN.GLOSSY, base_color=(0.9, 0.9, 0.9), roughness=0.2))
    scene = sc.finalize(device="cpu")
    path = str(tmp_path / "s.npz")
    ray_tpu_torch.save_scene(path, scene)
    outs = [render_tile(s, cam, None, 0, 0, 1, 0, width=64, height=48,
                        tile_w=16, tile_h=12, settings=PassSettings(),
                        use_filter_table=False)
            for s in (scene, ray_tpu_torch.load_scene(path, device="cpu"))]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
