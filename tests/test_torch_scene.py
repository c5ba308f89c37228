"""ray_tpu_torch's scene compile against ray_tpu's: bit for bit.

The port's ``Scene.finalize(device="cpu")`` of the Cornell scenes (flatten
mode) and of instanced scenes (tlas mode, with ``wrows_tlas``) must give
every table and static field of ``ray_tpu``'s ``SceneFlat``, textures
must pack into ``ray_tpu``'s texel table, and ``SceneFlat.from_numpy``
must carry a finalized ``ray_tpu`` scene across unchanged — the traversal
slice's scenes too (tlas without ``wrows_tlas``, visibility masks, an
environment map).  (The colonnade's tables: tests/test_torch_tlas.py.)
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ray_tpu.scene.materials import MaterialDesc as JMaterialDesc
from ray_tpu.scene.materials import ShadingNode as JShadingNode
from ray_tpu.scene.scene import SceneFlat as JSceneFlat
from ray_tpu.utils.geometry import make_uv_sphere as j_sphere
from ray_tpu.utils.test_scenes import cornell_scene as j_cornell
from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
from ray_tpu_torch.scene.scene import SceneFlat
from ray_tpu_torch.utils.geometry import make_uv_sphere as t_sphere
from ray_tpu_torch.utils.test_scenes import cornell_scene as t_cornell
from ray_tpu_torch.utils.test_scenes import instanced_scene
from test_traverse_tlas_pallas import _instanced_scene

# One intra-op thread for the port's CPU tests (this module and those that
# import it): their tensors are small, and the suite runs several test
# processes at once, whose idle threads would spin on each other's cores.
torch.set_num_threads(1)

_STATIC = [f.name for f in dataclasses.fields(JSceneFlat)
           if f.metadata.get("static")]
_ARRAYS = [f.name for f in dataclasses.fields(JSceneFlat)
           if not f.metadata.get("static")]


def cornell_sphere(port: bool, rings: int = 12):
    """The ``cornell_sphere`` configuration from the public API of either
    package: the flagship Cornell box plus a rough diffuse UV sphere
    (rings=12: 376 triangles, 8-wide rows built; rings=8: 248, none)."""
    cornell, sphere = (t_cornell, t_sphere) if port else (j_cornell, j_sphere)
    desc, node = ((MaterialDesc, ShadingNode) if port
                  else (JMaterialDesc, JShadingNode))
    sc, cam = cornell("emissive_quad")
    m = sc.add_material(desc(type=node.DIFFUSE, base_color=(0.2, 0.3, 0.8),
                             roughness=0.5))
    v, idx, n, uv = sphere(center=(0.4, -0.64, -0.3), radius=0.35,
                           rings=rings, segments=16)
    sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)
    return sc, cam


def _np_tree(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_same(a, b, where):
    """Same structure, dtypes, shapes and bytes."""
    if a is None or b is None:
        assert a is None and b is None, where
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
        return
    assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
    assert a.shape == b.shape, (where, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), where


def _assert_scene_equal(port, ref):
    for name in _ARRAYS:
        _assert_same(_np_tree(getattr(port, name)),
                     _np_tree(jax.tree_util.tree_map(np.asarray, getattr(ref, name))),
                     name)
    for name in _STATIC:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("light_kind", ["emissive_quad", "env", "rect", "sphere"])
def test_finalize_matches_ray_tpu(light_kind):
    jsc, _ = j_cornell(light_kind)
    tsc, _ = t_cornell(light_kind)
    ref = jsc.finalize()
    port = tsc.finalize(device="cpu")
    assert port.device == torch.device("cpu")
    _assert_scene_equal(port, ref)


@pytest.mark.parametrize("rings", [12, 8])
def test_cornell_sphere_finalize_matches_ray_tpu(rings):
    """Past 256 triangles both packages add the 8-wide row table
    (``bvh_soa["wrows"]``); every table, that one included, is equal."""
    ref = cornell_sphere(False, rings)[0].finalize()
    port = cornell_sphere(True, rings)[0].finalize(device="cpu")
    _assert_scene_equal(port, ref)
    n_nodes = port.bvh_soa["code0"].shape[0]
    if rings == 12:
        assert (port.num_tris, n_nodes, port.stack_size) == (376, 59, 11)
        assert port.bvh_soa["wrows"].shape[1] == 88  # 11 x max_leaf 8
    else:
        assert (port.num_tris, n_nodes) == (248, 38)
        assert "wrows" not in port.bvh_soa
    assert port.mat_types == (0, 3) and port.max_leaf == 8


def test_flagship_scene_shape():
    """The numbers the flagship's routing rests on: ≤ 40 triangles sends
    every trace to the brute-force kernel; DIFFUSE + EMISSIVE only."""
    sc, _ = t_cornell()
    s = sc.finalize(device="cpu")
    assert s.num_tris == 24 and s.bvh_soa["code0"].shape[0] == 4
    assert (s.max_leaf, s.stack_size, s.light_tree_depth) == (8, 7, 1)
    assert s.mat_types == (0, 3) and s.env_light_index == -1
    assert [k[0] for k in s.light_kinds] == [5, 5]
    assert not (s.has_mix or s.has_textures or s.has_normal_maps
                or s.has_transparency or s.has_visibility)


def test_from_numpy_round_trip():
    jsc, _ = j_cornell()
    ref = jsc.finalize()
    arrays = {n: jax.tree_util.tree_map(np.asarray, getattr(ref, n))
              for n in _ARRAYS}
    static = {n: getattr(ref, n) for n in _STATIC}
    port = SceneFlat.from_numpy(arrays, static, device="cpu")
    _assert_scene_equal(port, ref)
    # the differentiated tables come across as float32 tensors, unchanged
    assert port.materials["base_color"].dtype == torch.float32
    assert port.env_col.dtype == torch.float32


def test_from_numpy_rejects_unknown_fields():
    with pytest.raises(ValueError):
        SceneFlat.from_numpy({"not_a_field": np.zeros(1)}, {}, device="cpu")


def test_unported_finalize_paths_raise():
    sc, _ = t_cornell()
    # compressed textures (item 16), environment maps (item 31) and the
    # HLBVH builder (item 15) raised here until they were ported; the SBVH
    # builder (item 18) still raises
    assert sc.add_texture(np.zeros((4, 4, 3), np.float32), compress=True) == 0
    assert sc.finalize(device="cpu", fast_build=True).num_tris == 24
    with pytest.raises(NotImplementedError, match="item 18"):
        sc.finalize(device="cpu", spatial_splits=True)
    sc.set_environment((1, 1, 1),
                       map_id=sc.add_texture(np.ones((4, 8, 3), np.float32),
                                             compress="rgbe"))
    # the two-level finalize of ≤ 256 unique triangles carries no
    # wrows_tlas: its traces take the binary walk
    # (tests/test_torch_tlas_binary.py)
    sc.add_instance(0)
    sc.add_instance(0)
    scene = sc.finalize(device="cpu", instancing="tlas")
    assert scene.mode == "tlas" and "wrows_tlas" not in scene.bvh_soa
    assert (scene.env_tab_h, scene.env_tab_w) == (4, 8)
    assert {"blocks_t", "rgbe_t"} <= set(scene.textures)


@pytest.mark.parametrize("n_inst", [2, 6, 64])
def test_instanced_finalize_matches_ray_tpu(n_inst):
    """Tlas mode: the binary code space, ``wrows_tlas``/``winst_base``, the
    instance columns and the object-space ``tri_surf``, all equal."""
    ref = _instanced_scene(n_inst)
    port = instanced_scene(n_inst=n_inst).finalize(device="cpu")
    _assert_scene_equal(port, ref)
    assert port.mode == "tlas" and port.max_leaf == 4
    assert port.bvh_soa["wrows_tlas"].shape[1] == 56
    assert port.inst["vis"].shape[0] == n_inst


def test_tlas_from_numpy_round_trip():
    ref = _instanced_scene(6)
    arrays = {n: jax.tree_util.tree_map(np.asarray, getattr(ref, n))
              for n in _ARRAYS}
    static = {n: getattr(ref, n) for n in _STATIC}
    port = SceneFlat.from_numpy(arrays, static, device="cpu")
    _assert_scene_equal(port, ref)
    assert port.bvh_soa["wrows_tlas"].dtype == torch.float32


@pytest.mark.parametrize("name,mode", [
    ("cornell_tlas", "tlas"), ("cornell_vis", "flatten"),
    ("cornell_vis", "tlas"), ("sphere_vis", "flatten"), ("sphere_vis", "tlas"),
    ("env_map", None)])
def test_slice_scenes_match_ray_tpu_and_carry_across(name, mode):
    """The traversal slice's scenes — a tlas scene without ``wrows_tlas``,
    per-triangle ``tri_vis`` and ``has_visibility``, the environment map's
    importance tables — finalize to ray_tpu's every table, and
    ``SceneFlat.from_numpy`` carries ray_tpu's scene across unchanged."""
    import types

    from cpu_golden_scenes import SCENES
    from ray_tpu.scene.lights import LightDesc, LightType
    from ray_tpu_torch.utils import test_scenes

    japi = types.SimpleNamespace(
        cornell_scene=j_cornell, scene_dir_env=SCENES["dir_env"],
        MaterialDesc=JMaterialDesc, ShadingNode=JShadingNode,
        LightDesc=LightDesc, LightType=LightType)
    kw = {} if mode is None else {"instancing": mode}
    build = getattr(test_scenes, name)
    ref = build(japi)[0].finalize(**kw)
    _assert_scene_equal(build()[0].finalize(device="cpu", **kw), ref)
    arrays = {n: jax.tree_util.tree_map(np.asarray, getattr(ref, n))
              for n in _ARRAYS}
    static = {n: getattr(ref, n) for n in _STATIC}
    _assert_scene_equal(SceneFlat.from_numpy(arrays, static, device="cpu"),
                        ref)


@pytest.mark.parametrize("shape,dtype,srgb,mips", [
    ((16, 8, 3), np.float32, False, True),
    ((5, 7, 4), np.float32, True, True),   # odd sizes, sRGB → linear
    ((12, 12), np.uint8, False, True),     # one channel, bytes
    ((9, 6, 2), np.float32, False, False),
])
def test_texture_packing_matches_ray_tpu(shape, dtype, srgb, mips):
    """Mip chains (2x2 box filter, odd edges), sRGB linearisation, channel
    padding and the record table: ray_tpu's ``TexturePacker`` bit for
    bit."""
    from ray_tpu.scene.textures import TexturePacker as JPacker
    from ray_tpu_torch.scene.textures import TexturePacker as TPacker

    r = np.random.RandomState(sum(shape))
    imgs = [(r.rand(*shape) * (255 if dtype == np.uint8 else 1)).astype(dtype)
            for _ in range(2)]
    jp, tp = JPacker(), TPacker()
    for img in imgs:
        assert jp.add(img, srgb=srgb, generate_mips=mips) == tp.add(
            img, srgb=srgb, generate_mips=mips)
    _assert_same(tp.pack(), jp.pack(), "textures")
