"""tests/test_instancing.py's per-ray-type visibility scenes against
ray_tpu on the CPU: the camera-invisible sphere (960 triangles: the
masked 8-wide walk in flatten mode, ``trace_tlas`` with ray masks in tlas
mode) and the shadow-invisible blocker (4 triangles: the masked BVH2 walk,
the binary two-level walk), each a 16x16 tile at the frame's centre in
both modes, held to tests/test_torch_render.py's bounds.
"""

import numpy as np
import pytest

from ray_tpu_torch.scene.visibility import visibility_mask
from ray_tpu_torch.utils.geometry import make_quad, make_uv_sphere
from test_torch_render import _check
from test_torch_visibility_tiles import _tiles


def camera_invisible(api, vis):
    """tests/test_instancing.py's camera-invisible occluder: one UV sphere
    instance (960 triangles) in a white environment."""
    v, idx, n, uv = make_uv_sphere(radius=1.0)
    sc = api.Scene()
    m = sc.add_material(api.MaterialDesc(type=api.ShadingNode.DIFFUSE,
                                         base_color=(0.1, 0.9, 0.1)))
    mesh = sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)
    sc.add_instance(mesh, None, visibility=vis)
    sc.set_environment((1.0, 1.0, 1.0))
    return sc, api.make_camera(origin=(0, 0, -4), look_at=(0, 0, 0),
                               fov=40.0)


def shadow_invisible(api, vis):
    """tests/test_instancing.py's shadow-invisible blocker: a floor, a
    camera-invisible blocker quad over it, a small sphere light."""
    floor_v, floor_i, floor_uv = make_quad((0, 0, 0), (2, 0, 0), (0, 0, -2))
    blk_v, blk_i, blk_uv = make_quad((0, 1.0, 0), (0.8, 0, 0), (0, 0, -0.8))
    sc = api.Scene()
    white = sc.add_material(api.MaterialDesc(type=api.ShadingNode.DIFFUSE,
                                             base_color=(0.8, 0.8, 0.8)))
    floor = sc.add_mesh(floor_v, floor_i, uvs=floor_uv, material=white)
    blocker = sc.add_mesh(blk_v, blk_i, uvs=blk_uv, material=white)
    sc.add_instance(floor)
    sc.add_instance(blocker, None, visibility=vis)
    sc.add_light(api.LightDesc(type=api.LightType.SPHERE,
                               color=(40, 40, 40), position=(0, 2.0, 0),
                               radius=0.05, visible=False))
    return sc, api.make_camera(origin=(0, 2.5, -3.5), look_at=(0, 0, 0),
                               fov=40.0)


INSTANCING = {
    "camera_invisible": (camera_invisible, visibility_mask(camera=False)),
    "shadow_invisible": (shadow_invisible,
                         visibility_mask(camera=False, shadow=False)),
}


@pytest.mark.parametrize("mode", ["flatten", "tlas"])
@pytest.mark.parametrize("name", sorted(INSTANCING))
def test_instancing_visibility_scenes_match_ray_tpu(name, mode):
    """16x16 at the frame's centre: the hidden sphere leaves the white
    environment; the shadow-invisible blocker leaves the floor lit."""
    build, vis = INSTANCING[name]
    out, ref = _tiles(lambda api: build(api, vis), mode, 952, 532, 16, 16,
                      max_total_depth=2, min_total_depth=2)
    if name == "camera_invisible":
        np.testing.assert_allclose(out["color"], 1.0, atol=1e-4)
    _check(out, ref)


