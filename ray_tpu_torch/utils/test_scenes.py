"""Canonical test scenes: the port of ``ray_tpu.utils.test_scenes``'s
Cornell box, the scene of the flagship frame."""

from __future__ import annotations

from ray_tpu_torch.scene.camera import make_camera
from ray_tpu_torch.scene.lights import LightDesc, LightType
from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
from ray_tpu_torch.scene.scene import Scene
from ray_tpu_torch.utils.geometry import make_box, make_quad


def cornell_scene(
    light_kind: str = "emissive_quad",
    box_material: MaterialDesc | None = None,
    light_power: float = 20.0,
):
    """Cornell-style box: white back/floor/ceiling, red left, green right,
    a diffuse tall box, and a configurable light source.  Returns
    (Scene, Camera); only ``emissive_quad`` and ``env`` render in this port
    so far — the analytic light kinds build but raise at render time."""
    sc = Scene()
    white = sc.add_material(MaterialDesc(type=ShadingNode.DIFFUSE, base_color=(0.73, 0.73, 0.73), roughness=0.0))
    red = sc.add_material(MaterialDesc(type=ShadingNode.DIFFUSE, base_color=(0.65, 0.05, 0.05), roughness=0.0))
    green = sc.add_material(MaterialDesc(type=ShadingNode.DIFFUSE, base_color=(0.12, 0.45, 0.15), roughness=0.0))
    if box_material is None:
        box_material = MaterialDesc(type=ShadingNode.DIFFUSE, base_color=(0.73, 0.73, 0.73), roughness=0.0)
    boxmat = sc.add_material(box_material)

    s = 1.0  # half size
    # floor (+Y normal), ceiling (-Y), back (+Z->-Z), left, right
    for center, u, v, m in [
        ((0, -s, 0), (s, 0, 0), (0, 0, s), white),     # floor
        ((0, +s, 0), (s, 0, 0), (0, 0, -s), white),    # ceiling
        ((0, 0, +s), (s, 0, 0), (0, -s, 0), white),    # back wall (faces -z)
        ((-s, 0, 0), (0, 0, s), (0, -s, 0), red),      # left wall faces +x
        ((+s, 0, 0), (0, 0, -s), (0, -s, 0), green),   # right wall faces -x
    ]:
        verts, idx, uvs = make_quad(center, u, v)
        sc.add_mesh(verts, idx, uvs=uvs, material=m)

    bv, bidx, bn = make_box(center=(-0.3, -0.65, 0.3), size=(0.6, 0.7, 0.6))
    sc.add_mesh(bv, bidx, normals=bn, material=boxmat)

    if light_kind == "emissive_quad":
        emis = sc.add_material(
            MaterialDesc(
                type=ShadingNode.EMISSIVE,
                base_color=(1.0, 1.0, 1.0),
                strength=light_power,
                importance_sample=True,
            )
        )
        # wound so the emitting face (cross(u, v)) points down into the box
        lv, lidx, luv = make_quad((0, s - 0.001, 0), (0.25, 0, 0), (0, 0, 0.25))
        sc.add_mesh(lv, lidx, uvs=luv, material=emis)
    elif light_kind == "rect":
        sc.add_light(
            LightDesc(
                type=LightType.RECT,
                color=(light_power, light_power, light_power),
                position=(0, s - 0.001, 0),
                axis_u=(1.0, 0.0, 0.0),
                axis_v=(0.0, 0.0, 1.0),
                width=0.5,
                height=0.5,
            )
        )
    elif light_kind == "sphere":
        sc.add_light(
            LightDesc(
                type=LightType.SPHERE,
                color=(light_power, light_power, light_power),
                position=(0, 0.6, 0),
                radius=0.12,
            )
        )
    elif light_kind == "dir":
        sc.add_light(
            LightDesc(
                type=LightType.DIR,
                color=(light_power * 25.0,) * 3,
                direction=(0.2, -1.0, 1.6),  # shines in through the open front
                angle=4.0,
            )
        )
    elif light_kind == "env":
        sc.set_environment((0.5, 0.6, 0.7))
    else:
        raise ValueError(light_kind)

    cam = make_camera(origin=(0, 0, -2.9), look_at=(0, 0, 0), fov=45.0)
    return sc, cam
