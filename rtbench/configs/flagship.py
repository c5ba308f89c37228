"""The flagship scene: ``ray_tpu``'s simplified Cornell box (one tall
block, an emissive quad light), the flagship of its ``bench.py``.

A frozen copy of ``cornell_scene("emissive_quad")`` from
``ray_tpu_torch/utils/test_scenes.py`` (lines 40-122 as of the port's
first benchmark), with the other light kinds left out.  ``scene(api)``
builds it through a package's scene API (``Scene``, ``MaterialDesc``,
``ShadingNode``, ``make_camera``): the port's for the program, the
reference's own for the reference, so both get the same inputs."""

from __future__ import annotations

from rtbench.ref.utils.geometry import make_box, make_quad


def scene(api, light_power: float = 20.0):
    """(Scene, Camera): white back/floor/ceiling, red left, green right, a
    diffuse tall box and an emissive quad under the ceiling."""
    sc = api.Scene()
    diffuse = api.ShadingNode.DIFFUSE
    white = sc.add_material(api.MaterialDesc(type=diffuse, base_color=(0.73, 0.73, 0.73), roughness=0.0))
    red = sc.add_material(api.MaterialDesc(type=diffuse, base_color=(0.65, 0.05, 0.05), roughness=0.0))
    green = sc.add_material(api.MaterialDesc(type=diffuse, base_color=(0.12, 0.45, 0.15), roughness=0.0))
    boxmat = sc.add_material(api.MaterialDesc(type=diffuse, base_color=(0.73, 0.73, 0.73), roughness=0.0))

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

    emis = sc.add_material(api.MaterialDesc(
        type=api.ShadingNode.EMISSIVE, base_color=(1.0, 1.0, 1.0),
        strength=light_power, importance_sample=True))
    # wound so the emitting face (cross(u, v)) points down into the box
    lv, lidx, luv = make_quad((0, s - 0.001, 0), (0.25, 0, 0), (0, 0, 0.25))
    sc.add_mesh(lv, lidx, uvs=luv, material=emis)

    cam = api.make_camera(origin=(0, 0, -2.9), look_at=(0, 0, 0), fov=45.0)
    return sc, cam
