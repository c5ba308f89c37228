"""The colonnade: the procedural stand-in for the reference's Sponza /
Bistro showcase scenes.

A frozen copy of ``colonnade_scene()`` from
``ray_tpu_torch/utils/test_scenes.py`` (lines 243-331 as of the port's
first benchmark), at its defaults.  ``scene(api)`` builds it through a
package's scene API (``Scene``, ``MaterialDesc``, ``ShadingNode``,
``LightDesc``, ``LightType``, ``make_camera``): the port's for the
program, the reference's own for the reference."""

from __future__ import annotations

import numpy as np

from rtbench.ref.utils.geometry import make_quad, make_uv_sphere


def scene(api, n_cols: int = 8, sphere_detail: int = 32, n_lights: int = 12,
          tex_res: int = 256, seed: int = 7):
    """(Scene, Camera): 64 column instances of one 3,968-triangle mesh, 16
    instances of a 4,418-triangle terrain tile and a floor quad (324,642
    instanced triangles over 8,388 unique), a procedural 256x256 texture on
    the stone and floor materials (all PRINCIPLED), 12 sphere lights and a
    constant environment."""
    r = np.random.RandomState(seed)
    sc = api.Scene()
    principled = api.ShadingNode.PRINCIPLED

    # procedural checker/marble texture (floor + columns)
    yy, xx = np.meshgrid(np.arange(tex_res), np.arange(tex_res), indexing="ij")
    checker = (((xx // 16) + (yy // 16)) % 2).astype(np.float32)
    marble = 0.5 + 0.5 * np.sin(0.11 * xx + 4.0 * np.sin(0.07 * yy))
    tex = np.stack([0.25 + 0.55 * checker,
                    0.25 + 0.45 * marble,
                    0.35 + 0.35 * checker * marble], axis=-1).astype(np.float32)
    tex_id = sc.add_texture(tex, srgb=False)

    stone = sc.add_material(api.MaterialDesc(
        type=principled, base_color=(0.75, 0.72, 0.68),
        base_texture=tex_id, roughness=0.55, specular=0.3))
    floor_m = sc.add_material(api.MaterialDesc(
        type=principled, base_color=(0.5, 0.5, 0.55),
        base_texture=tex_id, roughness=0.25, specular=0.5))
    gold = sc.add_material(api.MaterialDesc(
        type=principled, base_color=(0.9, 0.7, 0.3),
        metallic=1.0, roughness=0.3))

    # column: dense capsule-ish sphere stack (unique mesh, instanced)
    v, idx, n, uv = make_uv_sphere(radius=0.5, rings=sphere_detail,
                                   segments=2 * sphere_detail)
    v = v * np.array([1.0, 3.0, 1.0], np.float32)  # stretch into a column
    column = sc.add_mesh(v, idx, uvs=uv, material=stone)

    # dense displaced terrain tile (raw triangle mass)
    g = 48
    gy, gx = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g),
                         indexing="ij")
    h = 0.15 * np.sin(9.0 * gx) * np.cos(7.0 * gy) + 0.05 * r.rand(g, g)
    tv = np.stack([gx * 4 - 2, h, gy * 4 - 2], axis=-1).reshape(-1, 3)
    quads = []
    for j in range(g - 1):
        for i in range(g - 1):
            a = j * g + i
            quads += [[a, a + 1, a + g], [a + 1, a + g + 1, a + g]]
    terrain = sc.add_mesh(tv.astype(np.float32), np.asarray(quads, np.int32),
                          uvs=np.stack([gx, gy], -1).reshape(-1, 2),
                          material=gold)

    fv, fidx, fuv = make_quad((0, 0, 0), (24, 0, 0), (0, 0, 24))
    floor = sc.add_mesh(fv, fidx, uvs=fuv, material=floor_m)

    def translate(t):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = t
        return m

    for j in range(n_cols):
        for i in range(n_cols):
            x = (i - (n_cols - 1) / 2) * 3.0
            z = (j - (n_cols - 1) / 2) * 3.0
            sc.add_instance(column, translate((x, 1.5, z)))
    for j in range(4):
        for i in range(4):
            sc.add_instance(
                terrain, translate(((i - 1.5) * 4.2, 0.02, (j - 1.5) * 4.2)))
    sc.add_instance(floor)

    for k in range(n_lights):
        sc.add_light(api.LightDesc(
            type=api.LightType.SPHERE,
            color=tuple(6.0 + 8.0 * r.rand(3)),
            position=((r.rand() - 0.5) * 20.0, 2.5 + 2.0 * r.rand(),
                      (r.rand() - 0.5) * 20.0),
            radius=0.15,
        ))
    sc.set_environment((0.12, 0.14, 0.18))
    cam = api.make_camera(origin=(9.0, 4.0, 9.5), look_at=(0.0, 1.0, 0.0),
                          fov=55.0)
    return sc, cam
