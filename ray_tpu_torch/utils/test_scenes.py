"""Canonical test scenes: the port of ``ray_tpu.utils.test_scenes``'s
Cornell box (the scene of the flagship frame) and the instanced colonnade
(the big scene: two-level traversal, textures, principled materials,
sphere lights), the instanced generator scene of the traversal tests, the
four scenes of ``ray_tpu``'s committed CPU goldens
(``tests/cpu_golden_scenes.py``: ``GOLDEN_SCENES``), ``alpha_box``, a
Cornell box whose tall box has principled alpha, ``furnace_scene``, the
traversal slice's scenes (``cornell_tlas``, ``cornell_vis``,
``sphere_vis``, ``env_map``) and the sky and texture slice's
(``physical_sky``, ``tex_features``, ``sphere_hlbvh``), which take a
package's scene API (:func:`port_api`, or ``ray_tpu``'s in the tests), so
that one function builds the scene in either package."""

from __future__ import annotations

import types

import numpy as np

from ray_tpu_torch.scene.camera import make_camera
from ray_tpu_torch.scene.lights import LightDesc, LightType
from ray_tpu_torch.scene.materials import MaterialDesc, ShadingNode
from ray_tpu_torch.scene.scene import Scene
from ray_tpu_torch.scene.visibility import visibility_mask
from ray_tpu_torch.utils.geometry import make_box, make_quad, make_uv_sphere


def furnace_scene(material: MaterialDesc, env=(1.0, 1.0, 1.0), radius=1.0):
    """A single sphere in a constant environment — the classic furnace
    test.  For a *convex* diffuse body L_out = albedo × L_env exactly."""
    sc = Scene()
    mat = sc.add_material(material)
    v, idx, n, uv = make_uv_sphere(radius=radius)
    sc.add_mesh(v, idx, normals=n, uvs=uv, material=mat)
    sc.set_environment(env)
    cam = make_camera(origin=(0, 0, -4), look_at=(0, 0, 0), fov=40.0)
    return sc, cam


def cornell_scene(
    light_kind: str = "emissive_quad",
    box_material: MaterialDesc | None = None,
    light_power: float = 20.0,
):
    """Cornell-style box: white back/floor/ceiling, red left, green right,
    a diffuse tall box, and a configurable light source.  Returns
    (Scene, Camera)."""
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
                # directional "sun": color is radiance, so a few-degree
                # disk needs a high value to light the box (solid angle
                # ≈ π·tan²(angle/2))
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


def scene_rect_disk():
    """Cornell shell lit by a rect + a disk light (no emissive quad)."""
    sc = Scene()
    white = sc.add_material(MaterialDesc(
        type=ShadingNode.DIFFUSE, base_color=(0.73, 0.73, 0.73)))
    red = sc.add_material(MaterialDesc(
        type=ShadingNode.DIFFUSE, base_color=(0.65, 0.05, 0.05)))
    s = 1.0
    for center, u, v, m in [
        ((0, -s, 0), (s, 0, 0), (0, 0, s), white),
        ((0, +s, 0), (s, 0, 0), (0, 0, -s), white),
        ((0, 0, +s), (s, 0, 0), (0, -s, 0), white),
        ((-s, 0, 0), (0, 0, s), (0, s, 0), red),
        ((+s, 0, 0), (0, 0, -s), (0, s, 0), white),
    ]:
        cx, cy, cz = center
        ux, uy, uz = u
        vx, vy, vz = v
        verts = [
            [cx - ux - vx, cy - uy - vy, cz - uz - vz],
            [cx + ux - vx, cy + uy - vy, cz + uz - vz],
            [cx + ux + vx, cy + uy + vy, cz + uz + vz],
            [cx - ux + vx, cy - uy + vy, cz - uz + vz],
        ]
        sc.add_mesh(vertices=verts, indices=[[0, 1, 2], [0, 2, 3]],
                    material=m)
    sc.add_light(LightDesc(
        type=LightType.RECT, color=(14.0, 13.0, 12.0),
        position=(-0.3, 0.96, 0.1), axis_u=(1, 0, 0), axis_v=(0, 0, 1),
        width=0.4, height=0.4))
    sc.add_light(LightDesc(
        type=LightType.DISK, color=(30.0, 32.0, 34.0),
        position=(0.5, 0.9, -0.4),
        axis_u=(0.894, 0.447, 0.0), axis_v=(0, 0, 1),
        width=0.3, height=0.3))
    cam = make_camera(origin=(0, 0, -2.8), look_at=(0, 0, 0), fov=50.0)
    return sc, cam


def scene_sphere_spot_line():
    """Cornell shell with a plain sphere light, a spotlight and a line
    light (sphere cone sampling, spot falloff, cylinder sampling)."""
    sc, cam = cornell_scene("sphere")
    sc.add_light(LightDesc(
        type=LightType.SPHERE, color=(25.0, 20.0, 15.0),
        position=(0.5, 0.7, -0.5), radius=0.08,
        direction=(-0.5, -0.81, 0.3), spot_size=40.0,
        spot_blend=0.2 * 0.2))
    sc.add_light(LightDesc(
        type=LightType.LINE, color=(40.0, 45.0, 50.0),
        position=(-0.6, 0.8, 0.0), axis_u=(1, 0, 0), axis_v=(0, 0, 1),
        radius=0.01, height=0.8))
    return sc, cam


def scene_dir_env():
    """Open ground plane + a dir light with angular spread + a constant
    environment (2,210 triangles: the 8-wide walk)."""
    sc = Scene()
    grey = sc.add_material(MaterialDesc(
        type=ShadingNode.DIFFUSE, base_color=(0.6, 0.6, 0.6)))
    ball = sc.add_material(MaterialDesc(
        type=ShadingNode.PRINCIPLED, base_color=(0.7, 0.3, 0.2),
        roughness=0.4))
    sc.add_mesh(vertices=[[-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]],
                indices=[[0, 1, 2], [0, 2, 3]], material=grey)
    v, idx, n, uv = make_uv_sphere(radius=0.5)
    sc.add_mesh(v + [0.0, 0.5, 0.0], idx, normals=n, uvs=uv, material=ball)
    sc.add_light(LightDesc(
        type=LightType.DIR, color=(6.0, 5.5, 5.0),
        direction=(0.45, -0.8, 0.4), angle=8.0))
    sc.set_environment((0.3, 0.45, 0.7))
    cam = make_camera(origin=(0, 1.6, -4.0), look_at=(0, 0.4, 0), fov=40.0)
    return sc, cam


def scene_tri_glass():
    """Emissive-triangle light (MIS vs BSDF hits) + a refractive box."""
    return cornell_scene(
        "emissive_quad",
        box_material=MaterialDesc(
            type=ShadingNode.REFRACTIVE, base_color=(1.0, 1.0, 1.0),
            roughness=0.0, ior=1.45),
    )


def alpha_box(lift: float = 0.0):
    """``cornell_scene("rect")`` whose tall box is a principled material
    with alpha 0.5: Mix(Transparent, principled), which drives both
    transparency marches and the Mix resolution.  At ``lift`` 0 the box's
    bottom face lies in the floor's plane, and a ray leaving a point inside
    the transparent box downward meets both at one t — which one it
    reports rides on the last ulp of the ray."""
    sc, cam = cornell_scene("rect", box_material=MaterialDesc(
        type=ShadingNode.PRINCIPLED, base_color=(0.8, 0.6, 0.2),
        roughness=0.3, alpha=0.5))
    if lift:
        # the tall box is the sixth mesh: its vertices at the lifted centre
        bv, _, _ = make_box(center=(-0.3, -0.65 + lift, 0.3),
                            size=(0.6, 0.7, 0.6))
        sc._meshes[5].vertices = np.asarray(bv, np.float32).reshape(-1, 3)
    return sc, cam


# the goldens' scenes, resolution, sample count and pass settings
# (tests/cpu_golden_scenes.py: PassSettings(max_total_depth=5,
# min_total_depth=3))
GOLDEN_SCENES = {
    "rect_disk": scene_rect_disk,
    "sphere_spot_line": scene_sphere_spot_line,
    "dir_env": scene_dir_env,
    "tri_glass": scene_tri_glass,
}
GOLDEN_RES = 64
GOLDEN_SPP = 400
GOLDEN_DEPTH = dict(max_total_depth=5, min_total_depth=3)


def colonnade_scene(
    n_cols: int = 8,
    sphere_detail: int = 32,
    n_lights: int = 12,
    tex_res: int = 256,
    seed: int = 7,
):
    """Sponza-class benchmark scene: an instanced colonnade hall with a
    dense displaced-terrain centerpiece — 64 column instances of one
    3,968-triangle mesh, 16 instances of a 4,418-triangle terrain tile and
    a floor quad (324,642 instanced triangles over 8,388 unique: TLAS
    instancing), a procedural 256x256 texture on the stone and floor
    materials (all PRINCIPLED), and 12 sphere lights + a constant
    environment, enough to engage the light tree.  Returns (Scene, Camera).
    """
    r = np.random.RandomState(seed)
    sc = Scene()

    # procedural checker/marble texture (floor + columns)
    yy, xx = np.meshgrid(np.arange(tex_res), np.arange(tex_res), indexing="ij")
    checker = (((xx // 16) + (yy // 16)) % 2).astype(np.float32)
    marble = 0.5 + 0.5 * np.sin(0.11 * xx + 4.0 * np.sin(0.07 * yy))
    tex = np.stack([0.25 + 0.55 * checker,
                    0.25 + 0.45 * marble,
                    0.35 + 0.35 * checker * marble], axis=-1).astype(np.float32)
    tex_id = sc.add_texture(tex, srgb=False)

    stone = sc.add_material(MaterialDesc(
        type=ShadingNode.PRINCIPLED, base_color=(0.75, 0.72, 0.68),
        base_texture=tex_id, roughness=0.55, specular=0.3))
    floor_m = sc.add_material(MaterialDesc(
        type=ShadingNode.PRINCIPLED, base_color=(0.5, 0.5, 0.55),
        base_texture=tex_id, roughness=0.25, specular=0.5))
    gold = sc.add_material(MaterialDesc(
        type=ShadingNode.PRINCIPLED, base_color=(0.9, 0.7, 0.3),
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
        sc.add_light(LightDesc(
            type=LightType.SPHERE,
            color=tuple(6.0 + 8.0 * r.rand(3)),
            position=((r.rand() - 0.5) * 20.0, 2.5 + 2.0 * r.rand(),
                      (r.rand() - 0.5) * 20.0),
            radius=0.15,
        ))
    sc.set_environment((0.12, 0.14, 0.18))
    cam = make_camera(origin=(9.0, 4.0, 9.5), look_at=(0.0, 1.0, 0.0),
                      fov=55.0)
    return sc, cam


def instanced_scene(meshes=((12, 16),), n_inst: int = 6, seed: int = 3):
    """Two-level generator scene (tests/test_traverse_tlas_pallas.py
    ``_instanced_scene`` for the default single mesh): for each (rings,
    segments) UV sphere of radius 0.6 in ``meshes``, ``n_inst`` instances
    scaled by U(0.5, 1.4) and translated by U(-2, 2)³, all DIFFUSE, in a
    constant environment.  Returns the Scene; every mesh is instanced more
    than once, so ``finalize`` picks tlas mode."""
    sc = Scene()
    m = sc.add_material(MaterialDesc(type=ShadingNode.DIFFUSE,
                                     base_color=(0.7, 0.7, 0.7)))
    rng = np.random.default_rng(seed)
    for rings, segments in meshes:
        v, idx, n, uv = make_uv_sphere(radius=0.6, rings=rings,
                                       segments=segments)
        mesh = sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)
        for _ in range(n_inst):
            t = rng.uniform(-2.0, 2.0, 3)
            s = rng.uniform(0.5, 1.4)
            x = np.eye(4, dtype=np.float32)
            x[0, 0] = x[1, 1] = x[2, 2] = s
            x[:3, 3] = t
            sc.add_instance(mesh, x)
    sc.set_environment((0.5, 0.5, 0.5))
    return sc


# ---- the traversal slice's scenes ----------------------------------------


def port_api():
    """The scene API the slice's builders take: this package's
    ``cornell_scene``, ``scene_dir_env``, ``Scene``, ``make_camera``,
    ``MaterialDesc``, ``ShadingNode``, ``LightDesc`` and ``LightType`` (a
    test passes ``ray_tpu``'s)."""
    return types.SimpleNamespace(
        cornell_scene=cornell_scene, scene_dir_env=scene_dir_env,
        Scene=Scene, make_camera=make_camera,
        MaterialDesc=MaterialDesc, ShadingNode=ShadingNode,
        LightDesc=LightDesc, LightType=LightType)


def _instance_all(sc):
    """One untransformed, fully visible instance of each mesh added so far
    (what finalize does for a scene without instances)."""
    for m in range(len(sc._meshes)):
        sc.add_instance(m)


def _xform(t, scale=(1.0, 1.0, 1.0)):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = scale
    m[:3, 3] = t
    return m


def cornell_tlas(api=None):
    """The flagship ``cornell_scene("emissive_quad")``, to be finalized with
    ``instancing="tlas"``: 24 unique triangles, one instance a mesh, the
    light quad's two TRI lights instanced — no ``wrows_tlas``, so every
    trace takes the binary two-level walk.  Returns (Scene, Camera)."""
    api = api or port_api()
    return api.cornell_scene("emissive_quad")


def cornell_vis(api=None):
    """The flagship plus three instances of one small box (36 unique
    triangles in all), each hidden from one ray type: one floating under
    the light with ``visibility_mask(camera=False)`` (its shadow shows,
    the box does not), one on the floor with ``shadow=False`` (seen, casts
    no shadow) and one scaled non-uniformly by (1.5, 0.6, 1.0) with
    ``specular=False``.  Flatten mode: the masked BVH2 walk; tlas mode:
    the binary two-level walk with ray masks.  Returns (Scene, Camera)."""
    api = api or port_api()
    sc, cam = api.cornell_scene("emissive_quad")
    _instance_all(sc)
    bv, bidx, bn = make_box(size=(0.3, 0.3, 0.3))
    box = sc.add_mesh(bv, bidx, normals=bn, material=0)
    sc.add_instance(box, _xform((0.3, 0.35, -0.1)),
                    visibility=visibility_mask(camera=False))
    sc.add_instance(box, _xform((0.35, -0.85, 0.35)),
                    visibility=visibility_mask(shadow=False))
    sc.add_instance(box, _xform((-0.55, 0.25, -0.35), (1.5, 0.6, 1.0)),
                    visibility=visibility_mask(specular=False))
    return sc, cam


def sphere_vis(api=None):
    """``cornell_sphere`` (the flagship plus a rough diffuse UV sphere, 376
    triangles) with the sphere's instance hidden from camera rays: it
    shows only in shadows and bounce light.  Flatten mode: the masked
    8-wide walk (``wrows`` with its visibility column); tlas mode:
    ``wrows_tlas`` with ray masks.  Returns (Scene, Camera)."""
    api = api or port_api()
    sc, cam = api.cornell_scene("emissive_quad")
    _instance_all(sc)
    m = sc.add_material(api.MaterialDesc(
        type=api.ShadingNode.DIFFUSE, base_color=(0.2, 0.3, 0.8),
        roughness=0.5))
    v, idx, n, uv = make_uv_sphere(center=(0.4, -0.64, -0.3), radius=0.35,
                                   rings=12, segments=16)
    sphere = sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)
    sc.add_instance(sphere, visibility=visibility_mask(camera=False))
    return sc, cam


# the environment map of env_map: latlong, width x height
ENV_MAP_RES = (512, 256)


def env_map_image(seed: int = 11, res=ENV_MAP_RES):
    """A (H, W, 3) float32 latlong sky made from ``seed``: a gradient from
    a pale horizon to a deep zenith, a dim ground below the horizon, a
    bright spot (a sun of radiance ~40) at a random direction above the
    horizon, and faint noise."""
    w, h = res
    r = np.random.default_rng(seed)
    v = (np.arange(h, dtype=np.float64) + 0.5) / h          # 0 zenith, 1 nadir
    u = (np.arange(w, dtype=np.float64) + 0.5) / w
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None]
    zenith = np.array([0.15, 0.3, 0.8])
    horizon = np.array([0.8, 0.85, 0.9])
    sky = horizon + (zenith - horizon) * up[..., None] ** 0.5
    ground = np.array([0.25, 0.22, 0.2])
    img = np.where((v < 0.5)[:, None, None], sky,
                   np.broadcast_to(ground, (h, 1, 3)))
    img = np.broadcast_to(img, (h, w, 3)).copy()
    su, sv = r.uniform(0.0, 1.0), r.uniform(0.1, 0.35)
    du = np.minimum(np.abs(u - su), 1.0 - np.abs(u - su))[None, :]
    d2 = (du * 2.0) ** 2 + (v[:, None] - sv) ** 2
    img += 40.0 * np.exp(-d2 / (2 * 0.01 ** 2))[..., None]
    img *= 1.0 + 0.05 * r.standard_normal((h, w, 1))
    return np.maximum(img, 0.0).astype(np.float32)


def env_map(api=None, portal: bool = False):
    """``scene_dir_env`` (a ground plane, a PRINCIPLED ball, a directional
    light; 2,210 triangles: the 8-wide walk) with its constant environment
    replaced by :func:`env_map_image` as a 512x256 latlong map
    (``generate_mips=False``, ``rotation=0.7``): importance-sampled
    environment NEE and MIS.  ``portal``: a 1.6 x 1.2 rect sky portal
    facing down over the ball as well.  Returns (Scene, Camera)."""
    api = api or port_api()
    sc, cam = api.scene_dir_env()
    tex = sc.add_texture(env_map_image(), srgb=False, generate_mips=False)
    sc.set_environment((1.0, 1.0, 1.0), map_id=tex, rotation=0.7)
    if portal:
        sc.add_light(api.LightDesc(
            type=api.LightType.RECT, color=(1.0, 1.0, 1.0),
            position=(0.0, 2.0, 0.0), axis_u=(1.0, 0.0, 0.0),
            axis_v=(0.0, 0.0, 1.0), width=1.6, height=1.2,
            sky_portal=True))
    return sc, cam


# ---- the sky and texture slice's scenes ----------------------------------


def physical_sky(api=None, full: bool = True, env_res=(256, 128),
                 **sky_features):
    """``samples/05_physical_sky.py``'s scene: a 60x60 DIFFUSE quad (2
    triangles: the brute-force kernel) under ``set_physical_sky`` with the
    sun 8 degrees up, sun color 30, the full sky (moon, stars, cirrus,
    clouds at ``cloud_steps=10``) baked at ``env_res``, and the sample's
    camera.  ``sky_features`` go to ``set_physical_sky`` (the port's takes
    ``device``, where the bake runs).  Returns (Scene, Camera)."""
    api = api or port_api()
    sc = api.Scene()
    sc.add_material(api.MaterialDesc(type=api.ShadingNode.DIFFUSE,
                                     base_color=(0.35, 0.3, 0.25)))
    v, idx, uv = make_quad((0, 0, 0), (0, 0, 60), (60, 0, 0))
    sc.add_mesh(v, idx, uvs=uv, material=0)
    el = np.radians(8.0)
    sky = dict(cloud_steps=10, **sky_features)
    sc.set_physical_sky(sun_direction=(np.cos(el), np.sin(el), 0.15),
                        sun_color=(30.0, 30.0, 30.0), env_res=env_res,
                        full_sky=full, **sky)
    cam = api.make_camera(origin=(0, 1.5, -4), look_at=(8, 3.5, 0), fov=60)
    return sc, cam


def tex_features_images(seed: int = 23, res: int = 256):
    """The images of :func:`tex_features`, made from ``seed``: an sRGB
    base color (uint8 noise over stripes), a one-channel roughness map,
    a tangent-space normal map of bumps (xy in [0, 1], z left to the
    decode) and a 64x64 ground texture."""
    r = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    stripes = 0.5 + 0.5 * np.sin(xx * (2 * np.pi / 32.0))
    base = np.stack([0.25 + 0.6 * stripes, 0.3 + 0.3 * (yy / res),
                     0.2 + 0.2 * (1.0 - stripes)], -1)
    base = base + 0.08 * r.standard_normal((res, res, 3))
    base = (np.clip(base, 0.0, 1.0) * 255.0).astype(np.uint8)
    rough = np.clip(0.2 + 0.6 * r.random((res // 8, res // 8)), 0.0, 1.0)
    rough = np.kron(rough, np.ones((8, 8))).astype(np.float32)
    bx = np.sin(xx * (2 * np.pi / 16.0)) * np.cos(yy * (2 * np.pi / 24.0))
    by = np.cos(xx * (2 * np.pi / 20.0)) * np.sin(yy * (2 * np.pi / 16.0))
    normal = np.stack([0.5 + 0.35 * bx, 0.5 + 0.35 * by,
                       np.ones_like(bx)], -1).astype(np.float32)
    ground = r.random((64, 64, 3)).astype(np.float32) * 0.5 + 0.25
    return base, rough, normal, ground


def tex_features(api=None):
    """``env_map``'s layout (a ground quad, a 2,208-triangle PRINCIPLED UV
    ball, a directional light: 2,210 triangles, the 8-wide walk) with every
    texture feature: the 512x256 latlong map stored ``compress="rgbe"``;
    on the ball a 256x256 sRGB base texture stored as BC1 with mips, a BC4
    roughness map, a BC5 normal map at ``normal_map_intensity=0.8`` and
    ``anisotropic=0.6`` turned by ``anisotropic_rotation=0.25``; on the
    ground an uncompressed texture, so raw and compressed records share
    one pack.  Returns (Scene, Camera)."""
    api = api or port_api()
    base, rough, normal, ground = tex_features_images()
    sc = api.Scene()
    t_ground = sc.add_texture(ground)
    t_base = sc.add_texture(base, srgb=True, compress="bc1")
    t_rough = sc.add_texture(rough, compress="bc4")
    t_normal = sc.add_texture(normal, compress="bc5")
    grey = sc.add_material(api.MaterialDesc(
        type=api.ShadingNode.DIFFUSE, base_color=(0.6, 0.6, 0.6),
        base_texture=t_ground))
    ball = sc.add_material(api.MaterialDesc(
        type=api.ShadingNode.PRINCIPLED, base_color=(1.0, 1.0, 1.0),
        base_texture=t_base, roughness=0.5, roughness_texture=t_rough,
        normal_map=t_normal, normal_map_intensity=0.8, anisotropic=0.6,
        anisotropic_rotation=0.25))
    sc.add_mesh(vertices=[[-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]],
                indices=[[0, 1, 2], [0, 2, 3]],
                uvs=[[0, 0], [4, 0], [4, 4], [0, 4]], material=grey)
    v, idx, n, uv = make_uv_sphere(radius=0.5)
    sc.add_mesh(v + [0.0, 0.5, 0.0], idx, normals=n, uvs=uv, material=ball)
    sc.add_light(api.LightDesc(
        type=api.LightType.DIR, color=(6.0, 5.5, 5.0),
        direction=(0.45, -0.8, 0.4), angle=8.0))
    env = sc.add_texture(env_map_image(), generate_mips=False,
                         compress="rgbe")
    sc.set_environment((1.0, 1.0, 1.0), map_id=env, rotation=0.7)
    cam = api.make_camera(origin=(0, 1.6, -4.0), look_at=(0, 0.4, 0),
                          fov=40.0)
    return sc, cam


def sphere_hlbvh(api=None):
    """``cornell_sphere`` (the flagship plus a rough diffuse UV sphere, 376
    triangles), to be finalized with ``fast_build=True``: the HLBVH tree
    of at most 512 rows, so every trace takes the BVH2 kernel.  Returns
    (Scene, Camera)."""
    api = api or port_api()
    sc, cam = api.cornell_scene("emissive_quad")
    m = sc.add_material(api.MaterialDesc(
        type=api.ShadingNode.DIFFUSE, base_color=(0.2, 0.3, 0.8),
        roughness=0.5))
    v, idx, n, uv = make_uv_sphere(center=(0.4, -0.64, -0.3), radius=0.35,
                                   rings=12, segments=16)
    sc.add_mesh(v, idx, normals=n, uvs=uv, material=m)
    return sc, cam
