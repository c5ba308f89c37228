"""Light sources: host-side descriptors → dense SoA table + sampling CDF.

A copy of ``ray_tpu.scene.lights`` (numpy only).

Covers the reference's light set (SceneBase.h:195-268 descriptors; runtime
tagged union internal/Core.h:194 ``light_t``): sphere (incl. spot), dir, line,
rect, disk, emissive-triangle and environment lights.  Instead of a tagged
64-byte union we store one SoA column per parameter — colors stay
differentiable and the NEE sampling kernel evaluates all light types with
compute-all-select.

Light *picking* in round 1 uses a power-weighted CDF (flux-proportional,
matching what the reference's hierarchical light BVH converges to in
expectation; the BVH itself — internal/Core.cpp:859 light-tree flatten — is a
later optimization for many-light scenes).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


class LightType:
    SPHERE = 0
    DIR = 1
    LINE = 2
    RECT = 3
    DISK = 4
    TRI = 5
    ENV = 6


@dataclasses.dataclass
class LightDesc:
    """Superset descriptor for every analytic light type."""

    type: int = LightType.SPHERE
    color: tuple = (1.0, 1.0, 1.0)
    # sphere / spot
    position: tuple = (0.0, 0.0, 0.0)
    radius: float = 0.0
    spot_size: float = -1.0    # degrees; < 0 → not a spot
    spot_blend: float = 0.0
    # dir
    direction: tuple = (0.0, -1.0, 0.0)
    angle: float = 0.0         # angular diameter, degrees
    # rect / disk / line
    width: float = 1.0
    height: float = 1.0
    # tri
    tri_index: int = -1
    # world-space triangle vertices (3,3) for TRI lights; set at finalize so
    # light sampling / light-tree bounds don't depend on the scene arrays'
    # space (object space under TLAS instancing)
    tri_verts: object = None
    # transform for area lights: position + axes
    axis_u: tuple = (1.0, 0.0, 0.0)
    axis_v: tuple = (0.0, 0.0, 1.0)
    # flags
    doublesided: bool = False
    sky_portal: bool = False
    multiple_importance: bool = True
    cast_shadow: bool = True
    visible: bool = True


def _light_power(d: LightDesc) -> float:
    """Approximate emitted flux for CDF weighting (same role as the flux the
    reference stores per light-BVH node, internal/Core.h:100)."""
    c = np.asarray(d.color, np.float64)
    lum = float(0.212671 * c[0] + 0.715160 * c[1] + 0.072169 * c[2])
    if d.type == LightType.SPHERE:
        area = 4.0 * math.pi * max(d.radius, 1e-4) ** 2
        return lum * area * math.pi
    if d.type == LightType.DIR:
        return lum
    if d.type == LightType.RECT:
        return lum * d.width * d.height * math.pi * (2.0 if d.doublesided else 1.0)
    if d.type == LightType.DISK:
        return lum * 0.25 * math.pi * d.width * d.height * math.pi
    if d.type == LightType.LINE:
        return lum * 2.0 * math.pi * d.radius * d.height * math.pi
    if d.type == LightType.TRI:
        return lum  # area factored in by caller (pack_lights patches it)
    if d.type == LightType.ENV:
        return lum
    return lum


def effective_visible(d) -> bool:
    """Whether BSDF/camera rays can hit this light — the reference's
    l.visible (SceneCPU.cpp:590-739): multiple_importance gates every
    type, and zero-radius sphere/line lights are point/line deltas that
    cannot be intersected (l.visible = mi && radius > 0).  A visible=False
    light is NEE-only with MIS weight 1 (ls.area = 0)."""
    vis = bool(d.visible) and bool(d.multiple_importance)
    if d.type in (LightType.SPHERE, LightType.LINE):
        vis = vis and float(d.radius) > 0.0
    if d.type == LightType.ENV:
        vis = False
    return vis


def pack_lights(descs: list, tri_areas=None) -> dict:
    """Flatten light descriptors into SoA numpy columns + picking CDF.

    ``tri_areas``: optional dict {desc_index: world-space area} for TRI lights
    so their pick probability is flux-proportional.
    """
    n = len(descs)
    if n == 0:
        # one dummy light with zero power so gathers stay in-bounds
        descs = [LightDesc(color=(0.0, 0.0, 0.0), radius=1e-3)]
        n = 1
    cols = {
        "type": np.array([d.type for d in descs], np.int32),
        "col": np.array([d.color for d in descs], np.float32),
        "pos": np.array([d.position for d in descs], np.float32),
        # DIR lights store the direction *toward* the light (negated user
        # direction, like the reference: SceneCPU.cpp:597); spot directions
        # stay as given (they point along the beam)
        "dir": np.array(
            [
                (-1.0 if d.type == LightType.DIR else 1.0)
                * np.asarray(d.direction, np.float64)
                / max(np.linalg.norm(d.direction), 1e-12)
                for d in descs
            ],
            np.float32,
        ),
        "radius": np.array([d.radius for d in descs], np.float32),
        "u": np.array([d.axis_u for d in descs], np.float32),
        "v": np.array([d.axis_v for d in descs], np.float32),
        "width": np.array([d.width for d in descs], np.float32),
        "height": np.array([d.height for d in descs], np.float32),
        "angle": np.array([d.angle for d in descs], np.float32),
        "spot_cos": np.array(
            [
                math.cos(math.radians(d.spot_size) * 0.5) if d.spot_size >= 0.0 else -2.0
                for d in descs
            ],
            np.float32,
        ),
        "spot_blend": np.array([d.spot_blend for d in descs], np.float32),
        "tri_index": np.array([d.tri_index for d in descs], np.int32),
        # world-space tri verts (zeros for non-TRI lights) — the gather
        # source for TRI sampling under TLAS instancing
        "tp0": np.array(
            [np.asarray(d.tri_verts)[0] if d.tri_verts is not None
             else (0.0, 0.0, 0.0) for d in descs], np.float32,
        ),
        "tp1": np.array(
            [np.asarray(d.tri_verts)[1] if d.tri_verts is not None
             else (0.0, 0.0, 0.0) for d in descs], np.float32,
        ),
        "tp2": np.array(
            [np.asarray(d.tri_verts)[2] if d.tri_verts is not None
             else (0.0, 0.0, 0.0) for d in descs], np.float32,
        ),
        "doublesided": np.array([d.doublesided for d in descs], np.bool_),
        "portal": np.array([d.sky_portal for d in descs], np.bool_),
        "cast_shadow": np.array([d.cast_shadow for d in descs], np.bool_),
        "visible": np.array([effective_visible(d) for d in descs],
                            np.bool_),
        "multiple_importance": np.array(
            [d.multiple_importance for d in descs], np.bool_
        ),
    }
    power = np.array([_light_power(d) for d in descs], np.float64)
    if tri_areas:
        for i, a in tri_areas.items():
            power[i] *= max(a, 1e-12) * math.pi
    total = power.sum()
    if total <= 0.0:
        pdf = np.full(n, 1.0 / n)
    else:
        pdf = power / total
    cols["pick_pdf"] = pdf.astype(np.float32)
    cols["pick_cdf"] = np.cumsum(pdf).astype(np.float32)
    cols["pick_cdf"][-1] = 1.0
    return cols
