"""Materials: host-side descriptors → dense SoA float table.

A copy of ``ray_tpu.scene.materials`` (numpy only).

Capability match for the reference's shading-node set
(SceneBase.h:42 ``eShadingNode``: Diffuse/Glossy/Refractive/Emissive/Mix/
Transparent/Principled; packed runtime record internal/Core.h:167
``material_t``), redesigned for TPU:

* every parameter is a plain float32 column — no unorm16 packing, so every
  field is differentiable and the whole table is a valid gradient leaf;
* all node types share the one superset parameter space; shading evaluates
  the superset uber-BSDF once per hit and blends lobes by weights
  (compute-all-select — no per-lane dispatch on a vector machine).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class ShadingNode:
    DIFFUSE = 0
    GLOSSY = 1
    REFRACTIVE = 2
    EMISSIVE = 3
    MIX = 4
    TRANSPARENT = 5
    PRINCIPLED = 6


# flag bits (reference internal/Constants.inl:88-89)
MAT_FLAG_IMP_SAMPLE = 1 << 0
MAT_FLAG_MIX_ADD = 1 << 1
MAT_FLAG_TWO_SIDED = 1 << 2

NO_TEXTURE = -1


@dataclasses.dataclass
class MaterialDesc:
    """Host-side material description (superset of the reference's
    ``shading_node_desc_t``/``principled_mat_desc_t``, SceneBase.h:46-96)."""

    type: int = ShadingNode.DIFFUSE
    base_color: tuple = (1.0, 1.0, 1.0)
    base_texture: int = NO_TEXTURE
    normal_map: int = NO_TEXTURE
    normal_map_intensity: float = 1.0
    roughness: float = 0.5
    roughness_texture: int = NO_TEXTURE
    anisotropic: float = 0.0
    anisotropic_rotation: float = 0.0
    metallic: float = 0.0
    metallic_texture: int = NO_TEXTURE
    specular: float = 0.5
    specular_texture: int = NO_TEXTURE
    specular_tint: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.5
    clearcoat: float = 0.0
    clearcoat_roughness: float = 0.0
    ior: float = 1.45
    transmission: float = 0.0
    transmission_roughness: float = 0.0
    emission_color: tuple = (0.0, 0.0, 0.0)
    emission_strength: float = 1.0
    alpha: float = 1.0
    alpha_texture: int = NO_TEXTURE
    # Mix node
    mix_materials: tuple = (NO_TEXTURE, NO_TEXTURE)
    mix_fresnel: float = 1.0  # "fresnel" factor of the mix (SceneBase.h:60)
    strength: float = 1.0     # emissive strength / mix blend strength
    tint: float = 0.0         # glossy specular tint
    importance_sample: bool = False
    mix_add: bool = False
    two_sided: bool = False


_F32_FIELDS = [
    ("roughness", 1),
    ("anisotropic", 1),
    ("anisotropic_rotation", 1),
    ("metallic", 1),
    ("specular", 1),
    ("specular_tint", 1),
    ("sheen", 1),
    ("sheen_tint", 1),
    ("clearcoat", 1),
    ("clearcoat_roughness", 1),
    ("ior", 1),
    ("transmission", 1),
    ("transmission_roughness", 1),
    ("emission_strength", 1),
    ("alpha", 1),
    ("mix_fresnel", 1),
    ("strength", 1),
    ("tint", 1),
    ("normal_map_intensity", 1),
]

_I32_FIELDS = [
    "base_texture",
    "normal_map",
    "roughness_texture",
    "metallic_texture",
    "specular_texture",
    "alpha_texture",
]


def pack_materials(descs: list) -> dict:
    """Flatten material descriptors to a dict of numpy SoA columns.

    Returned keys: ``type`` (i32), ``flags`` (i32), ``base_color`` (N,3 f32),
    ``emission_color`` (N,3 f32), ``mix_mat1``/``mix_mat2`` (i32), texture
    index columns, and every scalar in ``_F32_FIELDS``.
    """
    n = len(descs)
    if n == 0:
        descs = [MaterialDesc()]  # keep arrays non-empty for gather safety
        n = 1
    out = {
        "type": np.array([d.type for d in descs], np.int32),
        "base_color": np.array([d.base_color for d in descs], np.float32),
        "emission_color": np.array([d.emission_color for d in descs], np.float32),
        "mix_mat1": np.array([d.mix_materials[0] for d in descs], np.int32),
        "mix_mat2": np.array([d.mix_materials[1] for d in descs], np.int32),
    }
    flags = np.zeros(n, np.int32)
    for i, d in enumerate(descs):
        f = 0
        if d.importance_sample:
            f |= MAT_FLAG_IMP_SAMPLE
        if d.mix_add:
            f |= MAT_FLAG_MIX_ADD
        if d.two_sided:
            f |= MAT_FLAG_TWO_SIDED
        flags[i] = f
    out["flags"] = flags
    for name, _ in _F32_FIELDS:
        out[name] = np.array([getattr(d, name) for d in descs], np.float32)
    # the reference stores HALF the descriptor sheen (SceneCPU.cpp:224,263
    # pack 0.5*m.sheen) and shading doubles it back (ShadeRef.cpp:1562) —
    # net: effective sheen == desc.sheen.  uber.py keeps the 2x, so halve
    # here for descriptor-level parity.
    out["sheen"] = np.clip(out["sheen"] * 0.5, 0.0, 1.0)
    for name in _I32_FIELDS:
        out[name] = np.array([getattr(d, name) for d in descs], np.int32)
    return out
