"""SceneFlat serialization: save/load a *finalized* scene to one .npz.

The port of ``ray_tpu.scene.scene_io``, in ``ray_tpu``'s file format: the
arrays keyed by field path (``"materials.base_color"``), the static fields
and the key sets of the dict fields as JSON in ``__meta__``.  A file
written by either package loads in the other: the two ``SceneFlat``
types have the same fields, tables and static values.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ray_tpu_torch.scene.scene import SceneFlat

# ray_tpu's static (pytree-metadata) fields of SceneFlat
_STATIC_FIELDS = (
    "max_leaf", "num_lights", "env_light_index", "stack_size", "light_kinds",
    "env_tab_w", "env_tab_h", "light_tree_depth", "mode", "has_visibility",
    "has_transparency", "has_textures", "has_mix", "has_normal_maps",
    "has_aniso_rotation", "mat_types",
)


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(prefix, obj, out):
    if obj is None:
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}", v, out)
        return
    out[prefix] = _to_numpy(obj)


def _json_static(v):
    """Static values as JSON takes them (numpy scalars → Python)."""
    if isinstance(v, (tuple, list)):
        return [_json_static(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def save_scene(path: str, scene: SceneFlat) -> None:
    """Write a finalized scene (on any device) to one ``.npz``."""
    arrays = {}
    statics = {}
    none_fields = []
    for f in dataclasses.fields(SceneFlat):
        v = getattr(scene, f.name)
        if f.name in _STATIC_FIELDS:
            statics[f.name] = _json_static(v)
        elif v is None:
            none_fields.append(f.name)
        else:
            _flatten(f.name, v, arrays)
    # dict-valued fields need their key sets to rebuild
    dict_fields = {
        f.name: sorted(getattr(scene, f.name).keys())
        for f in dataclasses.fields(SceneFlat)
        if isinstance(getattr(scene, f.name), dict)
    }
    meta = json.dumps({
        "statics": statics,
        "none": none_fields,
        "dicts": dict_fields,
        "version": 1,
    })
    np.savez_compressed(path, __meta__=np.frombuffer(
        meta.encode(), np.uint8
    ), **arrays)


def load_scene(path: str, *, device=None) -> SceneFlat:
    """Read a scene written by :func:`save_scene` (of either package) onto
    ``device`` (default CUDA; ``device="cpu"`` for the plain path)."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    static = dict(meta["statics"])
    # JSON turns tuples into lists — restore the static tuple fields
    if "light_kinds" in static:
        static["light_kinds"] = tuple(
            tuple(row) for row in static["light_kinds"]
        )
    if "mat_types" in static:
        static["mat_types"] = tuple(static["mat_types"])
    arrays = {name: None for name in meta["none"]}
    for f in dataclasses.fields(SceneFlat):
        if f.name in static or f.name in arrays:
            continue
        if f.name in meta["dicts"]:
            arrays[f.name] = {
                k: data[f"{f.name}.{k}"] for k in meta["dicts"][f.name]
            }
        else:
            arrays[f.name] = data[f.name]
    return SceneFlat.from_numpy(arrays, static, device=device)
