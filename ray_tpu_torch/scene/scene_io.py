"""``ray_tpu.scene.scene_io``'s entry points, not ported yet.

``save_scene`` / ``load_scene`` keep ``ray_tpu``'s signatures so that the
package exports every name ``ray_tpu`` exports; each raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from ray_tpu_torch._roadmap import not_ported


def save_scene(path: str, scene) -> None:
    """Write a finalized scene to one ``.npz`` (not ported yet)."""
    raise not_ported("save_scene", "Queue 1 item 14")


def load_scene(path: str):
    """Read a scene written by ``save_scene`` (not ported yet)."""
    raise not_ported("load_scene", "Queue 1 item 14")
