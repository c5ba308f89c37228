"""Per-ray-type visibility bitmasks.

A copy of ``ray_tpu.scene.visibility`` (numpy only).

The reference gives every mesh instance five visibility booleans — camera,
diffuse, specular, refraction and shadow (``mesh_instance_desc_t``,
SceneBase.h:135-160) — packed into a ``ray_visibility`` mask tested during
traversal (internal/Core.h:384 ``mesh_instance_t``, Constants.inl ray-type
ids).  We keep the same bit assignment: bit index == ray type
(render/uber.py RAY_TYPE_*).
"""

RAY_CAMERA = 1 << 0
RAY_DIFFUSE = 1 << 1
RAY_SPECULAR = 1 << 2
RAY_REFR = 1 << 3
RAY_SHADOW = 1 << 4
RAY_ALL = RAY_CAMERA | RAY_DIFFUSE | RAY_SPECULAR | RAY_REFR | RAY_SHADOW


