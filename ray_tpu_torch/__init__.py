"""ray_tpu_torch — the PyTorch + CUDA port of ``ray_tpu``, for NVIDIA Hopper.

The package mirrors ``ray_tpu``'s layout module for module and exports
what ``ray_tpu`` exports with the same signatures, so that ``import
ray_tpu_torch as ray_tpu`` runs ``ray_tpu``'s quickstart.  It
imports torch, numpy and the standard library only — never JAX and never
``ray_tpu``.  Entry points run on the CUDA device unless the caller names
another (``Scene.finalize(device="cpu")``, ``create_renderer(
enabled_types=("cpu",))``: the plain PyTorch path).  Hand-written kernels
live in ``csrc/`` and are built at first use; each has a plain PyTorch
version beside its wrapper.
"""

__version__ = "0.1.0"

from ray_tpu_torch.scene.camera import Camera, CamType, PixelFilter, make_camera  # noqa: E402
from ray_tpu_torch.scene.scene import Scene, SceneFlat  # noqa: E402
from ray_tpu_torch.scene.materials import MaterialDesc  # noqa: E402
from ray_tpu_torch.scene.lights import LightDesc  # noqa: E402
from ray_tpu_torch.render.renderer import Renderer, RenderSettings, RegionContext  # noqa: E402
from ray_tpu_torch.render.integrator import PassSettings  # noqa: E402
from ray_tpu_torch.render.tonemap import ViewTransform  # noqa: E402
from ray_tpu_torch.scene.scene_io import load_scene, save_scene  # noqa: E402
from ray_tpu_torch.api import (  # noqa: E402
    DeviceInfo,
    ILog,
    LogNull,
    LogStdout,
    RendererType,
    create_renderer,
    match_device_names,
    query_available_devices,
    version,
)

__all__ = [
    "Camera",
    "CamType",
    "PixelFilter",
    "make_camera",
    "Scene",
    "SceneFlat",
    "MaterialDesc",
    "LightDesc",
    "Renderer",
    "RenderSettings",
    "RegionContext",
    "PassSettings",
    "ViewTransform",
    "DeviceInfo",
    "ILog",
    "LogNull",
    "LogStdout",
    "RendererType",
    "create_renderer",
    "match_device_names",
    "query_available_devices",
    "version",
    "save_scene",
    "load_scene",
    "__version__",
]
