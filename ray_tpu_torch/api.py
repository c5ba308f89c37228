"""Library facade: renderer factory, device query, logging.

The port of ``ray_tpu.api`` (reference Ray.h / Ray.cpp):

* ``create_renderer``: the factory over a chain of backends
  (Ray.cpp:53-122).  The port has one compute path with two placements:
  the CUDA card (its kernels) and the CPU (their plain PyTorch versions,
  the executable spec the kernels are held to).  The default chain names
  the card only: without one, ``create_renderer()`` raises.  The CPU is
  used only when the caller names it, in ``enabled_types`` or as
  ``preferred_device="cpu"``; ``ray_tpu``'s factory falls through to the
  host CPU on its own, the port's never does.
* ``query_available_devices``: ``QueryAvailableGPUDevices`` (Ray.cpp:124).
* ``match_device_names``: regex device matching (``MatchDeviceNames``,
  Ray.cpp:135).
* ``ILog`` / ``LogNull`` / ``LogStdout``: the injected logger (Log.h:16,
  Ray.cpp:44-45).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from ray_tpu_torch.render.integrator import PassSettings
from ray_tpu_torch.render.renderer import Renderer, RenderSettings


class RendererType:
    """eRendererType analogue (RendererBase.h:22-34): where the one
    compute path runs.  GPU is the CUDA card; CPU and REF are the host
    CPU's plain PyTorch versions (REF, the reference backend, is the same
    spec).  TPU exists for ``ray_tpu``'s callers and is never available to
    the port."""

    TPU = "tpu"
    GPU = "gpu"
    CPU = "cpu"
    REF = "ref"

    DEFAULT_CHAIN = ("gpu",)


class ILog:
    """Injected logger (reference Log.h:16): Info/Warning/Error."""

    def info(self, msg: str) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def warning(self, msg: str) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def error(self, msg: str) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class LogNull(ILog):
    """Swallows everything (Ray.cpp:44 LogNull)."""

    def info(self, msg: str) -> None:
        pass

    def warning(self, msg: str) -> None:
        pass

    def error(self, msg: str) -> None:
        pass


class LogStdout(ILog):
    """Prints to stdout (Ray.cpp:45 LogStdout)."""

    def info(self, msg: str) -> None:
        print(f"[INFO] {msg}")

    def warning(self, msg: str) -> None:
        print(f"[WARN] {msg}")

    def error(self, msg: str) -> None:
        print(f"[ERROR] {msg}")


@dataclasses.dataclass
class DeviceInfo:
    """gpu_device_t analogue (Ray.h:30-35)."""

    name: str
    platform: str
    index: int


def _cuda_devices() -> list[DeviceInfo]:
    if not torch.cuda.is_available():
        return []
    return [DeviceInfo(name=torch.cuda.get_device_name(i), platform="gpu",
                       index=i) for i in range(torch.cuda.device_count())]


def query_available_devices() -> list[DeviceInfo]:
    """The CUDA devices, then the host CPU (QueryAvailableGPUDevices,
    Ray.cpp:124)."""
    return _cuda_devices() + [DeviceInfo(name="cpu", platform="cpu", index=0)]


def match_device_names(name: str, pattern: str) -> bool:
    """Regex device-name match (MatchDeviceNames, Ray.cpp:135)."""
    return re.search(pattern, name, re.IGNORECASE) is not None


def version() -> str:
    """Library version (Ray::Version, Ray.cpp:140)."""
    from ray_tpu_torch import __version__

    return __version__


def create_renderer(
    settings: Optional[RenderSettings] = None,
    pass_settings: Optional[PassSettings] = None,
    log: Optional[ILog] = None,
    enabled_types: tuple = RendererType.DEFAULT_CHAIN,
    preferred_device: Optional[str] = None,
) -> Renderer:
    """A renderer on the first backend of ``enabled_types`` that has a
    device, as the reference factory tries its backends in order
    (Ray.cpp:56-121).

    ``preferred_device``: a regex matched against the CUDA device names
    (``torch.cuda.get_device_name``; settings_t.preferred_device,
    RendererBase.h:54); a backend with no matching device is skipped.
    ``"cpu"`` names the host CPU and adds it to the chain.  Raises
    ``RuntimeError`` when no backend of the chain has a device.
    """
    settings = settings or RenderSettings()
    pass_settings = pass_settings or PassSettings()
    log = log or LogNull()
    chain = tuple(enabled_types)
    if preferred_device is not None and preferred_device.lower() == "cpu":
        chain = chain + (RendererType.CPU,)

    chosen = None
    for backend in chain:
        if backend == RendererType.GPU:
            devices = [(torch.device("cuda", d.index), d.name)
                       for d in _cuda_devices()]
        elif backend in (RendererType.CPU, RendererType.REF):
            devices = [(torch.device("cpu"), "cpu")]
        else:
            devices = []
        if not devices:
            log.info(f"backend '{backend}' unavailable")
            continue
        if preferred_device is not None:
            devices = [d for d in devices
                       if match_device_names(d[1], preferred_device)]
            if not devices:
                log.warning(f"backend '{backend}': no device matches "
                            f"'{preferred_device}', falling through")
                continue
        chosen = (backend, *devices[0])
        break
    if chosen is None:
        raise RuntimeError(f"no renderer backend available from {chain}")

    backend, device, name = chosen
    log.info(f"ray_tpu_torch {version()}: renderer on {backend} ({name}), "
             f"{settings.width}x{settings.height}, "
             f"spatial_cache={settings.use_spatial_cache}")
    r = Renderer(settings, pass_settings, device=device)
    r.backend_type = backend
    r.log = log
    return r
