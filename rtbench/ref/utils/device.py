"""The device every entry point of the port runs on."""

import torch


def resolve_device(device=None) -> torch.device:
    """The render device: CUDA unless the caller names another.  With no
    CUDA device and no explicit ``device`` this raises instead of falling
    back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch renders on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")
