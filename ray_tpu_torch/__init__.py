"""ray_tpu_torch — the PyTorch + CUDA port of ``ray_tpu``, for NVIDIA Hopper.

The package mirrors ``ray_tpu``'s layout module for module.  It imports
torch, numpy and the standard library only — never JAX and never
``ray_tpu``.  Entry points run on the CUDA device unless the caller names
another (``Scene.finalize(device="cpu")`` runs the plain PyTorch path).
Hand-written kernels live in ``csrc/`` and are built at first use; each
has a plain PyTorch version beside its wrapper.
"""
