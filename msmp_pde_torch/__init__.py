"""MSMP-PDE in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``msmp_pde_tpu`` (JAX on a TPU), which stays the reference.
This package imports ``torch`` and never ``jax`` or ``msmp_pde_tpu``.
"""
from msmp_pde_torch.device import resolve_device

__all__ = ["resolve_device"]
