"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions,
registered as ``torch.library`` ops in the ``msmp`` namespace
(ops/library.py) when this package is imported."""
from msmp_pde_torch.ops import library  # noqa: F401
