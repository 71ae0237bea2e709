"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. There is
no silent fallback: asking for CUDA on a host without it raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
