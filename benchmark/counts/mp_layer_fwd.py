"""Work of ``mp_layer_fwd`` (msmp_pde_torch/csrc/mp_layer_fwd.cu), one
message-passing layer's forward on each of B graphs."""
from __future__ import annotations

from benchmark.counts import layer

DEVICE_NAMES = ("mp_layer_fwd_kernel",)
COUNTER = ("msmp_pde_torch.ops.mp_layer", "launches")


def work(shape):
    """(bytes, product FLOPs, other FLOPs) of one launch."""
    B, nx, H, D, V, E = (shape[k] for k in ("B", "nx", "H", "D", "V", "E"))
    return (layer.io_bytes(shape, 1, 1), B * layer.forward(nx, H, D, V, E),
            0.0)
