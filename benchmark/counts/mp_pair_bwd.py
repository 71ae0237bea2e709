"""Work of ``mp_pair_bwd`` (msmp_pde_torch/csrc/mp_pair_bwd.cu), the fused
gated pair's backward: given only the pair's inputs and the output's
cotangent, it has to run both layers' forwards again and then both
backwards, on each of B graphs."""
from __future__ import annotations

from benchmark.counts import layer

DEVICE_NAMES = ("mp_pair_bwd_kernel",)
COUNTER = ("msmp_pde_torch.ops.mp_pair", "bwd_launches")


def work(shape):
    """(bytes, product FLOPs, other FLOPs) of one launch."""
    B, nx, H, D, V, E = (shape[k] for k in ("B", "nx", "H", "D", "V", "E"))
    flops = 2 * B * (layer.forward(nx, H, D, V, E)
                     + layer.backward(nx, H, D, V, E))
    return layer.io_bytes(shape, 2, 1, backward_pass=True), flops, 0.0
