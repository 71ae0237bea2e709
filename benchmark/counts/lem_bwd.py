"""Work of ``lem_bwd`` (msmp_pde_torch/csrc/lem_bwd.cu), the LEM scan's
backpropagation through time over T steps of N = B nx rows at width H (a
frozen copy of chip_smoke.py's count). Each row-step recomputes
the two recurrent products from the stashed states (y w_y, H x 3H, and
z w_zz, H x H: 8 H^2 FLOPs), carries dy and dz back through them (8 H^2)
and adds to both weight gradients (8 H^2): 24 H^2 FLOPs. It reads
gx, zx, the stashed ys and zs, y0, z0, dyT, dzT and both recurrent
matrices, and writes dgx, dzx, dy0, dz0 and both matrices' gradients.
Every launch of the call counts (the sweep and the reduction at hidden
96 and 128; the transposes, the ring sweep and the weight-gradient kernel
at 164)."""
from __future__ import annotations

DEVICE_NAMES = ("lem_bwd_sweep", "lem_bwd_reduce", "lem_transpose",
                "lem_bwd_ring", "lem_bwd_wgrad")
COUNTER = ("msmp_pde_torch.ops.lem_scan", "bwd_launches")


def work(shape):
    """(bytes, product FLOPs, other FLOPs) of one call."""
    T, N, H = shape["T"], shape["N"], shape["H"]
    nbytes = 4 * (10 * T * N * H + 6 * N * H + 8 * H * H)
    return nbytes, 24 * T * N * H * H, 0.0
