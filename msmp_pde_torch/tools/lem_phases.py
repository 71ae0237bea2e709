"""Where a launch of the LEM-scan kernels spends its time, by phase.

    python3 -m msmp_pde_torch.tools.lem_phases [--hidden {96,128,164}]

Builds ``csrc/lem_fwd.cu`` and ``csrc/lem_bwd.cu`` with
``-DLEM_PHASE_TIMES`` into ``build/torch_kernels_phases/``: thread 0 of
the first CTA then adds the SM cycles of each part of its launch to a
counter (``csrc/lem_step.cuh``), summed over the T steps. Runs the forward
(with and without the stash) and the backward through their wrappers at
the LEM encoder's shapes (T 25, hidden 128 or ``--hidden``) over N = 100
and 1600 rows, with inputs from a seed, and prints the mean cycles a
launch of each phase over 10 launches, with its share of the total. A
phase that waits (a cluster barrier, the first use of a product's
accumulators) also holds the time the other warps and CTAs take to get
there. At hidden 164 the phases are those of the sweep's CTA 0
(``lem_fwd_ring``, ``lem_bwd_ring``): waiting for the ring's next tile,
the products on it, the gates, the stores (stash, outputs, row buffers),
the consumer warps' barrier and, in the backward, waiting for the next
step's rows; the backward's weight gradients are a launch of their own
(``tools/lem_times.py``). Also the card's name and power limit. Needs a
CUDA card.
"""
import ctypes
import sys

import torch

from msmp_pde_torch.ops import _build, lem_scan
from msmp_pde_torch.tools.lem_times import (
    T,
    card,
    parse,
    lem_args,
    seeded,
)

PHASES = {  # the cluster route's (hidden 96, 128)
    "lem_fwd": ("set-up", "g product", "z'", "z' out", "barrier",
                "a product", "y' out", "barrier"),
    "lem_bwd": ("set-up", "rows, inputs", "recompute", "da, dg2", "dz part",
                "dWzz", "barrier", "dg1, dzc", "dy part", "dWy", "y rows",
                "barrier", "dy sum"),
}
RING_PHASES = {  # the hidden-164 route's (csrc/lem_step.cuh, GEN_PHASE)
    "lem_fwd": ("set-up", "ring wait", "products", "gates", "stores",
                "barrier"),
    "lem_bwd": ("set-up", "ring wait", "products", "gates", "stores",
                "barrier", "rows wait"),
}
LAUNCHES = 10


def instrumented():
    out = _build.BUILD_DIR.parent / "torch_kernels_phases"
    _build.build_variants(tuple(PHASES), out, ("-DLEM_PHASE_TIMES",))
    return {n: _build.use(n, out / f"lib{n}.so") for n in PHASES}


def main(argv=None):
    H = parse(argv, "The LEM-scan kernels' time by phase").hidden
    if not torch.cuda.is_available():
        sys.exit("lem_phases: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card())
    print(f"T {T}, hidden {H}")
    phases = RING_PHASES if H in lem_scan.RING_H else PHASES
    libs = instrumented()
    rand = seeded(0, torch.device("cuda"))
    buf = (ctypes.c_ulonglong * 16)()
    for N in (100, 1600):
        args = lem_args(rand, T, N, H)
        _, _, ys, zs = lem_scan.lem_scan_plain(*args, stash=True)
        bargs = (*args, ys, zs, rand(N, H), rand(N, H))
        runs = (("lem_fwd", "lem_fwd", lambda: lem_scan.lem_scan_kernel(
                    *args)),
                ("lem_fwd", "lem_fwd_stash", lambda: lem_scan.lem_scan_kernel(
                    *args, stash=True)),
                ("lem_bwd", "lem_bwd", lambda: lem_scan.lem_scan_bwd_kernel(
                    *bargs)))
        for lib, name, fn in runs:
            read = getattr(libs[lib], f"{lib}_phase_cycles")
            fn()
            torch.cuda.synchronize()
            read(buf)  # clears
            for _ in range(LAUNCHES):
                fn()
            torch.cuda.synchronize()
            if read(buf) != 0:
                raise RuntimeError(f"{lib}: reading the phase cycles failed")
            cyc = [c / LAUNCHES for c in buf[:len(phases[lib])]]
            total = sum(cyc)
            print(f"{name} N={N}: {total:.0f} cycles a launch; " + ", ".join(
                f"{p} {c:.0f} ({100 * c / total:.1f}%)"
                for p, c in zip(phases[lib], cyc)))


if __name__ == "__main__":
    main()
