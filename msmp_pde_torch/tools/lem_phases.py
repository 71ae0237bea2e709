"""Where a launch of the LEM-scan kernels spends its time, by phase.

    python3 -m msmp_pde_torch.tools.lem_phases

Builds ``csrc/lem_fwd.cu`` and ``csrc/lem_bwd.cu`` with
``-DLEM_PHASE_TIMES`` into ``build/torch_kernels_phases/``: thread 0 of
the first CTA then adds the SM cycles of each part of its launch to a
counter (``csrc/lem_step.cuh``), summed over the T steps. Runs the forward
(with and without the stash) and the backward through their wrappers at
the LEM encoder's shapes (T 25, hidden 128) over N = 100 and 1600 rows,
with inputs from a seed, and prints the mean cycles a launch of each phase
over 10 launches, with its share of the total. A phase that waits (a
cluster barrier, the first use of a product's accumulators) also holds the
time the other warps and CTAs take to get there. Also the card's name and
power limit. Needs a CUDA card.
"""
import ctypes
import sys

import torch

from msmp_pde_torch.ops import _build, lem_scan
from msmp_pde_torch.tools.lem_times import card, lem_args, seeded

PHASES = {
    "lem_fwd": ("set-up", "g product", "z'", "z' out", "barrier",
                "a product", "y' out", "barrier"),
    "lem_bwd": ("set-up", "rows, inputs", "recompute", "da, dg2", "dz part",
                "dWzz", "barrier", "dg1, dzc", "dy part", "dWy", "y rows",
                "barrier", "dy sum"),
}
LAUNCHES = 10
T, H = 25, 128


def instrumented():
    out = _build.BUILD_DIR.parent / "torch_kernels_phases"
    _build.build_variants(tuple(PHASES), out, ("-DLEM_PHASE_TIMES",))
    return {n: _build.use(n, out / f"lib{n}.so") for n in PHASES}


def main():
    if not torch.cuda.is_available():
        sys.exit("lem_phases: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card())
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
            cyc = [c / LAUNCHES for c in buf[:len(PHASES[lib])]]
            total = sum(cyc)
            print(f"{name} N={N}: {total:.0f} cycles a launch; " + ", ".join(
                f"{p} {c:.0f} ({100 * c / total:.1f}%)"
                for p, c in zip(PHASES[lib], cyc)))


if __name__ == "__main__":
    main()
