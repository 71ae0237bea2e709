"""Per-phase device times of the two message-passing backward kernels.

    python3 -m msmp_pde_torch.tools.bwd_phases

Builds ``csrc/mp_pair_bwd.cu`` and ``csrc/mp_layer_bwd.cu`` with
``-DMP_PHASE_TIMES`` into ``build/torch_kernels_phases/``: block 0 then reads
the card's clock after every grid-wide barrier (two barriers more than the
plain build, at the start and the end). Runs each backward through its
wrapper at E1's shapes (nx 100, radius graph with K 6, hidden 128, tw 25,
one variable) with weights and inputs from a seed, at batches 16 and 48, and
prints the median over 20 launches of each phase's microseconds (the phase
letters of ``csrc/mp_phases.cuh``), the cooperative grid, and the card's
name and power limit. Needs a CUDA card.
"""
import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from msmp_pde_torch.data.graph import build_neighbors_radius
from msmp_pde_torch.models.gnn import GNNLayer
from msmp_pde_torch.ops import _build, mp_layer, mp_pair

PHASES = ("A", "A2", "B", "B2", "C", "D", "E", "F", "G", "H", "I", "J", "K")
LAUNCHES = 20


def instrumented():
    """Build both backwards with the phase clock and load them in place of
    the plain builds."""
    out = _build.BUILD_DIR.parent / "torch_kernels_phases"
    for name in ("mp_pair_bwd", "mp_layer_bwd"):
        lib = out / f"lib{name}.so"
        _build.build_variant(name, lib, ("-DMP_PHASE_TIMES",))
        _build.use(name, lib)


def phase_us(name, fn):
    """{phase: median microseconds} over LAUNCHES launches of fn."""
    read = getattr(_build.load(name), f"{name}_phase_ns")
    buf = (ctypes.c_ulonglong * 16)()
    runs = []
    for _ in range(LAUNCHES):
        fn()
        torch.cuda.synchronize()
        if read(buf) != 0:
            raise RuntimeError(f"{name}: reading the phase clock failed")
        t = list(buf)
        runs.append([(t[i + 1] - t[i]) / 1e3 for i in range(len(PHASES))])
    return {p: statistics.median(r[i] for r in runs)
            for i, p in enumerate(PHASES)}


def main():
    if not torch.cuda.is_available():
        sys.exit("bwd_phases: needs a CUDA card")
    instrumented()
    dev = torch.device("cuda")
    idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, 100), 3)
    idx = torch.as_tensor(idx, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    gen = torch.Generator().manual_seed(0)
    Wg, Wl = [tuple(w.detach() for w in GNNLayer(128, 25, 1, gen).to(dev)
                    .weights()) for _ in "gl"]
    W1 = tuple(w.detach() for w in GNNLayer(128, 25, 1, gen, True, True)
               .to(dev).weights())
    rng = np.random.default_rng(0)
    rand = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32,
                                   device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else torch.cuda.get_device_name(0))
    print("cooperative grid: mp_pair_bwd %d blocks, mp_layer_bwd %d" % (
        mp_layer.bwd_grid_blocks("mp_pair_bwd"),
        mp_layer.bwd_grid_blocks("mp_layer_bwd", True)))
    for B in (16, 48):
        args = (rand(B, 100, 128), rand(B, 100, 25), rand(B, 100, 1),
                rand(B, 100, 1), idx, mask)
        g = rand(B, 100, 128)
        runs = (
            ("mp_pair_bwd",
             lambda: mp_pair.fused_gated_pair_bwd_kernel(*args, Wg, Wl, g)),
            ("mp_layer_bwd",
             lambda: mp_layer.fused_mp_layer_bwd_kernel(*args, W1, g, True,
                                                        True)))
        for name, fn in runs:
            us = phase_us(name, fn)
            print(f"{name} batch {B}: " + " ".join(
                f"{p} {t:.1f}" for p, t in us.items())
                + f" | sum {sum(us.values()):.1f} us")


if __name__ == "__main__":
    main()
