"""Per-phase device times of the four message-passing kernels.

    python3 -m msmp_pde_torch.tools.bwd_phases

First times, with the plain builds, an empty launch of each forward
(batch 0: every phase has no items, so the launch is its grid-wide barriers
and the launch itself): CUDA events around 200 launches. Then builds
``csrc/mp_pair_fwd.cu``, ``csrc/mp_layer_fwd.cu``, ``csrc/mp_pair_bwd.cu``
and ``csrc/mp_layer_bwd.cu`` with ``-DMP_PHASE_TIMES`` into
``build/torch_kernels_phases/``: block 0 then reads the card's clock after
every grid-wide barrier (two barriers more than the plain build, at the
start and the end). Runs each kernel through its wrapper at E1's shapes
(nx 100, radius graph with K 6, hidden 128, tw 25, one variable) with
weights and inputs from a seed: the forwards at batches 0, 1 and 16 (the
pair's without the stash, the layer's GNN_Layer), the backwards at 16 and
48. Prints the median over 20 launches of each phase's microseconds (the
phase letters of ``csrc/mp_phases.cuh``; a forward's phases are A-E), the
cooperative grids, and the card's name and power limit. Needs a CUDA card.
"""
import ctypes
import statistics
import sys

import numpy as np
import torch

from msmp_pde_torch.data.graph import build_neighbors_radius
from msmp_pde_torch.models.gnn import GNNLayer
from msmp_pde_torch.ops import _build, mp_layer, mp_pair
from msmp_pde_torch.tools.lem_times import card, seeded

FWD_PHASES = ("A", "A2", "B", "B2", "C", "D", "E")
BWD_PHASES = FWD_PHASES + ("F", "G", "H", "I", "J", "K")
KERNELS = ("mp_pair_fwd", "mp_layer_fwd", "mp_pair_bwd", "mp_layer_bwd")
LAUNCHES = 20


def instrumented():
    """Build the four kernels with the phase clock, in parallel, and load
    them in place of the plain builds."""
    out = _build.BUILD_DIR.parent / "torch_kernels_phases"
    _build.build_variants(KERNELS, out, ("-DMP_PHASE_TIMES",))
    for name in KERNELS:
        _build.use(name, out / f"lib{name}.so")


def phase_us(name, fn, phases):
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
        runs.append([(t[i + 1] - t[i]) / 1e3 for i in range(len(phases))])
    return {p: statistics.median(r[i] for r in runs)
            for i, p in enumerate(phases)}


def launch_us(fn, reps=200):
    """Mean microseconds a launch of fn over reps launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps * 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("bwd_phases: needs a CUDA card")
    dev = torch.device("cuda")
    idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, 100), 3)
    idx = torch.as_tensor(idx, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    gen = torch.Generator().manual_seed(0)
    Wg, Wl = [tuple(w.detach() for w in GNNLayer(128, 25, 1, gen).to(dev)
                    .weights()) for _ in "gl"]
    W1 = tuple(w.detach() for w in GNNLayer(128, 25, 1, gen, True, True)
               .to(dev).weights())
    rand = seeded(0, dev)
    print(card())
    print("cooperative grid (blocks): " + ", ".join(
        f"{n} {mp_layer.grid_blocks(n, n.startswith('mp_layer'))}"
        for n in KERNELS))

    def inputs(B):
        return (rand(B, 100, 128), rand(B, 100, 25), rand(B, 100, 1),
                rand(B, 100, 1), idx, mask)

    def forwards(args):
        return (("mp_pair_fwd",
                 lambda: mp_pair.fused_gated_pair_kernel(*args, Wg, Wl)),
                ("mp_layer_fwd",
                 lambda: mp_layer.fused_mp_layer_kernel(*args, W1, True,
                                                        True)))

    with torch.no_grad():
        for name, fn in forwards(inputs(0)):
            print(f"{name} empty launch (batch 0, plain build): "
                  f"{launch_us(fn):.2f} us")
        instrumented()
        for B in (0, 1, 16):
            for name, fn in forwards(inputs(B)):
                us = phase_us(name, fn, FWD_PHASES)
                print(f"{name} batch {B}: " + " ".join(
                    f"{p} {t:.1f}" for p, t in us.items())
                    + f" | sum {sum(us.values()):.1f} us")
    for B in (16, 48):
        args = inputs(B)
        g = rand(B, 100, 128)
        runs = (
            ("mp_pair_bwd",
             lambda: mp_pair.fused_gated_pair_bwd_kernel(*args, Wg, Wl, g)),
            ("mp_layer_bwd",
             lambda: mp_layer.fused_mp_layer_bwd_kernel(*args, W1, g, True,
                                                        True)))
        for name, fn in runs:
            us = phase_us(name, fn, BWD_PHASES)
            print(f"{name} batch {B}: " + " ".join(
                f"{p} {t:.1f}" for p, t in us.items())
                + f" | sum {sum(us.values()):.1f} us")


if __name__ == "__main__":
    main()
