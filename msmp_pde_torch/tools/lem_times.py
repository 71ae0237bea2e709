"""Card and host time of the three LEM-scan kernels.

    python3 -m msmp_pde_torch.tools.lem_times [--hidden {96,128,164}]
    PYTHONPATH=<another checkout> python3 <this file> [--hidden ...]
        # that checkout's kernels

Runs ``lem_scan.lem_scan_kernel`` (without and with the stash) and
``lem_scan.lem_scan_bwd_kernel`` of the ``msmp_pde_torch`` on the path at
the LEM encoder's shapes (T 25, hidden 128 or ``--hidden``: 164 is
MSGMP-PDE's) over N = 100, 400 and 1600 rows (buckets 1, 4 and 16 of nx
100), with inputs from a seed. For each it prints three times a call, in
microseconds: CUDA events around 50 calls (median of 7 rounds), which read
the larger of the card's and the host's time; the host's time to enqueue
a call (perf_counter, from an idle card); and every kernel the call
launches with its own card time from torch.profiler (mean a call over 50
calls), or "not measured" where the profiler shows none; the backward's
launches are listed one by one. Also the card's name and power limit.
Needs a CUDA card.
Of the port it uses only ``ops.lem_scan``, ``ops._build`` and
``tools.fwd_times``, which older checkouts have too, so that one
checkout's copy times another's kernels.
"""
import argparse
import subprocess
import sys

import numpy as np
import torch

from msmp_pde_torch.ops import lem_scan
from msmp_pde_torch.tools.fwd_times import CALLS, events_us, host_us

T = 25
HIDDEN = (96, 128, 164)


def parse(argv, what):
    """--hidden (default 128, the LEM encoder's) from argv."""
    ap = argparse.ArgumentParser(description=what)
    ap.add_argument("--hidden", type=int, choices=HIDDEN, default=128)
    return ap.parse_args(argv)


def card():
    """The card's name and power limit as nvidia-smi gives them, or its
    name where nvidia-smi fails."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else torch.cuda.get_device_name(0))


def seeded(seed, device):
    """rand(*shape, scale=1.0): float32 normals on ``device`` from a numpy
    generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    return lambda *s, scale=1.0: torch.tensor(
        rng.normal(size=s) * scale, dtype=torch.float32, device=device)


def lem_args(rand, T, N, H):
    """gx, zx, y0, z0, Wy, Wzz of the LEM scan, from ``rand``."""
    return (rand(T, N, 3 * H), rand(T, N, H), rand(N, H, scale=.5),
            rand(N, H, scale=.5), rand(H, 3 * H, scale=H ** -.5),
            rand(H, H, scale=H ** -.5))


def kernels_us(fn, calls=CALLS):
    """[(kernel name, mean card microseconds a call)] over ``calls`` calls
    of fn, from torch.profiler, in the order of their total time; None
    where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:  # no CUPTI tracing on this machine
        print(f"torch.profiler: {e}")
        return None
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t:
            out.append((e.key, t / calls))
    return sorted(out, key=lambda kv: -kv[1]) or None


def short(name):
    """A kernel's name without its namespace and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").split("(")[0]
    return name.split("::")[-1].strip()


def main(argv=None):
    args = parse(argv, "Card and host time of the LEM-scan kernels")
    H = args.hidden
    if not torch.cuda.is_available():
        sys.exit("lem_times: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rand = seeded(0, torch.device("cuda"))
    print(card())
    print(f"msmp_pde_torch from {lem_scan.__file__}, T {T}, hidden {H}")
    for N in (100, 400, 1600):
        args = lem_args(rand, T, N, H)
        _, _, ys, zs = lem_scan.lem_scan_plain(*args, stash=True)
        bargs = (*args, ys, zs, rand(N, H), rand(N, H))
        runs = (("lem_fwd", lambda: lem_scan.lem_scan_kernel(*args)),
                ("lem_fwd_stash",
                 lambda: lem_scan.lem_scan_kernel(*args, stash=True)),
                ("lem_bwd", lambda: lem_scan.lem_scan_bwd_kernel(*bargs)))
        for name, fn in runs:
            ks = kernels_us(fn)
            own = (" + ".join(f"{short(k)} {us:.2f}" for k, us in ks)
                   + f" = {sum(us for _, us in ks):.2f} us"
                   if ks else "not measured")
            print(f"{name} N={N}: events {events_us(fn):.2f} us, host "
                  f"enqueue {host_us(fn):.2f} us, kernels {own}")


if __name__ == "__main__":
    main()
