"""Card and host time of the two message-passing forward kernels.

    python3 -m msmp_pde_torch.tools.fwd_times [--mp_precision bfloat16]
    PYTHONPATH=<another checkout> python3 <this file>  # that checkout's

Runs ``mp_pair.fused_gated_pair_kernel`` and
``mp_layer.fused_mp_layer_kernel`` (GNN_Layer) of the ``msmp_pde_torch``
on the path at E1's shapes (nx 100, radius graph with K 6, hidden 128, tw
25, one variable) with weights and inputs from a seed, at buckets 1, 4 and
16. For each it prints three times a call, in microseconds: CUDA events
around 50 calls (median of 7 rounds), which read the larger of the card's
and the host's time; the host's time to enqueue a call (perf_counter, from
an idle card); and the kernel's own time on the card from torch.profiler
(mean over 50 launches), or "not measured" where the profiler shows none.
Also the card's name and power limit. ``--mp_precision`` (bfloat16,
bfloat16s) runs the kernels in that mode. Needs a CUDA card. In float32
it uses only what every version of the port has, so that one checkout's
copy times another's kernels.
"""
import argparse
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from msmp_pde_torch.data.graph import build_neighbors_radius
from msmp_pde_torch.models.gnn import GNNLayer
from msmp_pde_torch.ops import mp_layer, mp_pair

CALLS = 50


def events_us(fn, rounds=7):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CALLS):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / CALLS * 1e3)
    return statistics.median(out)


def host_us(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / CALLS * 1e6


def kernel_us(fn, kernel):
    """Mean device time of the launches of ``kernel`` (a substring of its
    name) over CALLS calls of fn, from torch.profiler; None where the trace
    holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:  # no CUPTI tracing on this machine
        print(f"torch.profiler: {e}")
        return None
    total = count = 0
    for e in prof.key_averages():
        if kernel in e.key:
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            total += t
            count += e.count
    return total / count if count and total else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mp_precision", default="float32",
                    choices=["float32", "bfloat16", "bfloat16s"])
    mode = ap.parse_args(argv).mp_precision
    # the keyword only off float32, which older checkouts do not take
    kw = {} if mode == "float32" else {"mp_precision": mode}
    if not torch.cuda.is_available():
        sys.exit("fwd_times: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
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
    print(f"msmp_pde_torch from {mp_pair.__file__}; mp_precision {mode}")
    with torch.no_grad():
        for B in (1, 4, 16):
            args = (rand(B, 100, 128), rand(B, 100, 25), rand(B, 100, 1),
                    rand(B, 100, 1), idx, mask)
            runs = (
                ("mp_pair_fwd",
                 lambda: mp_pair.fused_gated_pair_kernel(*args, Wg, Wl,
                                                         **kw)),
                ("mp_layer_fwd",
                 lambda: mp_layer.fused_mp_layer_kernel(*args, W1, True,
                                                        True, **kw)))
            for name, fn in runs:
                k = kernel_us(fn, f"{name}_kernel")
                print(f"{name} bucket {B}: events {events_us(fn):.2f} us, "
                      f"host enqueue {host_us(fn):.2f} us, kernel "
                      + (f"{k:.2f} us" if k else "not measured"))


if __name__ == "__main__":
    main()
