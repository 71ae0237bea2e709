"""The benchmark of msmp_pde_torch, the PyTorch and CUDA port, on NVIDIA
cards. Run from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is a workload of BENCHMARK.json. Set-up (imports, CUDA, the
kernels' build at the first run in a checkout, weights and data made on
the card from ``--seed``, warm-up) is timed from the process's start; then
the cell's work runs for ``--seconds``, and the plain reference checks
what it produced. With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
torch.profiler trace of a shorter window (the traffic's
``trace_seconds``). The last line of standard output is the result as one
JSON object; the numbers compared, each with its limit, are the last lines
of standard error. Exits non-zero, printing no result, without enough
CUDA cards, where the program is missing, or where the process holds JAX
or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402

# One core of the host for the whole process, chosen before any thread
# starts (each inherits it): the port's host path runs one thread at a time
# (the main thread, or autograd's device thread while it waits), so one
# core suffices, and no hand-offs between cores add to the spread of the
# host's times (PERF.md section 2).
os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this directory, heads the path: benchmark/trace.py
# would otherwise stand in for the standard library's trace module
sys.path[0] = str(ROOT)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    from benchmark import harness

    cell = harness.cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"set-up: torch and CUDA at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    harness.build_kernels()
    print(f"set-up: kernels built at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    result, _ = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"the process holds {foreign}; the benchmark may not load JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
