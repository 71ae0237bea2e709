"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size (benchmark/limits/<workload>.json):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ...
        [--control_seeds 1 2 3] [--out readings.json]

For each seed: the numbers that the cell's check compares, of the program
(the lower reading); for each control seed, the same numbers of the
control, the plain reference with TF32 products put in the program's
place (the upper reading), and of each fault of benchmark/faults.py
planted in the program. A training cell's readings need no window: its
check compares the steps of set-up. A serving cell's run the cell's own
load for ``--seconds`` and check the same sample a run does. One process
reads every seed, on one card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def train_readings(cell, seed, device, fault=None):
    from benchmark import faults
    from benchmark.kinds import train

    state = train.setup(cell, seed, device, faults.TRAIN.get(fault))
    got = train.program_readings(state)
    ref = train.reference_readings(state)
    out = {"program" if fault is None else fault:
           train.numbers(got, ref, detail=True)}
    if fault is None:
        ctrl = train.reference_readings(state, "tf32")
        out["control"] = train.numbers(ctrl, ref, detail=True)
    return out


def serve_readings(cell, seed, device, seconds, fault=None):
    import torch

    from benchmark import faults, harness
    from benchmark.kinds import serve
    from benchmark.reference.mpsolver import Precision

    state = serve.setup(cell, seed, device, faults.SERVE.get(fault))
    win = serve.window(state, seconds, harness.Spans(), False)
    out = {"program" if fault is None else fault: serve.check(state, win),
           "requests": win["attempted"]}
    if fault is None:
        cfg, tr, arch = cell.config, cell.traffic, cell.arch
        graph = arch.Graph(cfg, device)
        t_grid = arch.time_grid(cfg, device)
        gap = 0.0
        with torch.no_grad():
            for idx, _ in state["sampled"]:
                inputs = state["pool"][idx]
                ans = serve.control_answers(
                    arch, cfg, state["weights"], graph, t_grid, inputs,
                    tr["n_windows"], tr["start_step"], Precision("tf32"))
                gap = max(gap, serve.window_gaps(
                    arch, cfg, state["weights"], graph, t_grid, inputs, ans,
                    tr["start_step"], Precision("float32")))
        out["control"] = {"window_gap": gap}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import faults, harness

    cell = harness.cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["cudnn_allow_tf32"])
    if args.device == "cuda":
        harness.build_kernels()
    kind = cell.traffic["kind"]
    fault_names = faults.TRAIN if kind == "train" else faults.SERVE
    rows = []
    for seed in args.seeds:
        with_faults = seed in args.control_seeds
        for fault in [None] + (list(fault_names) if with_faults else []):
            t0 = time.perf_counter()
            if kind == "train":
                r = train_readings(cell, seed, args.device, fault)
            else:
                r = serve_readings(cell, seed, args.device, args.seconds,
                                   fault)
            if fault is None and not with_faults:
                r.pop("control", None)
            r.update(seed=seed, seconds=time.perf_counter() - t0)
            rows.append(r)
            print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
