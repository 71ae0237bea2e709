"""Cross-validation CLI (counterpart of msmp_pde_tpu/training/cv.py):

    python -m msmp_pde_torch.training.cv --experiment=MSWG3 \
        --model=MSMP-PDE2D --rep=0 [--cv_folder=cvMSWG3] [--device=cuda]

Merges the train, valid and test sets of one experiment, permutes them
with ``np.random.default_rng(seed + rep)`` and re-splits them 1024/128/128
(proportionally where there are fewer samples), then trains with the train
CLI's ``fit``, the checkpoint saved under ``--cv_folder`` (default
``cvMSWG3``, the reference's folder) with the replicate in its name.
Under ``torchrun --nproc_per_node N`` it trains on N ranks as the train
CLI does (``--dp`` 0 or N); rank 0 prints and writes.
"""
from __future__ import annotations

import contextlib
import os
import time
from datetime import datetime

import numpy as np

CV_SPLIT = (1024, 128, 128)
MODES = ("train", "valid", "test")


def split_indices(n_total: int, seed: int, rep: int):
    """The (train, valid, test) sample indices of ``n_total`` merged
    samples (msmp_pde_tpu/training/cv.py:51-61)."""
    want = sum(CV_SPLIT)
    perm = np.random.default_rng(seed + rep).permutation(n_total)
    if n_total < want:
        n_tr = int(n_total * CV_SPLIT[0] / want)
        n_va = max(1, int(n_total * CV_SPLIT[1] / want))
        splits = (n_tr, n_va, n_total - n_tr - n_va)
    else:
        splits = CV_SPLIT
    return np.split(perm[:sum(splits)], np.cumsum(splits)[:-1])


def main(args):
    from msmp_pde_torch.device import resolve_device
    from msmp_pde_torch.parallel import mesh
    from msmp_pde_torch.training.train import check_dp

    mesh.init_distributed(args.device)
    mesh.wait_for_backend(args.device)
    dev = mesh.local_device(resolve_device(args.device))
    args.device = str(dev)
    check_dp(args)
    with mesh.rank0_stdout():
        return _main(args, dev)


def _main(args, dev):
    import torch

    from msmp_pde_torch.training.setup import setup_experiment
    from msmp_pde_torch.training.train import fit

    os.makedirs(args.cv_folder, exist_ok=True)
    exp = setup_experiment(args, data_dir=args.data_dir)
    ds = [exp.datasets[m] for m in MODES]
    u_super = np.concatenate([d.u_super for d in ds])
    u_base = np.concatenate([d.u_base for d in ds])
    variables = {k: np.concatenate([d.variables[k] for d in ds])
                 for k in ds[0].variables}
    data = {}
    for mode, idx in zip(MODES, split_indices(len(u_super), args.seed,
                                              args.rep)):
        data[mode] = (
            torch.as_tensor(u_super[idx], device=dev),
            torch.as_tensor(u_base[idx], device=dev),
            {k: torch.as_tensor(v[idx].astype(np.float32), device=dev)
             for k, v in variables.items()})
        print(f"CV {mode}: {len(idx)} samples")

    d = datetime.now()
    run_name = (
        f"{args.model}_{exp.pde}_{args.experiment}_rep{args.rep}"
        f"_n{args.neighbors}_tw{args.time_window}_unrolling{args.unrolling}"
        f"_time{d.month}{d.day}{d.hour}{d.minute}"
    )
    save_path = f"{args.cv_folder}/{run_name}.pt"
    with contextlib.ExitStack() as stack:
        if args.log:
            os.makedirs("experiments/log", exist_ok=True)
            logfile = f"experiments/log/cv_{run_name}.csv"
            print(f"Writing to log file {logfile}")
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(logfile, "w"))))
        print(save_path)
        return fit(args, exp, data, save_path)


def build_parser():
    from msmp_pde_torch.training.train import build_parser as train_parser

    p = train_parser()
    p.description = "Cross-validate a neural PDE solver"
    p.add_argument("--rep", type=int, default=0, help="replicate index")
    p.add_argument("--cv_folder", type=str, default="cvMSWG3")
    return p


if __name__ == "__main__":
    ts = time.time()
    main(build_parser().parse_args())
    print(f"Elapsed Time : {time.time() - ts}")
