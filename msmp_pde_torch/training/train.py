"""Training CLI (counterpart of msmp_pde_tpu/training/train.py):

    python -m msmp_pde_torch.training.train --experiment=E1 \
        --model=MSMP-PDE --time_window=25 [--device=cuda ...]

Flow: read the datasets (``--data_dir``, the port's ``.npz`` or an
``.h5``), build the static graph and the model (weights random from
``--seed``), AdamW with the epoch-milestone schedule, then per epoch:
t_res shuffled passes with the pushforward trick, validation (one-step
and unrolled losses), and where the validation loss improves: the test
losses, the space-time L2 norms and a best-val checkpoint
(utils/checkpoint.py, with the optimizer's state for ``--resume``).

``--experiment`` is E1, E2, E3, kdv, WE1, WE2, WE3, KF or KS (1-D), or
RP, MSWG or MSWG3 (the two-component advection system, with the 2-D
models). ``--model`` is one
of the 26 ported registry names (models/registry.py::PORTED): the nine
1-D graph models and their ten 2-D versions (MP-PDE2D ... LSTM2D), the
1-D grid models BaseCNN, FNO, FNOP (the equation variables of E2 or E3)
and VNO, and the 2-D BaseCNN2D, FNO2D and FNO2DP (a and b); FNO2DPU
raises. ``--device`` is cuda by default and raises without it.
``--mp_precision`` bfloat16 or bfloat16s runs the
message-passing kernels with bf16 operands (ops/mp_layer.py);
``--mp_remat`` runs each layer's float32 math in torch ops under
``torch.utils.checkpoint`` instead of the kernels. cuDNN's TF32 stays at
PyTorch's default (on) for the convolutions, as for every CLI of the
port.

Data parallelism: ``torchrun --nproc_per_node N -m
msmp_pde_torch.training.train ...`` runs N ranks, one a card
(parallel/mesh.py), each step split over them and its gradients summed
(training/loop.py), the metrics' batches split over them
(training/metrics.py). ``--dp 0`` takes the world size; another ``--dp``
must equal it. The batch size must be a multiple of the world size (the
JAX CLI takes the gcd instead). Rank 0 prints and writes the checkpoints;
every rank reads ``--resume``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from datetime import datetime

import numpy as np
import torch

MODES = ("train", "valid", "test")


def device_arrays(ds, device):
    """(u_super, u_base, variables) of a ``PDEDataset`` on ``device``."""
    u = torch.as_tensor(ds.u_super, device=device)
    ub = torch.as_tensor(ds.u_base, device=device)
    var = {k: torch.as_tensor(v.astype(np.float32), device=device)
           for k, v in ds.variables.items()}
    return u, ub, var


# the entry points whose argv a watchdog re-exec may replay; fit()
# embedded in any other process must not re-exec that host with its
# unrelated argv (the watchdog stays off there)
_CLI_MODULES = ("msmp_pde_torch.training.train",
                "msmp_pde_torch.training.cv")


def _running_as_cli() -> bool:
    import __main__

    spec = getattr(__main__, "__spec__", None)
    if spec is not None and spec.name in _CLI_MODULES:
        return True
    # launched by file path (python .../train.py): __spec__ is None but
    # argv replay is equally safe, _stall_recovery re-execs sys.argv[0]
    if spec is None and os.path.basename(sys.argv[0]) in ("train.py",
                                                          "cv.py"):
        return True
    return os.environ.get("MSMP_WATCHDOG_FORCE", "") == "1"


def _stall_recovery(args, save_path: str):
    """Watchdog action: re-exec this CLI, resuming from the last best-val
    checkpoint where one exists (a checkpoint file is always complete,
    utils/checkpoint.py), else from the start. In a process group a rank
    re-exec'd alone could not rejoin it: the rank exits non-zero instead,
    saying so, and the launcher (torchrun) ends the group."""
    import __main__

    from msmp_pde_torch.parallel import mesh

    spec = getattr(__main__, "__spec__", None)
    head = ["-m", spec.name] if spec is not None else [sys.argv[0]]

    def action():
        if mesh.active():
            print(f"watchdog: rank {mesh.rank()} stalled; exiting with "
                  f"status 75 (a rank cannot be re-exec'd into its group; "
                  f"resume from {save_path} with --resume)", file=sys.stderr)
            sys.stderr.flush()
            os._exit(75)
        argv = _recovery_argv(
            sys.argv[1:],
            resume=save_path if os.path.isfile(save_path) else None)
        sys.stdout.flush()
        sys.stderr.flush()
        os.execv(sys.executable, [sys.executable] + head + argv)

    return action


def _recovery_argv(argv_in, resume=None):
    """Original CLI args with any --resume stripped; re-append the new one."""
    argv, skip = [], False
    for tok in argv_in:
        if skip:
            skip = False
            continue
        if tok == "--resume":
            skip = True
            continue
        if tok.startswith("--resume="):
            continue
        argv.append(tok)
    if resume is not None:
        argv += ["--resume", resume]
    return argv


def fit(args, exp, data, save_path: str):
    """The epoch loop; ``data`` maps mode -> (u_super, u_base, variables)
    on the trainer's device. Returns the JAX package's results dict (valid_L2, valid_rel_L2,
    test_L2, test_rel_L2, min_val_loss, test_loss) plus ``history``: a
    dict an epoch with its losses [t_res, n_batches], mean train loss,
    validation loss and the seconds of its passes and of its metrics. In
    a process group every rank runs it and gets the same results; rank 0
    prints and writes the checkpoint."""
    from msmp_pde_torch.parallel import mesh

    check_dp(args)
    with mesh.rank0_stdout():
        return _fit(args, exp, data, save_path)


def check_dp(args, batch: bool = True):
    """``--dp`` against the process group: 0 takes the world size, any
    other must equal it; with ``batch`` the batch size must be a multiple
    of it (a train step splits every batch)."""
    from msmp_pde_torch.parallel import mesh

    world = mesh.world_size()
    dp = getattr(args, "dp", 0) or world
    if dp != world:
        raise ValueError(
            f"--dp {dp} needs {dp} processes, one a device: launch with "
            f"torchrun --nproc_per_node {dp} (this process group has "
            f"{world})")
    if batch and args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} is not a multiple "
                         f"of the world size {world}")


def _fit(args, exp, data, save_path: str):
    from msmp_pde_torch.parallel import mesh
    from msmp_pde_torch.training import metrics
    from msmp_pde_torch.training.loop import train_epoch
    from msmp_pde_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from msmp_pde_torch.utils.watchdog import Watchdog

    trainer = exp.trainer
    t_res = exp.t_res
    nx_base = args.base_resolution[1]
    if mesh.active():
        print(f"Data parallelism over {mesh.world_size()} processes "
              f"({args.batch_size // mesh.world_size()} samples of each "
              "batch a rank)")
    u_train, _, var_train = data["train"]
    u_valid, ub_valid, var_valid = data["valid"]
    u_test, ub_test, var_test = data["test"]

    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"Number of parameters: {n_params}")
    n_batches = max(1, int(u_train.shape[0]) // args.batch_size)
    tx = trainer.make_optimizer(
        args.lr, args.lr_decay,
        milestones=(list(args.milestones) if args.milestones is not None
                    else [args.unrolling, 5, 10, 15]),
        steps_per_epoch=t_res * n_batches,
    )
    start_epoch = 0
    if getattr(args, "resume", None):
        start_epoch = restore_checkpoint(args.resume, trainer.model, tx) + 1
        print(f"Resumed from {args.resume} at epoch {start_epoch}")
    # one set of weights on every rank (each built them from --seed)
    mesh.broadcast_params(trainer.model)
    rng = np.random.default_rng(args.seed)

    # stall watchdog (utils/watchdog.py), armed only when this process is
    # the train CLI (its recovery replays sys.argv); MSMP_WATCHDOG_S=0
    # disables it
    wd_stall = (float(os.environ.get("MSMP_WATCHDOG_S", "1800"))
                if _running_as_cli() else 0.0)
    wd = Watchdog(wd_stall, _stall_recovery(args, save_path)).start()

    def log_beat(*a, **k):
        wd.beat()
        print(*a, **k)

    def l2(u, var, **kw):
        return metrics.compute_l2_norms(trainer, u, var, args.batch_size,
                                        args.nr_gt_steps, t_res, **kw)

    shw = getattr(args, "short_horizon_windows", 0)
    min_val_loss = 1e30
    test_loss = 1e30
    results = {"history": []}
    for epoch in range(start_epoch, args.num_epochs):
        print(f"Epoch {epoch}")
        t0 = time.perf_counter()
        train_loss, losses = train_epoch(
            trainer, tx, u_train, var_train, epoch, args.batch_size, t_res,
            args.unrolling, rng, print_interval=args.print_interval,
            log=log_beat, profile_dir=(args.profile if epoch == 0 else None))
        t1 = time.perf_counter()
        wd.beat()
        print("Evaluation on validation dataset:")
        metrics.test_timestep_losses(trainer, u_valid, var_valid,
                                     args.batch_size, t_res)
        wd.beat()
        val_loss, _ = metrics.test_unrolled_losses(
            trainer, u_valid, ub_valid, var_valid, args.batch_size,
            args.nr_gt_steps, t_res, nx_base)
        wd.beat()
        if shw:
            # the pre-divergence metric of chaotic tasks: rel-L2 over only
            # the first windows, beside the full horizon's
            print(f"*Valid short-horizon rel-L2 (first {shw} windows)*")
            l2(u_valid, var_valid, max_windows=shw, log=log_beat)
        improved = val_loss < min_val_loss
        if improved:
            print("Evaluation on test dataset:")
            metrics.test_timestep_losses(trainer, u_test, var_test,
                                         args.batch_size, t_res)
            wd.beat()
            test_loss, _ = metrics.test_unrolled_losses(
                trainer, u_test, ub_test, var_test, args.batch_size,
                args.nr_gt_steps, t_res, nx_base)
            wd.beat()
            print("**Dimensionless L2 errors**")
            print("*Valid*")
            results["valid_L2"], results["valid_rel_L2"] = l2(u_valid,
                                                              var_valid)
            print("*Test*")
            results["test_L2"], results["test_rel_L2"] = l2(u_test, var_test)
            if shw:
                print(f"*Test short-horizon rel-L2 (first {shw} windows)*")
                results["test_L2_short"], results["test_rel_L2_short"] = l2(
                    u_test, var_test, max_windows=shw)
            if mesh.rank() == 0:
                save_checkpoint(save_path, trainer.model, tx, epoch)
            print(f"Saved model at {save_path}\n")
            min_val_loss = val_loss
        wd.beat()
        results["history"].append(dict(
            epoch=epoch, losses=losses, train_loss=train_loss,
            val_loss=val_loss, improved=improved, train_s=t1 - t0,
            metric_s=time.perf_counter() - t1))

    wd.stop()
    print(f"Min Val loss: {min_val_loss}")
    print(f"Test loss: {test_loss}")
    print("**Dimensionless L2 errors**")
    print(f"Min Val L2 Error: {results.get('valid_L2')}")
    print(f"Min Relative Val L2 Error: {100 * results.get('valid_rel_L2', 0)} %")
    print(f"Test L2 Error: {results.get('test_L2')}")
    print(f"Relative Test L2 Error: {100 * results.get('test_rel_L2', 0)} %")
    results["min_val_loss"] = min_val_loss
    results["test_loss"] = test_loss
    return results


def main(args):
    from msmp_pde_torch.device import resolve_device
    from msmp_pde_torch.parallel import mesh
    from msmp_pde_torch.training.setup import setup_experiment

    mesh.init_distributed(args.device)
    mesh.wait_for_backend(args.device)
    dev = mesh.local_device(resolve_device(args.device))
    args.device = str(dev)
    check_dp(args)
    os.makedirs("models", exist_ok=True)
    os.makedirs("experiments/log", exist_ok=True)

    exp = setup_experiment(args, data_dir=args.data_dir)
    d = datetime.now()
    run_name = (
        f"{args.model}_{exp.pde}_{args.experiment}"
        f"_xresolution{args.base_resolution[1]}-{args.super_resolution[1]}"
        f"_n{args.neighbors}_tw{args.time_window}_unrolling{args.unrolling}"
        f"_time{d.month}{d.day}{d.hour}{d.minute}"
    )
    save_path = f"models/{run_name}.pt"
    data = {m: device_arrays(exp.datasets[m], dev) for m in MODES}
    with contextlib.ExitStack() as stack:
        if args.log:
            logfile = f"experiments/log/{run_name}.csv"
            print(f"Writing to log file {logfile}")
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(logfile, "w"))))
        print(f"Training on {args.data_dir}/{exp.pde}_{args.experiment}")
        print(save_path)
        return fit(args, exp, data, save_path)


def _flag(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected True or False, got {s!r}")


def _ints(s: str):
    return [int(i) for i in s.split(",")]


def build_parser():
    from msmp_pde_torch.models.registry import PORTED

    p = argparse.ArgumentParser(description="Train a neural PDE solver")
    p.add_argument("--experiment", type=str, default="")
    p.add_argument("--model", type=str, default="MP-PDE",
                   help="a ported registry name: " + ", ".join(PORTED))
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_decay", type=float, default=0.4)
    p.add_argument("--milestones", type=int, nargs="*", default=None,
                   help="epoch milestones of the learning-rate decay "
                        "(default [unrolling, 5, 10, 15])")
    p.add_argument("--parameter_ablation", type=_flag, default=False)
    p.add_argument("--base_resolution", type=_ints, default=[250, 100])
    p.add_argument("--super_resolution", type=_ints, default=[250, 200])
    p.add_argument("--neighbors", type=int, default=3)
    p.add_argument("--time_window", type=int, default=25)
    p.add_argument("--unrolling", type=int, default=1)
    p.add_argument("--nr_gt_steps", type=int, default=2)
    p.add_argument("--n_graph_layers", type=int, default=6)
    p.add_argument("--print_interval", type=int, default=20)
    p.add_argument("--short_horizon_windows", type=int, default=0,
                   help="also report rel-L2 over only the first N rollout "
                        "windows (the pre-divergence metric of chaotic "
                        "tasks)")
    p.add_argument("--log", type=_flag, default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without it) or cpu")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel processes: 0 takes the world size of "
                        "the torchrun group (1 without one); another must "
                        "equal it")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume training from")
    p.add_argument("--profile", type=str, default=None,
                   help="directory for a torch.profiler trace of pass 1 of "
                        "epoch 0")
    p.add_argument("--data_dir", type=str, default="data",
                   help="dataset directory")
    p.add_argument("--data_suffix", type=str, default="",
                   help="dataset filename suffix")
    p.add_argument("--mp_precision", type=str, default="float32",
                   choices=["float32", "bfloat16", "bfloat16s"],
                   help="the message-passing kernels' operand precision: "
                        "bfloat16 rounds every product's operands to bf16 "
                        "(float32 sums); bfloat16s also stores the layers' "
                        "inputs and weight matrices in bf16")
    p.add_argument("--mp_remat", action="store_true",
                   help="run each message-passing layer's float32 math as "
                        "torch ops under torch.utils.checkpoint, "
                        "recomputed in the backward, instead of the "
                        "kernels (float32 only)")
    return p


if __name__ == "__main__":
    ts = time.time()
    main(build_parser().parse_args())
    print(f"Elapsed Time : {time.time() - ts}")
