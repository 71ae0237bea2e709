"""Card and host time of a model's rollouts and train step.

    python3 -m msmp_pde_torch.tools.model_times [--model MSGMP-PDE]
        [--mp_precision bfloat16]
    PYTHONPATH=<another checkout> python3 <this file> [--model ...]
        # that checkout's

Builds ``--model`` (default MSGMP-PDE) on E1's uniform grid, RP's for a
2-D model (a name with ``2D``: the graph models, BaseCNN2D, FNO2D and
FNO2DP) and E3's for FNOP (E1's grid shape, with its three equation
variables), at full width (nx 100, tw 25, six layers or pairs, or the
grid models' widths, its own random initialization from seed 0) with the
``msmp_pde_torch`` on the path, and prints, after the card's name and power
limit, what ``time_rollouts`` and ``time_train_steps`` measure (rollouts at
buckets 1, 4 and 16; a train step at batch 16 of ``smooth`` trajectories).
The step's time is the larger of the card's and the host's. Needs a CUDA
card. Of the port it uses only modules that older checkouts have too
(``kernels_us`` takes its ``calls`` from the grid models' slice on), so
that one checkout's copy times another's kernels and host path.
``chip_smoke.py`` times its models through the same functions.
``--mp_precision`` (bfloat16, bfloat16s) builds the graph model's
message-passing layers in that mode; float32 passes no keyword, which
older checkouts do not take.
"""
import argparse
import sys
import time

import numpy as np
import torch

from msmp_pde_torch.serving.engine import RolloutEngine, build_serving_trainer
from msmp_pde_torch.tools.lem_times import card, kernels_us
from msmp_pde_torch.training.setup import build_trainer

BUCKETS = (1, 4, 16)
N_WINDOWS = 8
BATCH = 16
STEPS = 5    # steps a round of CUDA events
# steps torch.profiler traces for the card's busy time a step: its
# host-side processing takes seconds a step of a few hundred ops
PROFILE_STEPS = 5
REQUESTS = 100  # rollout requests a bucket: p90 has 10 beyond it


def smooth(n, t_grid, x, L, seed):
    """[n, nt, nx] float32: four Fourier modes a trajectory with amplitudes
    ~1/k and phases drifting with t, from a numpy seed."""
    rng = np.random.default_rng(seed)
    t, xs = t_grid[None, :, None, None], x[None, None, :, None]
    k = np.arange(1, 5)[None, None, None, :]
    amp = rng.uniform(0.5, 1.0, (n, 1, 1, 4)) / k
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 1, 4))
    speed = rng.uniform(-1.0, 1.0, (n, 1, 1, 4))
    u = amp * np.sin(2 * np.pi * k * xs / L + phase + speed * k * t)
    return u.sum(-1).astype(np.float32)


def train_data(trainer, n, seed):
    """(u_all, var_all) on the trainer's device: ``smooth`` trajectories
    [n, nt, nx], or [n, nt, 2, nx] from two seeds for a 2-D model, and one
    value a sample of each equation variable, U(0.1, 1) (float32)."""
    spec = trainer.spec
    t, x = spec.t_grid.cpu().numpy(), spec.x.cpu().numpy()
    u = np.stack([smooth(n, t, x, spec.L, seed + c)
                  for c in range(trainer.d)], axis=2)
    u = u[:, :, 0] if trainer.d == 1 else u
    rng = np.random.default_rng(seed)
    var = {k: torch.tensor(rng.uniform(0.1, 1.0, n), dtype=torch.float32,
                           device=trainer.device) for k in trainer.eq_norms}
    return torch.as_tensor(u, device=trainer.device), var


def time_rollouts(engine, name, requests=REQUESTS):
    """Closed-loop rollout latency of ``engine`` at each of BUCKETS:
    ``requests`` requests of N_WINDOWS windows after one warm-up, the
    host's clock around each (a request ends in a copy to the host); p50,
    p90 and sample-windows/s at p50."""
    nx, tw = engine.trainer.spec.nx, engine.trainer.tw
    dtw = getattr(engine.trainer, "d", 1) * tw
    for B in BUCKETS:
        w = np.random.default_rng(B).normal(size=(B, nx, dtw)).astype(
            np.float32)
        engine.rollout(w, n_windows=N_WINDOWS)  # warm-up
        lats = []
        for _ in range(requests):
            t0 = time.perf_counter()
            engine.rollout(w, n_windows=N_WINDOWS)
            lats.append((time.perf_counter() - t0) * 1e3)
        p50, p90 = np.percentile(lats, [50, 90])
        print(f"{name} rollout bucket {B} x {N_WINDOWS} windows, closed "
              f"loop, {requests} requests: p50 {p50:.3f} ms, p90 "
              f"{p90:.3f} ms, {B * N_WINDOWS / p50 * 1e3:.1f} "
              "sample-windows/s at p50")


def time_train_steps(trainer, u_all, name, var_all=None):
    """One AdamW step at batch BATCH of ``u_all`` (with ``var_all``, the
    equation variables) on the card, unrolled 0
    and 1: CUDA events around STEPS steps (median of 5 rounds), the host's
    time to enqueue a step from an idle card, and the card's busy time a
    step: the sum of its kernels' device time from torch.profiler over
    PROFILE_STEPS steps ("not measured" where the trace holds none)."""
    dev = u_all.device
    tx = trainer.make_optimizer(1e-4, 0.4, [1, 5, 10, 15], 250)
    idx = torch.arange(BATCH, device=dev)
    st = torch.full((BATCH,), 100, dtype=torch.int64, device=dev)
    for unrolled in (0, 1):
        step = trainer.train_step_fn(tx, unrolled)
        run = lambda: step(u_all, var_all or {}, idx, st)  # noqa: E731
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(STEPS):
                run()
            b.record()
            torch.cuda.synchronize()
            rounds.append(a.elapsed_time(b) / STEPS)
        t0 = time.perf_counter()
        for _ in range(STEPS):
            run()
        host = (time.perf_counter() - t0) / STEPS * 1e3
        torch.cuda.synchronize()
        ks = kernels_us(run, PROFILE_STEPS)  # a mean over the steps
        busy = (f"{sum(us for _, us in ks) / 1e3:.3f} ms ({len(ks)} "
                f"kernels, over {PROFILE_STEPS} steps)" if ks
                else "not measured")
        ms = float(np.median(rounds))
        print(f"{name} train step @batch {BATCH} unrolled={unrolled}: "
              f"{ms:.3f} ms (CUDA events), {BATCH / ms * 1e3:.1f} "
              f"samples/s, host enqueue {host:.3f} ms, card busy {busy}")


def experiment_of(model: str) -> str:
    """The experiment whose uniform grid times ``model``."""
    if "2D" in model:
        return "RP"
    return "E3" if model == "FNOP" else "E1"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="MSGMP-PDE")
    ap.add_argument("--requests", type=int, default=REQUESTS)
    ap.add_argument("--mp_precision", default="float32",
                    choices=["float32", "bfloat16", "bfloat16s"])
    args = ap.parse_args(argv)
    kw = ({} if args.mp_precision == "float32"
          else {"mp_precision": args.mp_precision})
    if not torch.cuda.is_available():
        sys.exit("model_times: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card())
    import msmp_pde_torch
    print(f"msmp_pde_torch from {msmp_pde_torch.__file__}")
    experiment = experiment_of(args.model)
    engine = RolloutEngine(build_serving_trainer(experiment, args.model,
                                                 device="cuda", **kw),
                           batch_buckets=BUCKETS)
    time_rollouts(engine, args.model, args.requests)
    trainer = build_trainer(experiment, args.model, device="cuda", **kw)
    u_all, var_all = train_data(trainer, BATCH, seed=0)
    time_train_steps(trainer, u_all, args.model, var_all)


if __name__ == "__main__":
    main()
