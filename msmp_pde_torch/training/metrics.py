"""Evaluation metrics (counterpart of msmp_pde_tpu/training/metrics.py):
one-step losses, unrolled rollout losses, and the paper's space-time L2 /
relative-L2 norms.

Each metric loops over batches of ``batch_size`` samples (the last may be
short) under ``torch.inference_mode``; each batch's rollout is an eager
loop of ``Trainer.forward`` calls, so on the card a forward runs the
LEM-scan kernel and the message-passing forward kernels without stash (a
grid model's forward runs torch ops alone).

Averages follow the JAX package: a one-step or unrolled loss is averaged
over the batches' values, each batch's value divided by its own size, so
a short last batch weighs as much as a full one. The L2 norms are the
mean over samples (the JAX package raises where a short last batch
follows full ones; wherever it returns, the two agree).

In a process group (parallel/mesh.py) the batches are split across the
ranks, batch i on rank i mod world size, and their values gathered back
in batch order on every rank (``_per_batch``): every reduction then runs
on the single process's values, so the metrics equal its own, the short
last batch's weight included.

RPU's interpolated route (``compute_l2_norms_u``,
``interp_rollout_to_unstructured``): a model rolled out on the uniform
grid of the interpolated files is measured on the unstructured grid, its
predictions interpolated back (ops/interp.py::interp1d).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from msmp_pde_torch.data.graph import advance_windows, slice_windows
from msmp_pde_torch.parallel import mesh


def _per_batch(one_fn, u_args, var_all, batch_size: int):
    """[one_fn(*u_batch, variables) for each batch], in order; in a
    process group each rank runs its share of the batches and gets every
    batch's value, tensors on the inputs' device."""
    n = int(u_args[0].shape[0])
    starts = range(0, n, batch_size)
    share = (lambda i: i % mesh.world_size() == mesh.rank()) \
        if mesh.active() else (lambda i: True)
    outs = {}
    with torch.inference_mode():
        for i, s in enumerate(starts):
            if share(i):
                sl = slice(s, min(s + batch_size, n))
                outs[i] = one_fn(*(a[sl] for a in u_args),
                                 {k: v[sl] for k, v in var_all.items()})
        if mesh.active():
            dev = u_args[0].device
            outs = {i: v.to(dev) if torch.is_tensor(v) else v
                    for i, v in mesh.gather_in_order(outs).items()}
    return [outs[i] for i in range(len(starts))]


def _full(u_traj, value):
    return torch.full((u_traj.shape[0],), value, dtype=torch.int64,
                      device=u_traj.device)


def test_timestep_losses(trainer, u_all, var_all, batch_size: int,
                         t_res: int, log=print):
    """One-step losses at every multiple of tw; {step: mean loss}."""
    tw = trainer.tw
    step_vals = [s for s in range(tw, t_res - tw + 1)
                 if s == tw or s % tw == 0]

    def one(u_traj, variables):
        out = []
        for s in step_vals:
            steps = _full(u_traj, s)
            window, labels = slice_windows(u_traj, steps, tw)
            pred, _ = trainer.forward(window, steps, variables)
            out.append(torch.sum((pred - labels) ** 2) / u_traj.shape[0])
        return torch.stack(out)

    losses = _per_batch(one, (u_all,), var_all, batch_size)
    per_step = torch.stack(losses).mean(dim=0).cpu().numpy()
    results = {}
    for s, l in zip(step_vals, per_step):
        results[s] = float(l)
        log(f"Step {s}, mean loss {float(l)}")
    return results


def _rollout_collect(trainer, u_traj, variables, nr_gt_steps: int,
                     t_res: int, max_windows: int = 0):
    """The rollout from ``tw * nr_gt_steps``, feeding predictions back;
    (preds, labels) stacked [S, B, nx, d*tw]. ``max_windows`` > 0 stops
    after that many windows."""
    tw = trainer.tw
    steps = _full(u_traj, tw * nr_gt_steps)
    window, labels = slice_windows(u_traj, steps, tw)
    pred, state = trainer.forward(window, steps, variables)
    preds, labs = [pred], [labels]
    step_vals = list(range(tw * (nr_gt_steps + 1), t_res - tw + 1, tw))
    if max_windows:
        step_vals = step_vals[:max_windows - 1]
    for _ in step_vals:
        steps = steps + tw
        window = advance_windows(window, pred, trainer.d, tw)
        _, labels = slice_windows(u_traj, steps, tw)
        pred, state = trainer.forward(window, steps, variables,
                                      lem_state=state)
        preds.append(pred)
        labs.append(labels)
    return torch.stack(preds), torch.stack(labs)


def test_unrolled_losses(trainer, u_all, u_base_all, var_all,
                         batch_size: int, nr_gt_steps: int, t_res: int,
                         nx_base: int, log=print):
    """Unrolled forward loss and the numerical baseline's loss (u_base
    against the down-projected u_super); returns (mean loss, mean base
    loss), the first the validation metric."""
    tw = trainer.tw

    def one(u_traj, u_base, variables):
        bsz = u_traj.shape[0]
        preds, labs = _rollout_collect(trainer, u_traj, variables,
                                       nr_gt_steps, t_res)
        loss = torch.sum((preds - labs) ** 2) / nx_base / bsz
        base = []
        for step in range(tw * nr_gt_steps, t_res - tw + 1, tw):
            steps = _full(u_traj, step)
            _, lab_s = slice_windows(u_traj, steps, tw)
            _, lab_b = slice_windows(u_base, steps, tw)
            base.append(torch.sum((lab_s - lab_b) ** 2) / nx_base / bsz)
        return torch.stack([loss, torch.sum(torch.stack(base))])

    out = torch.stack(_per_batch(one, (u_all, u_base_all), var_all,
                                 batch_size)).mean(dim=0).cpu().numpy()
    mean_loss, mean_base = float(out[0]), float(out[1])
    log(f"Unrolled forward losses {mean_loss}")
    log(f"Unrolled forward base losses {mean_base}")
    return mean_loss, mean_base


def _to_trajectory(stack, d: int, tw: int):
    """[S, B, nx, d*tw] -> [B, S*tw, d, nx]."""
    S, B, nx, _ = stack.shape
    a = stack.reshape(S, B, nx, d, tw)
    return a.permute(1, 0, 4, 3, 2).reshape(B, S * tw, d, nx)


def rollout_store(trainer, u_all, var_all, batch_size: int,
                  nr_gt_steps: int, t_res: int, n_more_rollout: int = 0):
    """Stacked rollout predictions and targets, numpy [N, T, d, nx] with
    T = rollout windows * tw + n_more_rollout * tw. Beyond the data
    horizon the model keeps feeding its own prediction back with the time
    feature frozen at the last window; the targets there are zeros."""
    tw, d = trainer.tw, trainer.d

    def one(u_traj, variables):
        preds, labs = _rollout_collect(trainer, u_traj, variables,
                                       nr_gt_steps, t_res)
        p, t = _to_trajectory(preds, d, tw), _to_trajectory(labs, d, tw)
        if n_more_rollout > 0:
            last_step = _full(u_traj, t_res - tw)
            window, extra = preds[-1], []
            for _ in range(n_more_rollout):
                window, _ = trainer.forward(window, last_step, variables)
                extra.append(window)
            e = _to_trajectory(torch.stack(extra), d, tw)
            p = torch.cat([p, e], dim=1)
            t = torch.cat([t, torch.zeros_like(e)], dim=1)
        return p.cpu().numpy(), t.cpu().numpy()

    outs = _per_batch(one, (u_all,), var_all, batch_size)
    return (np.concatenate([p for p, _ in outs]),
            np.concatenate([t for _, t in outs]))


def compute_space_l2_norms(preds: np.ndarray, trues: np.ndarray):
    """Per-timestep L2 / relative L2 curves; inputs [N, T, d, nx], returns
    ([T], [T])."""
    sq_err = np.sum((preds - trues) ** 2, axis=2)  # [N, T, nx]
    sq_norm = np.sum(trues**2, axis=2)
    l = np.sqrt(np.mean(sq_err, axis=2)).mean(axis=0)
    m = np.sqrt(np.mean(sq_norm, axis=2)).mean(axis=0)
    return l, l / m


def l2_norms_from_store(preds: np.ndarray, trues: np.ndarray,
                        log=print) -> Tuple[float, float]:
    """Space-time L2 / relative L2 from a rollout store ([N, T, d, nx]
    pairs as ``rollout_store`` returns), without rolling the model again."""
    sq_err = np.sum((np.asarray(preds) - np.asarray(trues)) ** 2, axis=2)
    sq_norm = np.sum(np.asarray(trues) ** 2, axis=2)
    l = float(np.sqrt(np.mean(sq_err, axis=(1, 2))).mean())
    m = float(np.sqrt(np.mean(sq_norm, axis=(1, 2))).mean())
    log(f"L2 error {l}")
    log(f"L2 relative error {100 * l / m} %")
    return l, l / m


def interp_rollout_to_unstructured(preds, x_uniform, x_unstructured,
                                   device):
    """Rollout predictions [N, T, d, nx_u] on the uniform grid
    ``x_uniform`` interpolated onto ``x_unstructured`` [nx_r] (edges
    clamped), on ``device``; numpy [N, T, d, nx_r] in the predictions'
    dtype."""
    from msmp_pde_torch.ops.interp import interp1d

    preds = np.asarray(preds)
    flat = torch.as_tensor(preds.reshape(-1, preds.shape[-1]), device=device)
    xu = torch.as_tensor(np.asarray(x_uniform), device=device)
    xr = torch.as_tensor(np.asarray(x_unstructured), device=device)
    onto = interp1d(xu[None], flat, xr[None])
    return onto.cpu().numpy().reshape(preds.shape[:-1] + (xr.shape[0],))


def compute_l2_norms_u(trainer, u_uniform, var_all, u_unstructured,
                       x_uniform, x_unstructured, batch_size: int,
                       nr_gt_steps: int, t_res: int, log=print, preds=None):
    """RPU's like-for-like metric: the rollout on the uniform-grid
    (interpolated) data ``u_uniform``, each prediction interpolated back
    onto the unstructured grid, against the unstructured ground truth
    ``u_unstructured`` [N, nt, d, nx_r] over the same steps; the
    space-time L2 and relative L2 as ``l2_norms_from_store`` reduces them
    (numpy, the predictions' dtype). ``preds``: the horizon's rollout
    store [N, T, d, nx_u] where the caller holds it already."""
    if preds is None:
        preds, _ = rollout_store(trainer, u_uniform, var_all, batch_size,
                                 nr_gt_steps, t_res)
    T = preds.shape[1]
    start = trainer.tw * nr_gt_steps
    trues = np.asarray(u_unstructured)[:, start:start + T]
    preds_u = interp_rollout_to_unstructured(preds, x_uniform,
                                             x_unstructured, trainer.device)
    return l2_norms_from_store(preds_u, trues, log=log)


def compute_l2_norms(trainer, u_all, var_all, batch_size: int,
                     nr_gt_steps: int, t_res: int, log=print,
                     max_windows: int = 0) -> Tuple[float, float]:
    """Space-time L2 and relative L2 over the rollout, the paper's metric:
    per sample sqrt(mean over (t, x) of the squared error summed over the
    components), averaged over samples, and the same of the targets; the
    relative L2 is the ratio of the two averages. ``max_windows`` > 0
    truncates the rollout to its first windows."""
    tw, d = trainer.tw, trainer.d

    def one(u_traj, variables):
        preds, labs = _rollout_collect(trainer, u_traj, variables,
                                       nr_gt_steps, t_res,
                                       max_windows=max_windows)
        p, t = _to_trajectory(preds, d, tw), _to_trajectory(labs, d, tw)
        l = torch.sqrt(torch.mean(torch.sum((p - t) ** 2, dim=2),
                                  dim=(1, 2)))
        m = torch.sqrt(torch.mean(torch.sum(t ** 2, dim=2), dim=(1, 2)))
        return torch.stack([l, m])

    lm = torch.cat(_per_batch(one, (u_all,), var_all, batch_size), dim=1)
    l_mean, m_mean = (float(v) for v in lm.mean(dim=1).cpu())
    rel = l_mean / m_mean
    log(f"L2 error {l_mean}")
    log(f"L2 relative error {100 * rel} %")
    return l_mean, rel
