"""Training loop: pushforward trick and temporal bundling (counterpart of
msmp_pde_tpu/training/loop.py), for graph and grid models.

One optimizer step slices the batch's windows from trajectories kept on
the device, rolls the model forward ``unrolled`` times under
``torch.no_grad`` (the pushforward), takes the loss
``sqrt(sum((pred - labels)**2))`` on the next window, backpropagates and
applies AdamW. On the card the forward with grad runs the stash variant
of the LEM-scan kernel and the fused-pair or single-layer forward kernels,
and the backward the matching backward kernels (the pair's through the
single-layer backward where its fused backward does not fit). A grid model
(CNN, FNO) runs no custom kernel: its convolutions, FFTs and products are
torch ops. The JAX package runs a whole pass as one jitted scan; here it
is a Python loop over eager steps.

Data parallelism (parallel/mesh.py): in a process group each rank takes
its contiguous slice of every batch (``dp_sharded_step``), and the step is
the single-process step of the whole batch. The JAX package's sharded
step computes sqrt(sum of squares) with the sum all-reduced inside the
square root, so its gradient is exactly the one-device gradient; here the
sum of squares is summed over the ranks differentiably (``global_sum``,
whose backward hands each rank the common cotangent of the sum) before
the square root, so each rank's backward gives its samples' part of the
global gradient, and the parts are summed (``sum_grads``), not averaged as
DistributedDataParallel would. The sum is the whole batch's sum in
another order, so the gradient is the single process's up to rounding; a
rank that averaged, or took the root of its own part, would be off by a
factor (and AdamW, dividing by the root of the second moment, would hide
a uniform factor).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from msmp_pde_torch.data.graph import (
    GraphSpec,
    advance_windows,
    slice_windows,
)
from msmp_pde_torch.models.common import assemble_variables
from msmp_pde_torch.models.registry import FNO_VARS
from msmp_pde_torch.parallel import mesh
from msmp_pde_torch import tracing


def make_var_fns(eq_norms: Dict[str, float], tmax: float):
    """The graph path's variable-vector builder: normalized time and the
    normalized equation parameters (beta negated). With ``b_reads_a`` (the
    2-D models) the b slot takes a's value, as the reference's 2-D models
    feed ``data.a`` into it (msmp_pde_tpu/training/loop.py:67-71); the
    quirk is kept on purpose."""

    def graph_vars(t, variables, b_reads_a: bool = False):
        if b_reads_a and "b" in eq_norms and "a" in variables:
            variables = dict(variables, b=variables["a"])
        return assemble_variables(t, variables, eq_norms, tmax)

    return graph_vars


def make_grid_vars(eq_norms: Dict[str, float]):
    """The grid path's variable columns: each raw equation variable of
    (alpha, beta, gamma, D, r, a, b) present in ``eq_norms`` over its
    norm, ``[B, n]``, or None where there is none. No time column, no beta
    negation, and b stays b (msmp_pde_tpu/training/loop.py:74-85)."""
    names = tuple(n for n in FNO_VARS if n in eq_norms)

    def grid_vars(variables):
        if not names:
            return None
        return torch.stack([variables[n] / eq_norms[n] for n in names],
                           dim=-1)

    return grid_vars


def window_to_grid(window, d: int, tw: int):
    """[B, nx, d*tw] (component-major) -> [B, tw, nx] or [B, tw, d, nx]."""
    if d == 1:
        return window.transpose(1, 2)
    B, nx, _ = window.shape
    return window.reshape(B, nx, d, tw).permute(0, 3, 2, 1)


def grid_to_window(grid, d: int, tw: int):
    """Inverse of ``window_to_grid``."""
    if d == 1:
        return grid.transpose(1, 2)
    B, nx = grid.shape[0], grid.shape[-1]
    return grid.permute(0, 3, 2, 1).reshape(B, nx, d * tw)


@dataclasses.dataclass
class Trainer:
    """One model on its grid: a graph model (kind "graph") on the spec's
    static graph, or a grid model (kind "grid") on the raw grid layout.
    ``model`` lives on the spec's device and holds the parameters a step
    updates in place."""

    model: torch.nn.Module
    kind: str
    spec: GraphSpec
    eq_norms: Dict[str, float]

    def __post_init__(self):
        self.tw = self.spec.tw
        self.d = self.spec.n_components
        self.graph_vars = make_var_fns(self.eq_norms, self.spec.tmax)
        self.grid_vars = make_grid_vars(self.eq_norms)
        self._steps = {}

    @property
    def device(self) -> torch.device:
        return self.spec.x.device

    def var_vec(self, steps, variables):
        """The model's variables [B, V] at label-window starts ``steps``."""
        return self.graph_vars(self.spec.t_grid[steps], variables,
                               b_reads_a=self.d == 2)

    def forward(self, window, steps, variables, lem_state=None):
        """window [B, nx, d*tw]; steps [B] label-window start indices (the
        time feature of a graph model); variables {name: [B]}. Returns
        (prediction [B, nx, d*tw], the LEM's new state or None); a grid
        model takes no state and returns None."""
        with tracing.span("model.forward"):
            if self.kind == "grid":
                grid = window_to_grid(window, self.d, self.tw)
                if getattr(self.model, "unstructured", False):
                    out = self.model(grid, self.grid_vars(variables),
                                     self.spec.x)
                else:
                    out = self.model(grid, self.grid_vars(variables))
                return grid_to_window(out, self.d, self.tw), None
            spec = self.spec
            pos_x = spec.x.expand(window.shape[0], spec.nx)
            return self.model(window, pos_x, spec.t_grid[steps],
                              self.var_vec(steps, variables), spec.idx,
                              spec.mask, lem_state=lem_state)

    # ------------------------------------------------------------ training
    def make_optimizer(self, lr: float, lr_decay: float, milestones,
                       steps_per_epoch: int):
        """(AdamW, per-step LambdaLR) on every parameter: optax's ``adamw``
        decays biases too, and its ``piecewise_constant_schedule`` scales
        the rate by ``lr_decay`` once the update count reaches each
        ``milestone * steps_per_epoch`` (train.py:410-411)."""
        bounds = sorted({int(m) * steps_per_epoch for m in milestones})
        opt = torch.optim.AdamW(self.model.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: lr_decay ** sum(count >= b for b in bounds))
        return opt, sched

    def step_loss(self, u_all, var_all, idx_batch, steps, unrolled: int,
                  forward: Optional[Callable] = None):
        """The loss of one batch after ``unrolled`` pushforward windows,
        with grad; ``forward`` (default ``self.forward``) maps (window,
        steps, variables, lem_state) -> (pred, lem_state). In a process
        group the batch is this rank's slice and the loss the whole
        batch's (the sum of squares summed over the ranks)."""
        forward = forward or self.forward
        tw = self.tw
        u_traj = u_all[idx_batch]
        variables = {k: v[idx_batch] for k, v in var_all.items()}
        window, _ = slice_windows(u_traj, steps, tw)
        state = None
        if unrolled:
            # no_grad, not inference_mode: these windows feed the grad
            # forward
            with torch.no_grad(), tracing.span("train.pushforward"):
                for _ in range(unrolled):
                    pred, state = forward(window, steps, variables,
                                          lem_state=state)
                    window = advance_windows(window, pred, self.d, tw)
                    steps = steps + tw
        with tracing.span("train.loss"):
            _, labels = slice_windows(u_traj, steps, tw)
            pred, _ = forward(window, steps, variables, lem_state=state)
            return torch.sqrt(
                mesh.global_sum(torch.sum((pred - labels) ** 2)))

    def _one_step(self, tx, unrolled: int):
        """The single optimizer step for a pushforward depth:
        step(u_all, var_all, idx_batch, steps) -> loss (a 0-d tensor on the
        device; the parameters and ``tx``'s state update in place). In a
        process group each rank runs its slice of the batch and the
        gradients are summed over the ranks before AdamW. Its spans
        (tracing.py): ``train.step`` around it all, ``train.backward``
        around the backward, and ``train.optimizer`` twice: around
        ``zero_grad``, and around AdamW's step with the schedule's."""
        opt, sched = tx

        def step(u_all, var_all, idx_batch, steps):
            with tracing.span("train.step", id=tracing.NEW):
                loss = self.step_loss(u_all, var_all, idx_batch, steps,
                                      unrolled)
                with tracing.span("train.optimizer"):
                    opt.zero_grad(set_to_none=True)
                with tracing.span("train.backward"):
                    loss.backward()
                mesh.sum_grads(self.model.parameters())
                with tracing.span("train.optimizer"):
                    opt.step()
                    sched.step()
                return loss.detach()

        return mesh.dp_sharded_step(step)

    def train_step_fn(self, tx, unrolled: int):
        """The step for a given pushforward depth, built once per (tx,
        depth)."""
        key = (id(tx), unrolled)
        if key not in self._steps:
            # the value keeps tx alive, so its id() is not reused
            self._steps[key] = (tx, self._one_step(tx, unrolled))
        return self._steps[key][1]


def train_epoch(trainer: Trainer, tx, u_all, var_all, epoch: int,
                batch_size: int, t_res: int, unrolling: int,
                rng: np.random.Generator, print_interval: int = 20,
                log=print, on_step: Optional[Callable] = None,
                profile_dir: Optional[str] = None):
    """One reference epoch: t_res passes over the shuffled loader
    (train.py:233-244 + train_helper.py:89-147), drawing from ``rng`` in
    the JAX package's order (a permutation, then one unroll flag per batch,
    then the start steps per flag), so that one seed draws the same batches
    there and here. ``on_step(flag)`` runs after each step. With
    ``profile_dir`` the second pass is traced with ``torch.profiler`` into
    ``profile_dir/pass1.json`` (the JAX package traces the same pass).
    Returns (mean loss / batch_size, the losses [t_res, n_batches] as
    numpy)."""
    tw = trainer.tw
    dev = trainer.device
    n = int(u_all.shape[0])
    batch_size = min(batch_size, n)
    n_batches = max(1, n // batch_size)
    max_unrolling = min(epoch, unrolling)
    unroll_choices = list(range(max_unrolling + 1))
    losses = []
    prof = None
    for i in range(t_res):
        if profile_dir and i == 1:
            prof = _start_profile(dev)
        if prof is not None and i == 2:
            _stop_profile(prof, profile_dir, log)
            prof = None
        perm = rng.permutation(n)[: n_batches * batch_size]
        perm = perm.reshape(n_batches, batch_size)
        flags = [int(rng.choice(unroll_choices)) for _ in range(n_batches)]
        steps = np.stack([
            rng.integers(tw, t_res - tw - tw * f + 1, size=batch_size)
            for f in flags])
        perm_d = torch.as_tensor(perm, device=dev)
        steps_d = torch.as_tensor(steps, device=dev)
        pass_losses = []
        for b, f in enumerate(flags):
            fn = trainer.train_step_fn(tx, f)
            pass_losses.append(fn(u_all, var_all, perm_d[b], steps_d[b]))
            if on_step is not None:
                on_step(f)
        losses.append(torch.stack(pass_losses))
        if i % print_interval == 0:
            recent = float(losses[-1].mean())
            log(f"Training Loss (progress: {i / t_res:.2f}): "
                f"{recent / batch_size}")
    if prof is not None:
        _stop_profile(prof, profile_dir, log)
    losses = torch.stack(losses).cpu().numpy()
    return float(losses.mean()) / batch_size, losses


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, log):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "pass1.json")
    prof.export_chrome_trace(path)
    log(f"Profiler trace written to {path}")
