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

Two routes run a step, chosen by what the trainer can observe
(``Trainer.graphed``), with no switch:

- on the card outside a process group, a CUDA graph a pushforward depth
  (``GraphedStep``): the first call warms the step up eagerly on a side
  stream, puts the state back as it was, captures one whole step (the
  batch's gather, the pushforward, the loss, the backward, AdamW's update)
  and replays it; every later call copies its row indices and start steps
  into the graph's own buffers and replays, so the host enqueues one graph
  a step instead of some hundred kernels, their wrappers and autograd's
  walk. The same kernels run in the same order. A graph freezes every
  number it was captured with, so AdamW is built ``capturable`` (its step
  count on the card) and fused, with its rate a tensor on the card, which
  the schedule fills between replays (``make_optimizer``);
- on the CPU and in a process group, the eager step (``Trainer._one_step``),
  whose gradients are all-reduced between the backward and AdamW.
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
from msmp_pde_torch.ops import mp_layer
from msmp_pde_torch.parallel import mesh
from msmp_pde_torch import graphs, tracing

captures = 0  # CUDA graphs captured (GraphedStep) since the last reset
replays = 0   # steps run as a replay of one


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

    def __getstate__(self):
        # a copy builds its own steps: a captured graph and its stream do
        # not copy
        return dict(self.__dict__, _steps={})

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
    def graphed(self) -> bool:
        """Whether a step runs as a CUDA graph: on the card, outside a
        process group (whose step all-reduces the gradients eagerly)."""
        return self.device.type == "cuda" and not mesh.active()

    def make_optimizer(self, lr: float, lr_decay: float, milestones,
                       steps_per_epoch: int):
        """(AdamW, per-step LambdaLR) on every parameter: optax's ``adamw``
        decays biases too, and its ``piecewise_constant_schedule`` scales
        the rate by ``lr_decay`` once the update count reaches each
        ``milestone * steps_per_epoch`` (train.py:410-411).

        Where the step runs as a CUDA graph (``graphed``) AdamW is
        ``capturable``: its step count lives on the card, and its rate is a
        0-d float32 tensor there, which ``LambdaLR`` fills in place (its
        base rate stays a number) between replays; a graph would otherwise
        replay the count and rate it was captured with. It is also
        ``fused``, one kernel for the update of every parameter: the
        capturable multi-tensor update divides each parameter's moments by
        its own 0-d bias corrections in broadcast kernels, two a parameter
        (PERF.md section 6). A checkpoint stores the rate as a number and
        loads into either route (``_keep_route``).
        """
        graphed = self.graphed()
        bounds = sorted({int(m) * steps_per_epoch for m in milestones})
        opt = torch.optim.AdamW(self.model.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01, capturable=graphed,
                                fused=graphed or None)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: lr_decay ** sum(count >= b for b in bounds))
        _keep_route(self, opt, graphed)
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
        """The eager optimizer step for a pushforward depth, the route of
        the CPU and of a process group (the tests hold the graphed route
        to it on the card): step(u_all, var_all, idx_batch, steps) -> loss
        (a 0-d tensor on the device; the parameters and ``tx``'s state
        update in place). In a process group each rank runs its slice of
        the batch and the gradients are summed over the ranks before AdamW.
        Its spans (tracing.py): ``train.step`` around it all,
        ``train.backward`` around the backward, and ``train.optimizer``
        twice: around ``zero_grad``, and around AdamW's step with the
        schedule's."""
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
        depth, route): a ``GraphedStep`` where ``graphed``, else the eager
        ``_one_step``. Both take (u_all, var_all, idx_batch, steps) and
        return the step's loss, a 0-d tensor of its own."""
        graphed = self.graphed()
        key = (id(tx), unrolled, graphed)
        if key not in self._steps:
            # the value keeps tx alive, so its id() is not reused
            self._steps[key] = (tx, GraphedStep(self, tx, unrolled)
                                if graphed else self._one_step(tx, unrolled))
        return self._steps[key][1]


def _keep_route(trainer: Trainer, opt, graphed: bool):
    """Puts ``opt`` on its route: on the graphed one its rate becomes a 0-d
    float32 tensor on the card. Hooks keep it there: a state dict holds
    the rate as a number, and a loaded one is put back on the route (its
    ``capturable`` and ``fused`` flags, the rate's form, AdamW's step
    counts on the card) and drops the graphs captured on ``opt``, which
    hold the tensors that the load replaced."""
    dev = trainer.device

    def put():
        for g in opt.param_groups:
            g["capturable"] = graphed
            g["fused"], g["foreach"] = graphed or None, None
            g["lr"] = (torch.tensor(float(g["lr"]), dtype=torch.float32,
                                    device=dev) if graphed
                       else float(g["lr"]))
        if graphed:
            for st in opt.state.values():
                if torch.is_tensor(st.get("step")):
                    st["step"] = st["step"].to(dev, torch.float32)

    def saved(_, state):
        for g in state["param_groups"]:
            g["lr"] = float(g["lr"])
        return state

    def loaded(_):
        put()
        for tx, fn in trainer._steps.values():
            if tx[0] is opt and isinstance(fn, GraphedStep):
                fn.reset()

    put()
    opt.register_state_dict_post_hook(saved)
    opt.register_load_state_dict_post_hook(loaded)


class GraphedStep:
    """One optimizer step of a pushforward depth as a CUDA graph, replayed
    on each call: (u_all, var_all, idx_batch, steps) -> loss, as the eager
    step (``Trainer._one_step``).

    A call whose inputs differ from the capture's in the identity, address
    or shape of ``u_all`` or of a ``var_all`` tensor, or in the batch
    size, captures anew (``capture``) before it replays, so the first call
    is a replay too. Each replay copies ``idx_batch`` and ``steps`` into
    the graph's buffers on the stream, replays, adds the launches one
    captured step made to the kernels' counters (``ops.LAUNCH_COUNTERS``),
    steps the schedule (which fills AdamW's rate for the next replay) and
    returns a copy of the graph's loss, so the losses a caller keeps do not
    alias.
    The graph holds the step's gradients: the parameters' ``.grad`` stays
    None. The live graphs of a trainer share one memory pool and capture
    stream: they replay in turn on one stream. Spans:
    ``train.step`` around a call, ``train.replay`` around the replay,
    ``train.capture`` around a capture."""

    WARMUP = 2  # eager steps on the side stream before a capture

    def __init__(self, trainer: Trainer, tx, unrolled: int):
        self.trainer, self.tx, self.unrolled = trainer, tx, unrolled
        self.stream = None
        self.reset()

    def reset(self):
        """Drops the graph, so the next call captures anew."""
        self.key = self.graph = self.loss = None
        self.idx = self.steps = None
        self.deltas, self.kept = {}, ()

    @staticmethod
    def key_of(u_all, var_all, idx_batch, steps):
        def ident(t):
            return id(t), t.data_ptr(), tuple(t.shape), t.dtype

        return (ident(u_all),
                tuple((k, ident(v)) for k, v in sorted(var_all.items())),
                tuple(idx_batch.shape), idx_batch.dtype, tuple(steps.shape),
                steps.dtype)

    def __call__(self, u_all, var_all, idx_batch, steps):
        global replays
        with tracing.span("train.step", id=tracing.NEW):
            dev = self.trainer.device
            idx_batch = torch.as_tensor(idx_batch, device=dev)
            steps = torch.as_tensor(steps, device=dev)
            key = self.key_of(u_all, var_all, idx_batch, steps)
            if key != self.key:
                self.capture(u_all, var_all, idx_batch, steps)
            self.idx.copy_(idx_batch)
            self.steps.copy_(steps)
            graphs.replay(self.graph, self.deltas, "train.replay")
            replays += 1
            self.tx[1].step()
            return self.loss.clone()

    def _body(self, u_all, var_all):
        """The captured part of a step: the loss, the backward, AdamW."""
        tr, opt = self.trainer, self.tx[0]
        loss = tr.step_loss(u_all, var_all, self.idx, self.steps,
                            self.unrolled)
        loss.backward()
        opt.step()
        return loss.detach()

    def capture(self, u_all, var_all, idx_batch, steps):
        """Warms the step up (``_warm_up``), then captures one step on the
        side stream. The schedule is not stepped, and the launch counters
        end where they began: the state after a capture is the state before
        it. Raises where the step cannot be captured."""
        global captures
        tr, (opt, _) = self.trainer, self.tx
        for g in opt.param_groups:
            if not (g.get("capturable") and torch.is_tensor(g["lr"])
                    and g["lr"].is_cuda):
                raise ValueError(
                    "a CUDA graph of the step needs the optimizer of "
                    "Trainer.make_optimizer on the card (AdamW capturable, "
                    "its rate a tensor on the card)")
        with tracing.span("train.capture"):
            self.reset()
            dev = tr.device
            self.idx = torch.empty(idx_batch.shape, dtype=idx_batch.dtype,
                                   device=dev)
            self.steps = torch.empty(steps.shape, dtype=steps.dtype,
                                     device=dev)
            self.idx.copy_(idx_batch)
            self.steps.copy_(steps)
            # the trainer's live graphs share a pool and its stream (the
            # allocator reuses a block on the stream it was made on)
            live = [fn for _, fn in tr._steps.values()
                    if isinstance(fn, GraphedStep) and fn.graph is not None]
            if live:
                self.stream = live[0].stream
            elif self.stream is None:
                self.stream = torch.cuda.Stream(device=dev)
            self._warm_up(u_all, var_all)
            try:
                graph, loss, self.deltas = graphs.capture(
                    lambda: self._body(u_all, var_all), self.stream,
                    live[0].graph.pool() if live else None,
                    f"{type(tr.model).__name__}: the training step at "
                    f"pushforward depth {self.unrolled}",
                    hint="Where an autograd graph of an earlier forward "
                    "through the parameters is alive (a loss kept, say), "
                    "free it before the first step: it ties their gradient "
                    "accumulators to the stream it ran on.")
            finally:
                # the graph keeps the gradients it made
                opt.zero_grad(set_to_none=True)
            # the graph reads the backwards' inverse neighbour lists from
            # their memo, which may drop them
            self.kept = list(mp_layer._inverse_memo.values())
            self.graph, self.loss = graph, loss
            self.key = self.key_of(u_all, var_all, idx_batch, steps)
            captures += 1

    def _warm_up(self, u_all, var_all):
        """``WARMUP`` eager steps on the side stream (the kernels' builds
        and one-time checks, the inverse neighbour lists, AdamW's state,
        cuBLAS's workspace, cuDNN's and cuFFT's plans), then the weights,
        buffers, AdamW's state and the launch counters put back as they
        were."""
        tr, opt = self.trainer, self.tx[0]
        saved = _snapshot(tr.model, opt)

        def step():
            opt.zero_grad(set_to_none=True)
            self._body(u_all, var_all)

        try:
            graphs.warm_up(step, self.stream, self.WARMUP)
        finally:
            _restore(tr.model, opt, saved)
            opt.zero_grad(set_to_none=True)


def _snapshot(model, opt):
    """Copies of the model's parameters and buffers and of AdamW's state."""
    tensors = [t.detach().clone()
               for t in list(model.parameters()) + list(model.buffers())]
    state = {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
             for p, st in opt.state.items()}
    return tensors, state


def _restore(model, opt, saved):
    """Puts ``_snapshot``'s copies back in place; AdamW's state made since
    (the warm-up's first step) is zeroed, as AdamW makes it fresh."""
    tensors, state = saved
    with torch.no_grad():
        for t, s in zip(list(model.parameters()) + list(model.buffers()),
                        tensors):
            t.copy_(s)
        for p, st in opt.state.items():
            old = state.get(p, {})
            for k, v in st.items():
                if not torch.is_tensor(v):
                    continue
                if k in old:
                    v.copy_(old[k])
                else:
                    v.zero_()


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
