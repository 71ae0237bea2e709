"""Batched rollout engine for serving trained surrogates (counterpart of
msmp_pde_tpu/serving/engine.py).

Requests are padded up to the nearest batch bucket (oversize requests are
chunked over the largest), and the horizon runs as a loop of
``Trainer.forward`` calls under ``torch.inference_mode``, the windows
advancing by the pushforward rule (``data.graph.advance_windows``). On the
card each forward goes through the LEM-scan kernel once (LEM encoders) and
the fused gated-pair kernel once per pair (sigmoid-gated models) or the
single-layer kernel once per layer (ungated models) and twice a layer
(MSG2-PDE2D's gradient gate); the attention layers of GLEMGated2D are
plain torch ops; the twin-tower model (MSSMP-PDE) runs two such towers.
The 2-D models' windows advance per component. A grid model (CNN,
FNO) runs torch ops alone, on windows mapped to its grid layout by
``Trainer.forward``. The stateful model
(SaveMSMP-PDE) carries its LEM state from window to window, reset per
sample past the data horizon (``reset_past_horizon``).

The loop is ``RolloutProgram``, a module of tensors in and out for a fixed
number of windows, which serving/export.py exports: the eager path, the
graphed one and the exported one share one body. On the card the engine
replays it as a CUDA graph (``GraphedRollout``), one per (bucket,
n_windows, replica) captured on first use, so a request costs the card's
time and a handful of host calls instead of a launch per kernel; on the
CPU it calls it eagerly. ``devices`` holds one replica of the model on
each device (the JAX engine's ``mesh``); a bucket that their number
divides is split across them in order.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from msmp_pde_torch.data.graph import advance_windows
from msmp_pde_torch import graphs, tracing

captures = 0  # CUDA graphs of a rollout captured (GraphedRollout)
replays = 0   # program calls run as a replay of one


def grid_from_h5(path: str, pde, mode: str, base_resolution,
                 super_resolution):
    """Attrs-only read of the grid metadata (no trajectories are loaded)
    from a dataset file, the port's ``.npz`` or an ``.h5``, as
    ``PDEDataset`` reads it: the uniform grids (CE, KF, KS, AD) and RPU's
    LCG grid as stored at the base resolution, and WE's Chebyshev grid
    down-projected from ``super_resolution``'s x by the dataset's mean
    kernel."""
    from msmp_pde_torch.data.dataset import _mean_downproject
    from msmp_pde_torch.datagen.hdf5_io import open_dataset
    from msmp_pde_torch.training.setup import GridInfo

    family = f"{pde}"
    with open_dataset(path) as f:
        a = f.attrs("%s/pde_%d-%d" % (mode, *base_resolution))
        x = np.asarray(a["x"], np.float64)
        if family == "WE":
            x_super = np.asarray(
                f.attrs("%s/pde_%d-%d" % (mode, *super_resolution))["x"],
                np.float64)
            x = _mean_downproject(x_super[None],
                                  x_super.shape[-1] // x.shape[-1])[0]
    return GridInfo(x=x.astype(np.float32),
                    nt=int(a["nt"]), dt=float(a["dt"]),
                    tmin=float(a["tmin"]), tmax=float(a["tmax"]),
                    n_components=pde.n_components)


def build_serving_trainer(experiment: str, model: str, *,
                          data_path: Optional[str] = None,
                          super_resolution=(250, 200), **kw):
    """The trainer a server needs, from grid metadata alone: the uniform
    grid, or the test mode's of ``data_path`` (``grid_from_h5``), with
    training/setup.py::build_trainer's keywords. ``data_suffix="_I"``
    serves a checkpoint trained on the interpolated files: RPU on the
    uniform grid's radius stencil, as it trained. The model's weights are
    random from ``seed`` until a checkpoint is loaded. ``device`` defaults
    to CUDA and raises without it."""
    from msmp_pde_torch.training.setup import (
        build_trainer,
        pde_for_experiment,
    )

    if data_path is not None:
        base = tuple(kw.get("base_resolution", (250, 100)))
        kw["grid"] = grid_from_h5(data_path,
                                  pde_for_experiment(experiment, base),
                                  "test", base, tuple(super_resolution))
    trainer = build_trainer(experiment, model, **kw)
    trainer.model.eval()
    return trainer


def reset_past_horizon(state, steps, last: int):
    """The stateful (Save*) models' LEM state with the samples whose window
    starts past ``last`` = nt - tw set to zeros: beyond the data horizon
    the JAX package's long rollout calls the model without accumulated
    state (msmp_pde_tpu/serving/engine.py:196-211, metrics.rollout_store),
    and the LEM's default state is zeros."""
    keep = (steps <= last).reshape(-1, 1, 1)
    return tuple(torch.where(keep, x, torch.zeros_like(x)) for x in state)


class RolloutProgram(torch.nn.Module):
    """The rollout of ``n_windows`` windows as one module:
    forward(window [B, nx, d*tw] float32, steps [B] int64 label-window
    starts, variables {name: [B] float32}) -> predictions
    [B, n_windows, nx, d*tw]. Each window advances by the pushforward rule;
    the time feature freezes at the last in-horizon window (``clamp``) and
    a stateful model's state is zeroed per sample past it
    (``reset_past_horizon``, a ``where``): no branch depends on the data,
    so ``torch.export`` traces it whole. The model is a submodule, so an
    export carries its weights."""

    def __init__(self, trainer, n_windows: int):
        super().__init__()
        self.model = trainer.model
        self.trainer = trainer
        self.n_windows = int(n_windows)

    def forward(self, window, steps, variables: Dict[str, torch.Tensor]):
        trainer = self.trainer
        tw, d = trainer.tw, trainer.d
        nt = int(trainer.spec.t_grid.shape[0])
        preds, state = [], None
        for i in range(self.n_windows):
            if i:
                window = advance_windows(window, preds[-1], d, tw)
                steps = steps + tw
                if state is not None:
                    state = reset_past_horizon(state, steps, nt - tw)
            pred, state = trainer.forward(window,
                                          torch.clamp(steps, tw, nt - tw),
                                          variables, lem_state=state)
            preds.append(pred)
        return torch.stack(preds, dim=1)


class GraphedRollout:
    """The rollout program of one (bucket, n_windows, replica) as a CUDA
    graph: captured once from ``program`` (the engine's ``RolloutProgram``)
    on static input buffers, then replayed for each request.

    The capture goes through the module call ``program(*static inputs)``,
    so the graph holds whatever that call ran at capture time, a wrapper of
    ``program.forward`` installed before it included. The engine keys its
    graphs by bucket, n_windows and replica alone: a wrapper installed
    after the capture is never seen. Before the capture the program runs
    ``WARMUP`` times eagerly on the capture stream (graphs.py, as the
    training step's graph: the kernels' builds, cuDNN's and cuFFT's
    plans); neither leaves a launch counted. The static inputs live
    outside the graph's memory pool. The graphs of one replica share a
    pool (``peer``'s) and a capture stream, and replay in turn on the
    device's current stream, each one's output copied out (``fetch``)
    before another replays. Raises, naming the model, where the program
    cannot be captured.

    ``replay`` copies a request's padded numpy inputs into the static
    buffers, replays under the spans ``serve.program`` and ``serve.replay``
    and adds the captured program's launches to the kernels' counters
    (``ops.LAUNCH_COUNTERS``). ``fetch`` enqueues the copy of the output
    into a pinned host buffer and returns it; it holds the answer once
    ``done`` has completed, until the next ``fetch``."""

    WARMUP = 2  # eager calls on the capture stream before a capture

    def __init__(self, program: RolloutProgram, window, steps, variables,
                 peer: Optional["GraphedRollout"] = None):
        self.program = program
        dev = self.device = program.trainer.device
        self.window = torch.empty(window.shape, dtype=torch.float32,
                                  device=dev)
        self.steps = torch.empty(steps.shape, dtype=torch.int64, device=dev)
        self.variables = {k: torch.empty(v.shape, dtype=torch.float32,
                                         device=dev)
                          for k, v in variables.items()}
        self.fill(window, steps, variables)
        self.stream = (peer.stream if peer is not None
                       else torch.cuda.Stream(device=dev))
        with torch.cuda.device(dev):
            self._capture(peer)
        self.host = torch.empty(self.out.shape, dtype=self.out.dtype,
                                pin_memory=True)
        self.done = torch.cuda.Event()

    def fill(self, window, steps, variables):
        """Copies a request's numpy inputs into the static buffers."""
        self.window.copy_(torch.from_numpy(np.ascontiguousarray(window)))
        self.steps.copy_(torch.from_numpy(steps.astype(np.int64)))
        for k, v in variables.items():
            self.variables[k].copy_(
                torch.from_numpy(np.ascontiguousarray(v)))

    def _capture(self, peer):
        global captures
        prog = self.program
        args = (self.window, self.steps, self.variables)
        graphs.warm_up(lambda: prog(*args), self.stream, self.WARMUP)
        self.graph, self.out, self.deltas = graphs.capture(
            lambda: prog(*args), self.stream,
            peer.graph.pool() if peer is not None else None,
            f"{type(prog.model).__name__}: the rollout of "
            f"{prog.n_windows} windows at batch {self.window.shape[0]}")
        captures += 1

    def replay(self, window, steps, variables):
        global replays
        self.fill(window, steps, variables)
        with tracing.span("serve.program"):
            graphs.replay(self.graph, self.deltas, "serve.replay")
        replays += 1

    def fetch(self) -> torch.Tensor:
        self.host.copy_(self.out, non_blocking=True)
        self.done.record(torch.cuda.current_stream(self.device))
        return self.host


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device
    return (a.index if a.index is not None else current()) == (
        b.index if b.index is not None else current())


def replica(trainer, device):
    """``trainer`` on ``device``: itself where it is there already, else a
    copy of its model and graph moved there."""
    if _same_device(trainer.device, device):
        return trainer
    spec = trainer.spec
    spec = dataclasses.replace(spec, **{
        k: getattr(spec, k).to(device) for k in ("idx", "mask", "x",
                                                  "t_grid")})
    return dataclasses.replace(trainer, spec=spec,
                               model=copy.deepcopy(trainer.model).to(device))


class RolloutEngine:
    """Serve-many rollout over fixed batch buckets.

    ``rollout(window, ...)`` takes initial windows [B, nx, d*tw] and returns
    the autoregressive predictions [B, n_windows, nx, d*tw] as numpy. B is
    padded up to the nearest bucket; pad rows are dropped before returning.
    ``params``: optional state dict (utils/convert.py) loaded strictly into
    the trainer's model. ``devices``: the devices of the replicas (default
    the trainer's alone), the counterpart of the JAX engine's ``mesh``; a
    bucket their number divides is split into as many parts, part k on
    replica k, and the parts come back in order; any other bucket runs on
    the first replica.

    A replica on the card replays a ``GraphedRollout`` of the request's
    (bucket, n_windows, replica), captured on its first request
    (``graphs``); a replica on the CPU calls its program eagerly.
    """

    def __init__(self, trainer, params=None,
                 batch_buckets: Sequence[int] = (1, 4, 16), devices=None):
        model = trainer.model
        if params is not None:
            model.load_state_dict(params, strict=True)
        model.to(device=trainer.device, dtype=torch.float32).eval()
        self.replicas = [replica(trainer, d)
                         for d in (devices or [trainer.device])]
        self.trainer = self.replicas[0]
        self.buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        if not self.buckets:
            raise ValueError("need at least one batch bucket")
        self._programs = {}
        self.graphs: Dict[tuple, GraphedRollout] = {}

    @property
    def devices(self):
        return [tr.device for tr in self.replicas]

    def program(self, n_windows: int, part: int = 0) -> RolloutProgram:
        """The rollout program of ``n_windows`` on replica ``part``."""
        key = (int(n_windows), part)
        if key not in self._programs:
            self._programs[key] = RolloutProgram(self.replicas[part],
                                                 n_windows)
        return self._programs[key]

    def graphed(self, part: int) -> bool:
        """Whether replica ``part`` replays its rollouts as CUDA graphs:
        where it is on the card."""
        return self.replicas[part].device.type == "cuda"

    def _graph(self, bucket: int, n_windows: int, part: int, args):
        """The graph of (bucket, n_windows, part), captured from ``args``
        (numpy inputs) where there is none yet, sharing the pool and
        stream of the replica's other graphs."""
        key = (bucket, n_windows, part)
        g = self.graphs.get(key)
        if g is None:
            peer = next((h for (_, _, k), h in self.graphs.items()
                         if k == part), None)
            with tracing.span("serve.capture"):
                g = GraphedRollout(self.program(n_windows, part), *args,
                                   peer=peer)
            self.graphs[key] = g
        return g

    def _bucket_for(self, B: int) -> int:
        for b in self.buckets:
            if B <= b:
                return b
        return self.buckets[-1]  # oversize: the caller chunks over it

    def default_variables(self, B: int) -> Dict[str, np.ndarray]:
        return {k: np.zeros((B,), np.float32)
                for k in self.trainer.eq_norms}

    @torch.inference_mode()
    def _run(self, window, steps, variables, n_windows: int):
        B, n = window.shape[0], len(self.replicas)
        parts = n if n > 1 and B % n == 0 else 1
        rows = B // parts
        outs = []
        for k in range(parts):  # enqueue every part, then wait for each
            sl = slice(k * rows, (k + 1) * rows)
            args = (window[sl], steps[sl],
                    {name: v[sl] for name, v in variables.items()})
            if self.graphed(k):
                g = self._graph(B, n_windows, k, args)
                g.replay(*args)
                outs.append(g)
                continue
            dev = self.replicas[k].device
            args = (torch.as_tensor(args[0], device=dev),
                    torch.as_tensor(args[1], device=dev, dtype=torch.int64),
                    {name: torch.as_tensor(v, device=dev)
                     for name, v in args[2].items()})
            with tracing.span("serve.program"):
                outs.append(self.program(n_windows, k)(*args))
        with tracing.span("serve.answer"):
            host = [o.fetch() if isinstance(o, GraphedRollout) else o
                    for o in outs]
            for o in outs:
                if isinstance(o, GraphedRollout):
                    o.done.synchronize()
            return np.concatenate([h.numpy() for h in host])

    def rollout(self, window, variables: Optional[Dict] = None,
                start_step=None, n_windows: int = 1) -> np.ndarray:
        """``start_step``: scalar or per-sample [B] label-window start
        indices (the time-feature anchor); default ``tw``. Returns a
        fresh array, which no later request writes. Its spans
        (tracing.py): ``serve.rollout`` around the request, each
        chunk's nested in it with the request's id; ``serve.capture``
        around a capture of a graph; ``serve.program`` around each program
        call (the inputs' copies excluded), with ``serve.replay`` around
        the graph's launch on the card; ``serve.answer`` around the copy to
        the host, which waits for the card."""
        with tracing.span("serve.rollout", id=tracing.NEW):
            return self._rollout(window, variables, start_step, n_windows)

    def _rollout(self, window, variables, start_step, n_windows):
        trainer = self.trainer
        tw = trainer.tw
        window = np.asarray(window, np.float32)
        nx = int(trainer.spec.nx)
        dtw = trainer.d * tw
        if window.ndim != 3 or window.shape[1:] != (nx, dtw):
            raise ValueError(
                f"window must be [B, {nx}, {dtw}] for this engine "
                f"(nx={nx}, d={trainer.d}, tw={tw}), got {window.shape}"
            )
        B = window.shape[0]
        if variables is None:
            variables = self.default_variables(B)
        else:
            want, got = set(trainer.eq_norms), set(variables)
            if got != want:
                raise ValueError(
                    f"equation variables mismatch: expected {sorted(want)}, "
                    f"got {sorted(got)}"
                )
            variables = dict(variables)
        if start_step is None:
            steps = np.full((B,), tw, np.int32)
        else:
            steps = np.broadcast_to(
                np.asarray(start_step, np.int32), (B,)).copy()

        bucket = self._bucket_for(B)
        if B > bucket:
            return np.concatenate([
                self.rollout(window[s:s + bucket],
                             {k: v[s:s + bucket]
                              for k, v in variables.items()},
                             start_step=steps[s:s + bucket],
                             n_windows=n_windows)
                for s in range(0, B, bucket)
            ], axis=0)

        pad = bucket - B
        if pad:
            window = np.concatenate(
                [window, np.zeros((pad,) + window.shape[1:], np.float32)])
            steps = np.concatenate([steps, np.full((pad,), tw, np.int32)])
            variables = {
                k: np.concatenate([np.asarray(v, np.float32),
                                   np.zeros((pad,), np.float32)])
                for k, v in variables.items()
            }
        variables = {k: np.asarray(v, np.float32)
                     for k, v in variables.items()}
        return self._run(window, steps, variables, int(n_windows))[:B]

    def trajectory(self, window, **kw) -> np.ndarray:
        """Rollout reshaped to physical layout [B, S*tw, d, nx]."""
        preds = self.rollout(window, **kw)
        return windows_to_trajectory(preds, self.trainer.d, self.trainer.tw)

    def warmup(self, n_windows: int = 1):
        """Run every bucket once (builds the kernels on first use)."""
        nx, d, tw = self.trainer.spec.nx, self.trainer.d, self.trainer.tw
        for b in self.buckets:
            self.rollout(np.zeros((b, nx, d * tw), np.float32),
                         n_windows=n_windows)


def windows_to_trajectory(preds: np.ndarray, d: int, tw: int) -> np.ndarray:
    """[B, S, nx, d*tw] component-major windows -> [B, S*tw, d, nx]."""
    B, S, nx, _ = preds.shape
    a = preds.reshape(B, S, nx, d, tw)
    return np.transpose(a, (0, 1, 4, 3, 2)).reshape(B, S * tw, d, nx)

