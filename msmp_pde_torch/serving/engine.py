"""Batched rollout engine for serving trained surrogates (counterpart of
msmp_pde_tpu/serving/engine.py).

Requests are padded up to the nearest batch bucket (oversize requests are
chunked over the largest), and the horizon runs as an eager loop of
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
number of windows, which the engine calls and serving/export.py exports:
the eager path and the exported one share one body. ``devices`` holds one
replica of the model on each device (the JAX engine's ``mesh``); a bucket
that their number divides is split across them in order.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from msmp_pde_torch.data.graph import advance_windows
from msmp_pde_torch import tracing


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
            dev = self.replicas[k].device
            sl = slice(k * rows, (k + 1) * rows)
            args = (torch.as_tensor(window[sl], device=dev),
                    torch.as_tensor(steps[sl], device=dev,
                                    dtype=torch.int64),
                    {name: torch.as_tensor(v[sl], device=dev)
                     for name, v in variables.items()})
            with tracing.span("serve.program"):
                outs.append(self.program(n_windows, k)(*args))
        with tracing.span("serve.answer"):
            return np.concatenate([o.cpu().numpy() for o in outs])

    def rollout(self, window, variables: Optional[Dict] = None,
                start_step=None, n_windows: int = 1) -> np.ndarray:
        """``start_step``: scalar or per-sample [B] label-window start
        indices (the time-feature anchor); default ``tw``. Its spans
        (tracing.py): ``serve.rollout`` around the request, each
        chunk's nested in it with the request's id; ``serve.program``
        around each program call and ``serve.answer`` around the copy to
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

