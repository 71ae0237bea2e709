"""Explicit Runge-Kutta time integration (counterpart of
msmp_pde_tpu/temporal/erk.py).

* ``solve_fixed``: one RK step per output interval;
* ``solve_adaptive``: each output interval integrated by dyadic
  subdivision. A trial step over the whole interval is taken; if the
  embedded error estimate is >= 1 the step halves and is retried. The
  position is kept in integer units of dt / 2^max_depth; after an accept
  the next step is the largest dyadic step aligned at the new position
  (its lowest set bit). The JAX package runs this rule in a
  ``lax.while_loop``; here it is a Python loop with one host read of the
  error a trial step.

The error is a batch-global scalar: sc = atol + rtol * max over axis 0 of
max(|y_in|, |y_hi|), RMS over the last axis, max over the rest; accept iff
error < 1 or the step is one unit (the depth cap). So a whole chunk of
samples shares one subdivision pattern, and the chunk is part of what
defines the data. With a process ``group`` (datagen over ranks, each
solving its rows of the chunk) both maxima, over the samples and over
the error, are all-reduced on every trial step, so every rank takes the
steps one process would take on the whole chunk.

RHS signature: ``f(t, y) -> dy/dt`` with t a Python float and y of shape
[batch, ..., nx].
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from msmp_pde_torch.temporal.tableaux import Tableau


def erk_step(tab: Tableau, f: Callable, t, y, h, conserve: bool = False):
    """One explicit RK step; returns (y_hi, y_lo), y_lo None unless the
    tableau is adaptive. ``conserve`` subtracts each stage's spatial mean
    before the combination."""
    a, b, c = tab.a.tolist(), tab.b.tolist(), tab.c.tolist()
    ks = []
    for i in range(tab.s):
        if i == 0:
            yi, ti = y, t
        else:
            ti = t + h * c[i]
            acc = a[i][0] * ks[0]
            for j in range(1, i):
                if a[i][j] != 0.0:
                    acc = acc + a[i][j] * ks[j]
            yi = y + h * acc
        ks.append(f(ti, yi))

    if conserve:
        ks = [k - torch.mean(k, dim=-1, keepdim=True) for k in ks]

    def combine(w):
        acc = w[0] * ks[0]
        for j in range(1, tab.s):
            acc = acc + w[j] * ks[j]
        return y + h * acc

    y_hi = combine(b)
    if tab.is_adaptive:
        return y_hi, combine(tab.blo.tolist())
    return y_hi, None


def _times(ts):
    return [float(v) for v in ts]


def solve_fixed(f: Callable, y0: torch.Tensor, ts, tab: Tableau,
                conserve: bool = False) -> torch.Tensor:
    """Fixed-step integration, one RK step per output interval; ``ts`` a
    sequence of output times. Returns [batch, nt, ...]."""
    ts = _times(ts)
    traj, y = [y0], y0
    for t, t_next in zip(ts[:-1], ts[1:]):
        y, _ = erk_step(tab, f, t, y, t_next - t, conserve=conserve)
        traj.append(y)
    return torch.stack(traj, dim=1)


def _error_scalar(y_in, y_hi, y_lo, atol, rtol, group=None):
    """Batch-global embedded error (a 0-d tensor); with ``group`` the
    batch is the ranks' rows together, its maxima all-reduced."""
    ymax = torch.amax(torch.maximum(torch.abs(y_in), torch.abs(y_hi)), dim=0,
                      keepdim=True)
    if group is not None:
        dist.all_reduce(ymax, op=dist.ReduceOp.MAX, group=group)
    sc = atol + ymax * rtol
    err = torch.amax(torch.sqrt(torch.mean(((y_hi - y_lo) / sc) ** 2,
                                           dim=-1)))
    if group is not None:
        dist.all_reduce(err, op=dist.ReduceOp.MAX, group=group)
    return err


def _adaptive_interval(tab: Tableau, f: Callable, t0: float, dt: float, y0,
                       max_depth: int, group=None):
    """Integrate one output interval [t0, t0 + dt] by dyadic subdivision."""
    total = 1 << max_depth
    t_units, h_units, y = 0, total, y0
    while t_units < total:
        h = dt * (h_units / total)
        t = t0 + dt * (t_units / total)
        y_hi, y_lo = erk_step(tab, f, t, y, h)
        err = _error_scalar(y, y_hi, y_lo, tab.atol, tab.rtol,
                            group).item()
        if err < 1.0 or h_units <= 1:  # the depth cap forces an accept
            t_units += h_units
            y = y_hi
            # the largest dyadic step aligned at the new position
            h_units = 1 if t_units >= total else t_units & -t_units
        else:
            h_units = max(h_units // 2, 1)
    return y


def solve_adaptive(f: Callable, y0: torch.Tensor, ts, tab: Tableau,
                   max_depth: int = 12, group=None) -> torch.Tensor:
    """Adaptive integration with dense output at every ts[i], at most
    ``max_depth`` halvings an output interval. Returns [batch, nt, ...].
    ``group``: the process group whose ranks hold the batch's other rows
    (every rank calls it), or None."""
    if not tab.is_adaptive:
        raise ValueError("solve_adaptive requires an embedded (adaptive) "
                         "tableau")
    ts = _times(ts)
    traj, y = [y0], y0
    for t, t_next in zip(ts[:-1], ts[1:]):
        y = _adaptive_interval(tab, f, t, t_next - t, y, max_depth, group)
        traj.append(y)
    return torch.stack(traj, dim=1)
