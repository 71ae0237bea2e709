"""Batched 1-D linear interpolation (counterpart of
msmp_pde_tpu/ops/interp.py), in torch ops: the JAX package leaves it to
XLA, and here it is ``torch.searchsorted``, gathers and, for the dense
operator, a scatter (cuBLAS applies it).

Both functions take the segment of a query t as the last i with x_i <= t
(``searchsorted(..., right=True) - 1``), clamped to the grid's segments.
"""
from __future__ import annotations

import torch


def _segments(x, target):
    """The segment index of each query (see the module's docstring), x and
    target promoted to a common dtype for the search."""
    common = torch.promote_types(x.dtype, target.dtype)
    return torch.searchsorted(x.to(common).contiguous(),
                              target.to(common).contiguous(), right=True) - 1


def interp1d(x, y, target, mask: bool = True):
    """y(x) at the ``target`` points, piecewise linear.

    x: [nx] or [B, nx] sample locations (ascending), y: [nx] or [B, nx]
    values, target: [nt] or [B, nt] queries; the rows broadcast. With
    ``mask`` a query at or before x[0] takes y[0] and one at or past
    x[-1] takes y[-1]; without it the edge segments extrapolate. Returns
    [B, nt], or [nt] where every input is 1-D."""
    squeeze = x.ndim == 1 and y.ndim == 1 and target.ndim == 1
    x, y, target = (torch.atleast_2d(a) for a in (x, y, target))
    B = max(x.shape[0], y.shape[0], target.shape[0])
    x = x.expand(B, x.shape[1])
    y = y.expand(B, y.shape[1])
    target = target.expand(B, target.shape[1])
    m = (y[:, 1:] - y[:, :-1]) / (x[:, 1:] - x[:, :-1])
    b = y[:, :-1] - m * x[:, :-1]
    idx = torch.clamp(_segments(x, target), 0, m.shape[1] - 1)
    out = torch.gather(m, 1, idx) * target + torch.gather(b, 1, idx)
    if mask:
        out = torch.where(target <= x[:, :1], y[:, :1], out)
        out = torch.where(target >= x[:, -1:], y[:, -1:], out)
    return out[0] if squeeze else out


def interp_matrix(x, target, mask: bool = True):
    """The dense operator W [nt, nx], in x's dtype, with ``W @ y ==
    interp1d(x, y, target, mask)`` for any values y at the sorted
    locations x [nx]: row t holds 1 - w at the segment's left end and w at
    its right, w = (t - x0) / (x1 - x0), clamped to [0, 1] with
    ``mask``."""
    nx = x.shape[-1]
    idx = torch.clamp(_segments(x, target), 0, nx - 2)
    x0, x1 = x[idx], x[idx + 1]
    w = (target - x0) / (x1 - x0)
    if mask:
        w = torch.clamp(w, 0.0, 1.0)
    rows = torch.arange(target.shape[0], device=x.device)
    W = torch.zeros((target.shape[0], nx), dtype=x.dtype, device=x.device)
    W[rows, idx] = (1.0 - w).to(x.dtype)
    W[rows, idx + 1] = w.to(x.dtype)
    return W
