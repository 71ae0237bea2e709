"""Linear advection system, two components, solved exactly by
characteristics (counterpart of msmp_pde_tpu/equations/ad.py):

    U_t + M U_x = 0,  M = R diag(2a, 2b) R^-1.

The system diagonalizes with R = [[-1, 1], [1, 1]], R^-1 =
0.5 [[-1, 1], [1, 1]] and characteristic speeds 2a, 2b: with w = R^-1 u,
w_i(x, t) = w_i(x - lam_i t, 0) and u = R w. The solve is a closed-form
evaluation of the initial condition at the characteristics' feet, batched
over samples, times and points.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from msmp_pde_torch.equations.base import PDE

# the advection matrix's eigenbasis
R = np.array([[-1.0, 1.0], [1.0, 1.0]])
RINV = np.array([[-0.5, 0.5], [0.5, 0.5]])


@dataclasses.dataclass(repr=False)
class AD(PDE):
    a: float = 1.0
    b: float = 1.0
    unstructured_grid: bool = False

    n_components: ClassVar[int] = 2


def exact_solution_batch(u0_batch_fn, x, t, a, b):
    """[B, 2, nt, nx] solution of per-sample initial conditions and speeds.

    ``u0_batch_fn(pts [B, M]) -> [B, 2, M]`` evaluates the initial
    condition (periodic wrapping is its own); x [nx], t [nt] and a, b [B]
    are tensors on one device."""
    a, b = a.reshape(-1), b.reshape(-1)
    lam = torch.stack([2.0 * a, 2.0 * b], dim=1)  # [B, 2]
    xs = x[None, None, None, :] - lam[:, :, None, None] * t[None, None, :,
                                                            None]
    B, _, nt, nx = xs.shape
    rinv = torch.as_tensor(RINV, dtype=x.dtype, device=x.device)
    r = torch.as_tensor(R, dtype=x.dtype, device=x.device)

    def w_component(i):
        u0 = u0_batch_fn(xs[:, i].reshape(B, nt * nx))  # [B, 2, M]
        return torch.einsum("j,bjm->bm", rinv[i], u0).reshape(B, nt, nx)

    w = torch.stack([w_component(0), w_component(1)], dim=1)
    return torch.einsum("ij,bjtx->bitx", r, w)
