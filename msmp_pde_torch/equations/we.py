"""Wave equation on a Chebyshev grid, u_tt = c^2 u_xx, Dirichlet or
Neumann boundaries (counterpart of msmp_pde_tpu/equations/we.py; the
operators are a numpy and scipy copy of it, the rollout torch).

With homogeneous boundary conditions the first-order system

    d/dt [u; w] = A [u; w],   A = [[0, I], [c^2 D2_bc, 0]]

is linear and time-invariant, so one output step is the exact propagator
P = expm(A dt), computed once per (nx, boundary pair, c, dt) on the host
in float64 (``wave_propagator``), and a trajectory is a chain of products
``state @ P^T`` (``we_rollout``). ``WE.chebdx`` is the same right-hand
side for scipy's Radau (the reference's integrator, datagen's
``--we_solver radau``).

The mixed pairs are built on the descending extremal grid, where the first
point is xmax, and then flipped to the ascending grid the data lives on
(``wave_interior_operator``), as the JAX package builds them.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.linalg
import torch

from msmp_pde_torch.equations.base import PDE
from msmp_pde_torch.equations.cheb import (
    bordered_diffmat,
    cheb_points,
    homogeneous_interior_operator,
)

BC_ORDER = {"dirichlet": 0, "neumann": 1}
# the boundary conditions as datagen stores them (bc_left, bc_right ints)
BC_NAMES = ("dirichlet", "neumann")


def cheb_grid_ascending(xmin: float, xmax: float, n: int) -> np.ndarray:
    """Chebyshev extremal grid mapped to [xmin, xmax], ascending."""
    x = cheb_points(n)[::-1]
    return (xmax - xmin) * (x + 1.0) / 2.0 + xmin


@functools.lru_cache(maxsize=None)
def wave_interior_operator(n: int, bc_left: str, bc_right: str,
                           L: float) -> np.ndarray:
    """[n, n-2] map: u_xx from the ascending grid's interior values, with
    homogeneous conditions of order BC_ORDER[bc_left] at xmin and
    BC_ORDER[bc_right] at xmax. Built on the descending grid, where the
    first point is xmax (so left and right swap), and flipped."""
    ol, orr = BC_ORDER[bc_left], BC_ORDER[bc_right]
    if ol == orr:
        d_desc = homogeneous_interior_operator(n, 2, ol, orr, L)
    else:
        # descending grid: the t0 row is xmax, bc_right's order first
        bcs = ((orr, (0.0, None)), (ol, (None, 0.0)))
        diffmat, bc_vals = bordered_diffmat(n, 2, bcs, L)
        d_desc = diffmat[:, len(bc_vals):]
    return d_desc[::-1, ::-1].copy()


@functools.lru_cache(maxsize=None)
def wave_propagator(n: int, bc_left: str, bc_right: str, L: float, c: float,
                    dt: float) -> np.ndarray:
    """Exact one-step propagator P [2n, 2n] of the state [u; u_t] on the
    ascending grid: state(t + dt) = P @ state(t); float64."""
    M = wave_interior_operator(n, bc_left, bc_right, L)
    Mext = np.zeros((n, n))
    Mext[:, 1:-1] = M
    A = np.block([[np.zeros((n, n)), np.eye(n)],
                  [c**2 * Mext, np.zeros((n, n))]])
    return scipy.linalg.expm(A * dt)


def we_rollout(P: torch.Tensor, states: torch.Tensor,
               steps: int) -> torch.Tensor:
    """``steps`` products of the states [B, 2n] with P^T: [steps + 1, B,
    2n], the initial states first."""
    out = [states]
    for _ in range(steps):
        out.append(out[-1] @ P.T)
    return torch.stack(out)


@dataclasses.dataclass(repr=False)
class WE(PDE):
    tmax: float = 20.0
    xmin: float = -8.0
    xmax: float = 8.0
    bc_left: str = "dirichlet"
    bc_right: str = "dirichlet"

    def __post_init__(self):
        self.L = abs(self.xmax - self.xmin)

    @property
    def dx(self) -> float:
        # not periodic: nx points including both boundaries
        return self.L / (self.grid_size[1] - 1)

    @property
    def x(self) -> np.ndarray:
        return cheb_grid_ascending(self.xmin, self.xmax, self.grid_size[1])

    def chebdx(self, t, state, x=None, c: float = 1.0) -> np.ndarray:
        """The stacked first-order right-hand side [u; w] -> [w; c^2 u_xx]
        on the host (numpy), for scipy's integrators."""
        n = len(state) // 2
        u, w = state[:n], state[n:]
        M = wave_interior_operator(n, self.bc_left, self.bc_right, self.L)
        return np.concatenate([w, c**2 * (M @ u[1:-1])])

    def propagator(self, c: float = 2.0) -> np.ndarray:
        return wave_propagator(self.grid_size[1], self.bc_left,
                               self.bc_right, self.L, float(c), self.dt)
