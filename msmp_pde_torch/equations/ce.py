"""Combined equation (Burgers / KdV / heat as edge cases), counterpart of
msmp_pde_tpu/equations/ce.py:

    u_t = -alpha * u u_x + beta * u_xx - gamma * u_xxx  [+ forcing]

WENO5 Godunov (or Lax-Friedrichs) for the advection flux, 4th/2nd-order
central differences for diffusion and dispersion, and an optional
time-dependent forcing. The coefficients may be scalars or tensors that
broadcast against u ([B, 1, 1] for per-sample coefficients), so a whole
chunk of samples with different coefficients integrates at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from msmp_pde_torch.equations.base import PDE
from msmp_pde_torch.ops.fd import (
    fdm_second_derivative,
    fdm_third_derivative,
    periodic_pad,
    weno_godunov,
    weno_laxfriedrichs,
    weno_pad,
)


def flux(u):
    """Burgers flux f(u) = u^2 / 2."""
    return 0.5 * u * u


@dataclasses.dataclass(repr=False)
class CE(PDE):
    alpha: float = 3.0
    beta: float = 0.0
    gamma: float = 1.0
    flux_splitting: str = "godunov"

    def make_rhs(self, alpha=None, beta=None, gamma=None,
                 force: Optional[Callable] = None) -> Callable:
        """rhs(t, u) for u [..., nx]. alpha/beta/gamma default to the
        instance's scalars; force(t) returns a tensor that broadcasts
        against u."""
        alpha = self.alpha if alpha is None else alpha
        beta = self.beta if beta is None else beta
        gamma = self.gamma if gamma is None else gamma
        dx = self.dx
        splitting = self.flux_splitting
        if splitting not in ("godunov", "laxfriedrichs"):
            raise ValueError(f"unknown flux splitting {splitting!r}")
        advect = weno_godunov if splitting == "godunov" else weno_laxfriedrichs

        def rhs(t, u):
            adv = advect(weno_pad(u), dx, flux)
            u_f = periodic_pad(u)
            dudt = (-alpha * adv
                    + beta * fdm_second_derivative(u_f, dx)
                    - gamma * fdm_third_derivative(u_f, dx))
            if force is not None:
                dudt = dudt + force(t)
            return dudt

        return rhs
