"""Kolmogorov-Fisher reaction-diffusion equation (counterpart of
msmp_pde_tpu/equations/kf.py):

    u_t = D u_xx + r u (1 - u)

* ``bc='periodic'``: the 4th-order central difference u_xx on the
  periodic pad (ops/fd.py);
* ``bc='dirichlet'``: the reference builds a 6th-order banded matrix and
  applies only its diagonal, u_xx ~ (-49/18) u / dx^2. That is the default
  (``diag_quirk=True``), so the data has the reference's distribution;
  ``diag_quirk=False`` applies the whole band on a zero pad of 3.

r and D may be scalars or tensors that broadcast against u ([B, 1] for
per-sample coefficients).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from msmp_pde_torch.equations.base import PDE
from msmp_pde_torch.ops.fd import (
    correlate1d,
    fdm_second_derivative,
    periodic_pad,
)

# the 6th-order central second-derivative taps (the interior rows of the
# reference's banded Dirichlet matrix)
D2_ORDER6 = np.array([1 / 90, -3 / 20, 3 / 2, -49 / 18, 3 / 2, -3 / 20,
                      1 / 90])


@dataclasses.dataclass(repr=False)
class KF(PDE):
    r: float = 1.0
    D: float = 0.1
    bc: str = "dirichlet"
    diag_quirk: bool = True
    lmax: int = 8  # the initial condition's wider frequency band

    def make_rhs(self, r=None, D=None) -> Callable:
        """rhs(t, u) for u [..., nx]."""
        r = self.r if r is None else r
        D = self.D if D is None else D
        dx = self.dx

        def reaction(u):
            return r * u * (1.0 - u)

        if self.bc == "periodic":
            def rhs(t, u):
                uxx = fdm_second_derivative(periodic_pad(u), dx)
                return D * uxx + reaction(u)
        elif self.bc == "dirichlet":
            if self.diag_quirk:
                diag = D2_ORDER6[3] / dx**2  # -49/18 / dx^2

                def rhs(t, u):
                    return D * (diag * u) + reaction(u)
            else:
                def rhs(t, u):
                    # zero pad: homogeneous Dirichlet
                    taps = torch.as_tensor(D2_ORDER6 / dx**2, dtype=u.dtype,
                                           device=u.device)
                    u_p = torch.nn.functional.pad(u, (3, 3))
                    return D * correlate1d(u_p, taps) + reaction(u)
        else:
            raise ValueError(f"unsupported bc {self.bc!r}")
        return rhs
