"""Combined equation u_t = -alpha u u_x + beta u_xx - gamma u_xxx: grid
metadata and coefficients (counterpart of msmp_pde_tpu/equations/ce.py).
The WENO right-hand side waits for the data-generation slice."""
from __future__ import annotations

import dataclasses

from msmp_pde_torch.equations.base import PDE


@dataclasses.dataclass(repr=False)
class CE(PDE):
    alpha: float = 3.0
    beta: float = 0.0
    gamma: float = 1.0
    flux_splitting: str = "godunov"
