"""PDE grid metadata (counterpart of msmp_pde_tpu/equations/base.py).

Only the grid bookkeeping is ported; the right-hand sides wait for the
data-generation slice (ROADMAP.md Queue 1 item 15).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class PDE:
    tmin: float = 0.0
    tmax: float = 0.5
    grid_size: Tuple[int, int] = (16, 64)  # (nt, nx)
    L: float = 16.0

    @property
    def nt(self) -> int:
        return self.grid_size[0]

    @property
    def nx(self) -> int:
        return self.grid_size[1]

    @property
    def dt(self) -> float:
        return self.tmax / (self.grid_size[0] - 1)

    @property
    def dx(self) -> float:
        # duplicated-endpoint periodic convention: dx = L / nx
        return self.L / self.grid_size[1]

    def __repr__(self):
        return type(self).__name__
