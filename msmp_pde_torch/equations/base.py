"""PDE grid metadata (counterpart of msmp_pde_tpu/equations/base.py): the
grid and domain bookkeeping that datagen, the dataset reader, the graph
and the models read. The right-hand sides are functions each family's
class builds (``CE.make_rhs``)."""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple


@dataclasses.dataclass
class PDE:
    tmin: float = 0.0
    tmax: float = 0.5
    grid_size: Tuple[int, int] = (16, 64)  # (nt, nx)
    L: float = 16.0

    # sum-of-sines IC frequency band and wave count (per-family overrides)
    lmin: int = 1
    lmax: int = 3
    n_waves: int = 5

    # fields a trajectory carries at each point (AD: 2)
    n_components: ClassVar[int] = 1

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
        # duplicated-endpoint periodic convention: dx = L / nx (ops/fd.py)
        return self.L / self.grid_size[1]

    def __repr__(self):
        return type(self).__name__
