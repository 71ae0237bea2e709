"""Butcher tableaux for explicit Runge-Kutta methods (a copy of
msmp_pde_tpu/temporal/tableaux.py: the port imports nothing of the JAX
package). Immutable dataclasses of numpy arrays, cast to the working dtype
inside the solvers, so one tableau serves float32 and float64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tableau:
    name: str
    order: int
    a: np.ndarray  # [s, s] strictly lower-triangular for explicit methods
    b: np.ndarray  # [s]
    c: np.ndarray  # [s]
    blo: Optional[np.ndarray] = None  # embedded lower-order weights (adaptive)
    atol: float = 1e-5
    rtol: float = 1e-5

    def __post_init__(self):
        a, b, c = self.a, self.b, self.c
        if a.shape[0] != a.shape[1]:
            raise ValueError("a must be square")
        if a.shape[0] != b.shape[0] or b.shape[0] != c.shape[0]:
            raise ValueError("a, b, c must agree in stage count")
        if not np.allclose(a, np.tril(a, k=-1)):
            raise ValueError(f"{self.name}: explicit tableau expected")

    @property
    def s(self) -> int:
        return self.a.shape[0]

    @property
    def is_adaptive(self) -> bool:
        return self.blo is not None


FORWARD_EULER = Tableau(
    name="ForwardEuler",
    order=1,
    a=np.array([[0.0]]),
    b=np.array([1.0]),
    c=np.array([1.0]),
)

EXPLICIT_MIDPOINT = Tableau(
    name="ExplicitMidpoint",
    order=2,
    a=np.array([[0.0, 0.0], [0.5, 0.0]]),
    b=np.array([0.0, 1.0]),
    c=np.array([0.0, 0.5]),
)

RK3 = Tableau(
    name="RK3",
    order=3,
    a=np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [-1.0, 2.0, 0.0]]),
    b=np.array([1 / 6, 2 / 3, 1 / 6]),
    c=np.array([0.0, 0.5, 1.0]),
)

RK4 = Tableau(
    name="RK4",
    order=4,
    a=np.array(
        [
            [0.0, 0.0, 0.0, 0.0],
            [0.5, 0.0, 0.0, 0.0],
            [0.0, 0.5, 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
        ]
    ),
    b=np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6]),
    c=np.array([0.0, 0.5, 0.5, 1.0]),
)

# Dormand-Prince 4(5) embedded pair (reference: temporal/tableaux.py:129-148).
DOPRI45 = Tableau(
    name="Dopri45",
    order=5,
    a=np.array(
        [
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [1 / 5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [3 / 40, 9 / 40, 0.0, 0.0, 0.0, 0.0, 0.0],
            [44 / 45, -56 / 15, 32 / 9, 0.0, 0.0, 0.0, 0.0],
            [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0.0, 0.0, 0.0],
            [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0.0, 0.0],
            [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
        ]
    ),
    b=np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]),
    blo=np.array(
        [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
    ),
    c=np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]),
)
