"""Explicit Runge-Kutta time integration."""
from msmp_pde_torch.temporal.erk import erk_step, solve_adaptive, solve_fixed
from msmp_pde_torch.temporal.tableaux import (
    DOPRI45,
    EXPLICIT_MIDPOINT,
    FORWARD_EULER,
    RK3,
    RK4,
    Tableau,
)

__all__ = ["Tableau", "FORWARD_EULER", "EXPLICIT_MIDPOINT", "RK3", "RK4",
           "DOPRI45", "erk_step", "solve_fixed", "solve_adaptive"]
