"""Experiment -> PDE and equation-variable norms (counterpart of
msmp_pde_tpu/training/setup.py). Only the CE family is ported."""
from __future__ import annotations

from msmp_pde_torch.equations import CE


def pde_for_experiment(experiment: str, base_resolution):
    nt, nx = base_resolution
    if experiment in ("E1", "E2", "E3", "kdv"):
        if not (nt == 250 and nx in (100, 50, 40)):
            raise ValueError(f"{experiment} runs at nt=250, nx in "
                             f"(100, 50, 40); got {base_resolution}")
        return CE(tmax=4.0 if experiment in ("E1", "E2") else 2.0,
                  grid_size=(nt, nx))
    if experiment in ("WE1", "WE2", "WE3", "KF", "KS", "RP", "RPU", "MSWG",
                      "MSWG3"):
        raise NotImplementedError(
            f"experiment {experiment!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 15)")
    raise ValueError(f"unknown experiment {experiment!r}")


def eq_variable_norms(experiment: str, parameter_ablation: bool = False):
    """Equation-specific input variables per task."""
    if parameter_ablation:
        return {}
    return {
        "E2": {"beta": 0.2},
        "E3": {"alpha": 3.0, "beta": 0.4, "gamma": 1.0},
        "WE3": {"bc_left": 1, "bc_right": 1},
        "KF": {"D": 1e-4, "r": 1.0},
        "RP": {"a": 1.0, "b": 1.0},
        "RPU": {"a": 1.0, "b": 1.0},
        "MSWG": {"a": 1.0, "b": 1.0},
        "MSWG3": {"a": 1.0, "b": 1.0},
    }.get(experiment, {})
