"""Experiment -> PDE, equation-variable norms, grid and the model's
trainer (counterpart of msmp_pde_tpu/training/setup.py). Only the CE family
is ported. ``build_trainer`` serves both training and serving; it reads no
dataset."""
from __future__ import annotations

import dataclasses

import numpy as np

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


@dataclasses.dataclass
class GridInfo:
    """The slice of dataset metadata a trainer needs."""

    x: np.ndarray
    nt: int
    dt: float
    tmin: float
    tmax: float
    n_components: int


def uniform_grid(pde, base_resolution) -> GridInfo:
    """Dataset-free grid of the uniform families: ``linspace(0, L, nx)``
    with dt = (tmax - tmin) / (nt - 1)."""
    family = f"{pde}"
    nt, nx = base_resolution
    if family in ("WE", "KS") or getattr(pde, "unstructured_grid", False):
        raise ValueError(f"{family} grid is not a plain uniform grid")
    L = float(getattr(pde, "L", 16.0))
    x = np.linspace(0.0, L, nx)
    tmin, tmax = float(getattr(pde, "tmin", 0.0)), float(pde.tmax)
    return GridInfo(x=x.astype(np.float32), nt=nt,
                    dt=(tmax - tmin) / (nt - 1), tmin=tmin, tmax=tmax,
                    n_components=2 if family == "AD" else 1)


def build_trainer(experiment: str, model: str, *,
                  base_resolution=(250, 100), neighbors: int = 3,
                  time_window: int = 25, n_graph_layers: int = 6,
                  mp_precision: str = "float32", device=None,
                  seed: int = 0):
    """The ``Trainer`` of ``model`` on ``experiment``'s uniform grid, with
    weights random from ``seed``. ``device`` defaults to CUDA and raises
    without it."""
    from msmp_pde_torch.data.graph import build_graph_spec
    from msmp_pde_torch.device import resolve_device
    from msmp_pde_torch.models.registry import get_model
    from msmp_pde_torch.training.loop import Trainer

    dev = resolve_device(device)
    if mp_precision != "float32":
        raise NotImplementedError(
            f"mp_precision={mp_precision!r} is not ported yet (ROADMAP.md "
            "Queue 2 item 7)")
    pde = pde_for_experiment(experiment, tuple(base_resolution))
    eq_norms = eq_variable_norms(experiment)
    grid = uniform_grid(pde, tuple(base_resolution))
    spec = build_graph_spec(pde, grid, neighbors, time_window, dev)
    m, kind = get_model(
        model, tw=time_window, n_eq_vars=len(eq_norms),
        L=float(getattr(pde, "L", 16.0)), tmax=grid.tmax, dt=grid.dt,
        n_layers=n_graph_layers, seed=seed,
    )
    return Trainer(model=m.to(dev), kind=kind, spec=spec, eq_norms=eq_norms)
