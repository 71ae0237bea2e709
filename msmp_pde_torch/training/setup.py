"""Experiment -> PDE, equation-variable norms, datasets, grid and the
model's trainer (counterpart of msmp_pde_tpu/training/setup.py): the CE
family (E1-E3, kdv), the wave equation (WE1-3, on the data's Chebyshev
grid), KF, KS and the advection system on its uniform grid (RP, MSWG,
MSWG3) and on the unstructured LCG grid (RPU). ``build_trainer`` serves
training and serving, on the uniform grid or on a dataset's;
``setup_experiment`` reads the datasets the train CLI needs. A
``data_suffix`` (the interpolated ``_I`` files of data/interpolate.py)
puts RPU on the uniform grid, as the JAX package's ``setup_experiment``
and ``build_serving_trainer`` do."""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np

from msmp_pde_torch.equations import AD, CE, KF, KS, WE

# the advection experiments' horizon; L is 2 pi for MSWG and MSWG3
AD_TMAX = {"RP": 4.0, "RPU": 4.0, "MSWG": 3.0, "MSWG3": 1.0}


def pde_for_experiment(experiment: str, base_resolution):
    nt, nx = base_resolution
    if experiment in ("E1", "E2", "E3", "kdv"):
        if not (nt == 250 and nx in (100, 50, 40)):
            raise ValueError(f"{experiment} runs at nt=250, nx in "
                             f"(100, 50, 40); got {base_resolution}")
        return CE(tmax=4.0 if experiment in ("E1", "E2") else 2.0,
                  grid_size=(nt, nx))
    if experiment in AD_TMAX:
        if not (nt in (250, 500) and nx in (100, 50, 40)):
            raise ValueError(f"{experiment} runs at nt in (250, 500), nx in "
                             f"(100, 50, 40); got {base_resolution}")
        L = 16.0 if experiment in ("RP", "RPU") else 2 * np.pi
        return AD(tmax=AD_TMAX[experiment], grid_size=(nt, nx), L=L,
                  unstructured_grid=experiment == "RPU")
    if experiment in ("WE1", "WE2", "WE3"):
        if not (nt == 250 and nx in (100, 50, 40, 20)):
            raise ValueError(f"{experiment} runs at nt=250, nx in "
                             f"(100, 50, 40, 20); got {base_resolution}")
        return WE(tmax=100.0, grid_size=(nt, nx))
    if experiment == "KF":
        if not (nt == 250 and nx in (100, 50, 40)):
            raise ValueError(f"KF runs at nt=250, nx in (100, 50, 40); got "
                             f"{base_resolution}")
        return KF(tmax=5.0, grid_size=(nt, nx))
    if experiment == "KS":
        if not (nt in (250, 500) and nx in (100, 50, 40)):
            raise ValueError(f"KS runs at nt in (250, 500), nx in (100, 50, "
                             f"40); got {base_resolution}")
        return KS(L=22.0 / (2 * np.pi), nx=nx, dt=0.00025, tend=100.0,
                  dt_downsampled=100.0 / nt)
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


def data_family(experiment: str) -> str:
    for fam, exps in {
        "CE": ("E1", "E2", "E3", "kdv"),
        "WE": ("WE1", "WE2", "WE3"),
        "KF": ("KF",),
        "KS": ("KS",),
        "AD": ("RP", "RPU", "MSWG", "MSWG3"),
    }.items():
        if experiment in exps:
            return fam
    raise ValueError(experiment)


def resolve_data_path(data_dir: str, fam: str, experiment: str, suffix: str,
                      mode: str) -> str:
    """The dataset file of one mode: the port's ``{fam}_{experiment}.npz``
    first, then the merged ``{fam}_{experiment}.h5`` (all three modes in
    one file), then the reference's one file a mode,
    ``{fam}_{mode}_{experiment}.h5``. Where none exists, the ``.npz``'s
    name, for the error message."""
    stem = f"{data_dir}/{fam}_{experiment}{suffix}"
    for path in (f"{stem}.npz", f"{stem}.h5",
                 f"{data_dir}/{fam}_{mode}_{experiment}{suffix}.h5"):
        if os.path.exists(path):
            return path
    return f"{stem}.npz"


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
    """Dataset-free grid of the uniform families, as datagen writes it:
    ``linspace(0, L, nx)`` with dt = (tmax - tmin) / (nt - 1) (CE, KF,
    AD), and for KS ``linspace(0, 2 pi L, nx)`` over [tstart, tend] with
    dt = (tmax - tmin) / nt, its output step. The wave equation's
    Chebyshev grid (and RPU's) lives only in the data files: use
    ``serving.engine.grid_from_h5``."""
    family = f"{pde}"
    nt, nx = base_resolution
    if family == "WE" or getattr(pde, "unstructured_grid", False):
        raise ValueError(f"{family} grid is data-defined; pass a dataset "
                         "file")
    L = float(getattr(pde, "L", 16.0))
    if family == "KS":
        x = np.linspace(0.0, 2 * np.pi * L, nx)
        tmin, tmax = float(pde.tstart), float(pde.tend)
        dt = (tmax - tmin) / nt
    else:
        x = np.linspace(0.0, L, nx)
        tmin, tmax = float(getattr(pde, "tmin", 0.0)), float(pde.tmax)
        dt = (tmax - tmin) / (nt - 1)
    return GridInfo(x=x.astype(np.float32), nt=nt, dt=dt, tmin=tmin,
                    tmax=tmax, n_components=pde.n_components)


def build_trainer(experiment: str, model: str, *,
                  base_resolution=(250, 100), neighbors: int = 3,
                  time_window: int = 25, n_graph_layers: int = 6,
                  mp_precision: str = "float32", mp_remat: bool = False,
                  device=None, seed: int = 0, grid=None,
                  parameter_ablation: bool = False, data_suffix: str = ""):
    """The ``Trainer`` of ``model`` on ``experiment``'s uniform grid, or on
    ``grid`` (a ``PDEDataset`` or ``GridInfo``), with weights random from
    ``seed``: a graph model, or a grid model with the experiment's
    equation variables and the grid's positions (VNO's transform), as
    msmp_pde_tpu/training/setup.py:134-146 builds it. A ``data_suffix``
    (the ``_I`` files) takes RPU's graph as the uniform grid's radius
    stencil. ``mp_precision`` (float32, bfloat16, bfloat16s; any other
    raises) and ``mp_remat`` are the graph model's (models/gnn.py::
    MPSolver). ``device`` defaults to CUDA and raises without it."""
    from msmp_pde_torch.data.graph import build_graph_spec
    from msmp_pde_torch.device import resolve_device
    from msmp_pde_torch.models.registry import get_model
    from msmp_pde_torch.training.loop import Trainer

    dev = resolve_device(device)
    pde = pde_for_experiment(experiment, tuple(base_resolution))
    if data_suffix:
        pde.unstructured_grid = False
    eq_norms = eq_variable_norms(experiment, parameter_ablation)
    if grid is None:
        grid = uniform_grid(pde, tuple(base_resolution))
    spec = build_graph_spec(pde, grid, neighbors, time_window, dev)
    m, kind = get_model(
        model, tw=time_window, n_eq_vars=len(eq_norms),
        L=float(getattr(pde, "L", 16.0)), tmax=grid.tmax, dt=grid.dt,
        n_layers=n_graph_layers, eq_var_names=tuple(eq_norms),
        positions=np.asarray(grid.x), seed=seed, mp_precision=mp_precision,
        mp_remat=mp_remat,
    )
    return Trainer(model=m.to(dev), kind=kind, spec=spec, eq_norms=eq_norms)


@dataclasses.dataclass
class Experiment:
    pde: object
    datasets: Dict[str, object]
    trainer: object

    @property
    def t_res(self) -> int:
        return self.datasets["train"].nt


def setup_experiment(args, modes=("train", "valid", "test"),
                     data_dir: str = "data") -> Experiment:
    """The datasets of ``modes`` and the trainer on their grid, from the
    train CLI's arguments; ``args.device`` defaults to CUDA."""
    from msmp_pde_torch.data.dataset import PDEDataset

    base = tuple(args.base_resolution)
    pde = pde_for_experiment(args.experiment, base)
    ablation = getattr(args, "parameter_ablation", False)
    fam = data_family(args.experiment)
    suffix = getattr(args, "data_suffix", "")
    if suffix:
        pde.unstructured_grid = False
    datasets = {
        m: PDEDataset(resolve_data_path(data_dir, fam, args.experiment,
                                        suffix, m),
                      pde, m, base_resolution=base,
                      super_resolution=tuple(args.super_resolution))
        for m in modes
    }
    trainer = build_trainer(
        args.experiment, args.model, base_resolution=base,
        neighbors=args.neighbors, time_window=args.time_window,
        n_graph_layers=args.n_graph_layers,
        mp_precision=getattr(args, "mp_precision", "float32"),
        mp_remat=getattr(args, "mp_remat", False),
        device=getattr(args, "device", None), seed=args.seed,
        grid=datasets[modes[0]], parameter_ablation=ablation,
        data_suffix=suffix)
    return Experiment(pde=pde, datasets=datasets, trainer=trainer)
