"""Model registry (counterpart of msmp_pde_tpu/models/registry.py).

All 27 names are ported. The nineteen graph models: the 1-D MP-PDE,
Gated, LEM, MSMP-PDE, MSSMP-PDE, MSGMP-PDE (hidden 164 whatever
``hidden`` says, as in the JAX registry), SaveMSMP-PDE, LSTMGated and
LSTM, and the 2-D MP-PDE2D, Gated2D, MSMP-PDE2D, MSGMP-PDE2D (hidden 164),
SaveMSMP-PDE2D, MSG2-PDE2D (gradient gate), LSTMGated2D, LEM2D,
GLEMGated2D (attention layers) and LSTM2D. The eight grid models: BaseCNN,
FNO, FNOP and VNO (1-D) and BaseCNN2D, FNO2D, FNO2DP and FNO2DPU (the
two-component system; FNO2DPU resamples RPU's unstructured grid onto a
uniform one and back).
"""
from __future__ import annotations

from typing import Tuple

import torch

from msmp_pde_torch.models.cnn import BaseCNN
from msmp_pde_torch.models.fno import FNO1d, FNO2d, VNO1d
from msmp_pde_torch.models.gnn import MPSolver

# name -> MPSolver's keywords (msmp_pde_tpu/models/registry.py:53-64)
_GRAPH = {
    "MP-PDE": dict(encoder="mlp", gate="none"),
    "Gated": dict(encoder="mlp", gate="sigmoid"),
    "LEM": dict(encoder="lem", gate="none"),
    "MSMP-PDE": dict(encoder="lem", gate="sigmoid"),
    "MSSMP-PDE": dict(twin_scale=True),
    "MSGMP-PDE": dict(encoder="lem", gate="sigmoid", decoder="glu",
                      hidden=164),
    "SaveMSMP-PDE": dict(encoder="lem", gate="sigmoid", save_state=True),
    "LSTMGated": dict(encoder="lstm", gate="sigmoid"),
    "LSTM": dict(encoder="lstm", gate="none"),
}
# the 2-D systems (msmp_pde_tpu/models/registry.py:66-79)
_GRAPH_2D = {
    "MP-PDE2D": dict(encoder="mlp", gate="none"),
    "Gated2D": dict(encoder="mlp", gate="sigmoid"),
    "MSMP-PDE2D": dict(encoder="lem", gate="sigmoid"),
    "MSGMP-PDE2D": dict(encoder="lem", gate="sigmoid", decoder="glu",
                        hidden=164),
    "SaveMSMP-PDE2D": dict(encoder="lem", gate="sigmoid", save_state=True),
    "MSG2-PDE2D": dict(encoder="lem", gate="grad"),
    "LSTMGated2D": dict(encoder="lstm", gate="sigmoid"),
    "LEM2D": dict(encoder="lem", gate="none"),
    "GLEMGated2D": dict(encoder="lem", gate="sigmoid", layer_type="gat"),
    "LSTM2D": dict(encoder="lstm", gate="none"),
}
_GRAPH.update({k: dict(v, n_components=2) for k, v in _GRAPH_2D.items()})

# the equation variables the FNO Param variants take
# (msmp_pde_tpu/models/registry.py:44-50)
FNO_VARS = ("alpha", "beta", "gamma", "D", "r", "a", "b")
GRID = ("BaseCNN", "FNO", "FNOP", "VNO", "BaseCNN2D", "FNO2D", "FNO2DP",
        "FNO2DPU")

PORTED = tuple(_GRAPH) + GRID

MODEL_REGISTRY = (
    "MP-PDE", "BaseCNN", "Gated", "LEM", "MSMP-PDE", "MSSMP-PDE", "MSGMP-PDE",
    "SaveMSMP-PDE", "LSTMGated", "LSTM", "FNO", "VNO", "FNOP",
    "MP-PDE2D", "Gated2D", "MSMP-PDE2D", "MSGMP-PDE2D", "SaveMSMP-PDE2D",
    "MSG2-PDE2D", "BaseCNN2D", "LSTMGated2D", "LEM2D", "GLEMGated2D",
    "LSTM2D", "FNO2D", "FNO2DP", "FNO2DPU",
)


def get_model(name: str, *, tw: int, n_eq_vars: int, L: float, tmax: float,
              dt: float, n_layers: int = 6, hidden: int = 128,
              eq_var_names: Tuple[str, ...] = (), positions=None,
              seed: int = 0, mp_precision: str = "float32",
              mp_remat: bool = False) -> Tuple[torch.nn.Module, str]:
    """(module, kind). A graph module takes ``1 + n_eq_vars`` model
    variables (normalized time first); a grid module takes the variables
    of ``eq_var_names`` that are in FNO_VARS (the Param variants) and
    ignores ``hidden`` and ``n_layers``. VNO builds its transform from
    ``positions``, the grid's [nx] coordinates. ``mp_precision`` and
    ``mp_remat`` are the graph models' (models/gnn.py::MPSolver); a grid
    model has no message-passing layer and ignores them, as the JAX
    registry does, but an unknown precision raises for every name."""
    from msmp_pde_torch.ops.mp_layer import mode_of

    mode_of(mp_precision)
    if name in _GRAPH:
        kw = {"hidden": hidden, **_GRAPH[name]}  # MSGMP-PDE*'s 164 wins
        return MPSolver(tw, n_vars=1 + n_eq_vars, layers=n_layers, L=L,
                        tmax=tmax, dt=dt, seed=seed,
                        mp_precision=mp_precision, mp_remat=mp_remat,
                        **kw), "graph"
    gen = torch.Generator().manual_seed(seed)
    n_vars = sum(v in FNO_VARS for v in eq_var_names)
    grid = {
        "BaseCNN": lambda: BaseCNN(tw, dt, gen),
        "BaseCNN2D": lambda: BaseCNN(tw, dt, gen, n_components=2),
        "FNO": lambda: FNO1d(tw, gen, domain=(0.0, L)),
        "FNOP": lambda: FNO1d(tw, gen, domain=(0.0, L), n_vars=n_vars),
        "VNO": lambda: VNO1d(tw, positions, gen, domain=(0.0, L)),
        "FNO2D": lambda: FNO2d(tw, gen, domain=(0.0, L)),
        "FNO2DP": lambda: FNO2d(tw, gen, domain=(0.0, L), n_vars=n_vars),
        "FNO2DPU": lambda: FNO2d(tw, gen, domain=(0.0, L), n_vars=n_vars,
                                 unstructured=True),
    }
    if name in grid:
        return grid[name](), "grid"
    raise ValueError(f"unknown model {name!r}")
