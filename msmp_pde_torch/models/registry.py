"""Model registry (counterpart of msmp_pde_tpu/models/registry.py).

The 1-D graph models ``MP-PDE``, ``Gated``, ``LEM`` and ``MSMP-PDE`` are
ported; every other registry name raises.
"""
from __future__ import annotations

from typing import Tuple

from msmp_pde_torch.models.gnn import MPSolver

# name -> (encoder, gate) of MPSolver (msmp_pde_tpu/models/registry.py:53-56)
_GRAPH = {
    "MP-PDE": ("mlp", "none"),
    "Gated": ("mlp", "sigmoid"),
    "LEM": ("lem", "none"),
    "MSMP-PDE": ("lem", "sigmoid"),
}

MODEL_REGISTRY = (
    "MP-PDE", "BaseCNN", "Gated", "LEM", "MSMP-PDE", "MSSMP-PDE", "MSGMP-PDE",
    "SaveMSMP-PDE", "LSTMGated", "LSTM", "FNO", "VNO", "FNOP",
    "MP-PDE2D", "Gated2D", "MSMP-PDE2D", "MSGMP-PDE2D", "SaveMSMP-PDE2D",
    "MSG2-PDE2D", "BaseCNN2D", "LSTMGated2D", "LEM2D", "GLEMGated2D",
    "LSTM2D", "FNO2D", "FNO2DP", "FNO2DPU",
)


def get_model(name: str, *, tw: int, n_eq_vars: int, L: float, tmax: float,
              dt: float, n_layers: int = 6, hidden: int = 128,
              seed: int = 0) -> Tuple[MPSolver, str]:
    """(module, kind). The module takes ``1 + n_eq_vars`` model variables
    (normalized time first)."""
    if name in _GRAPH:
        encoder, gate = _GRAPH[name]
        return MPSolver(tw, n_vars=1 + n_eq_vars, hidden=hidden,
                        layers=n_layers, encoder=encoder, gate=gate, L=L,
                        tmax=tmax, dt=dt, seed=seed), "graph"
    if name in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md Queue 1 item 11)")
    raise ValueError(f"unknown model {name!r}")
