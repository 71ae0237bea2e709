"""Model registry (counterpart of msmp_pde_tpu/models/registry.py).

The nineteen graph models are ported: the 1-D MP-PDE, Gated, LEM,
MSMP-PDE, MSSMP-PDE, MSGMP-PDE (hidden 164 whatever ``hidden`` says, as in
the JAX registry), SaveMSMP-PDE, LSTMGated and LSTM, and the 2-D MP-PDE2D,
Gated2D, MSMP-PDE2D, MSGMP-PDE2D (hidden 164), SaveMSMP-PDE2D, MSG2-PDE2D
(gradient gate), LSTMGated2D, LEM2D, GLEMGated2D (attention layers) and
LSTM2D; the grid models raise.
"""
from __future__ import annotations

from typing import Tuple

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

PORTED = tuple(_GRAPH)

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
        kw = {"hidden": hidden, **_GRAPH[name]}  # MSGMP-PDE*'s 164 wins
        return MPSolver(tw, n_vars=1 + n_eq_vars, layers=n_layers, L=L,
                        tmax=tmax, dt=dt, seed=seed, **kw), "graph"
    if name in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md Queue 1 item 11, "
            "the grid models)")
    raise ValueError(f"unknown model {name!r}")
