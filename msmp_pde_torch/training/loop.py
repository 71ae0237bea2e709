"""Model application for graph models (counterpart of
msmp_pde_tpu/training/loop.py). The forward only: the optimizer step is the
next slice (ROADMAP.md Queue 1 item 7)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from msmp_pde_torch.data.graph import GraphSpec
from msmp_pde_torch.models.common import assemble_variables


def make_var_fns(eq_norms: Dict[str, float], tmax: float):
    """The graph path's variable-vector builder: normalized time and the
    normalized equation parameters (beta negated). The 2-D models' b-reads-a
    substitution comes with the 2-D family."""

    def graph_vars(t, variables):
        return assemble_variables(t, variables, eq_norms, tmax)

    return graph_vars


@dataclasses.dataclass
class Trainer:
    """One graph model on its static graph. ``model`` lives on the spec's
    device."""

    model: torch.nn.Module
    kind: str
    spec: GraphSpec
    eq_norms: Dict[str, float]

    def __post_init__(self):
        if self.kind != "graph":
            raise NotImplementedError("grid models are not ported yet")
        self.tw = self.spec.tw
        self.d = self.spec.n_components
        self.graph_vars = make_var_fns(self.eq_norms, self.spec.tmax)

    @property
    def device(self) -> torch.device:
        return self.spec.x.device

    def forward(self, window, steps, variables, lem_state=None):
        """window [B, nx, d*tw]; steps [B] label-window start indices (the
        time feature); variables {name: [B]}."""
        spec = self.spec
        t = spec.t_grid[steps]
        var_vec = self.graph_vars(t, variables)
        pos_x = spec.x.expand(window.shape[0], spec.nx)
        return self.model(window, pos_x, t, var_vec, spec.idx, spec.mask,
                          lem_state=lem_state)
