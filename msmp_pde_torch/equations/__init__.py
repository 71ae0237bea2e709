"""PDE definitions (grid metadata only in this port so far)."""
from msmp_pde_torch.equations.base import PDE
from msmp_pde_torch.equations.ce import CE

__all__ = ["PDE", "CE"]
