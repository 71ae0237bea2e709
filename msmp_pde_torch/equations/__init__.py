"""PDE definitions: grid metadata and the CE family's right-hand side."""
from msmp_pde_torch.equations.base import PDE
from msmp_pde_torch.equations.ce import CE

__all__ = ["PDE", "CE"]
