"""PDE definitions: grid metadata, the CE family's right-hand side and the
advection system's exact solution."""
from msmp_pde_torch.equations.ad import AD
from msmp_pde_torch.equations.base import PDE
from msmp_pde_torch.equations.ce import CE

__all__ = ["PDE", "CE", "AD"]
