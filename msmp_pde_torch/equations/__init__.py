"""PDE definitions: grid metadata, the CE and KF families' right-hand
sides, the advection system's exact solution, the wave equation's
propagator and the Kuramoto-Sivashinsky ETDRK4 solver."""
from msmp_pde_torch.equations.ad import AD
from msmp_pde_torch.equations.base import PDE
from msmp_pde_torch.equations.ce import CE
from msmp_pde_torch.equations.kf import KF
from msmp_pde_torch.equations.ks import KS
from msmp_pde_torch.equations.we import WE

__all__ = ["PDE", "CE", "AD", "KF", "KS", "WE"]
