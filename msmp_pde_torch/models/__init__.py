"""Model building blocks and the MSMP-PDE solver."""
