"""Finite-difference / WENO5 stencil coefficients (a copy of
msmp_pde_tpu/ops/stencils.py: the port imports nothing of the JAX package).
Plain numpy arrays, cast to the working dtype where they are used.
"""
import numpy as np

# --- WENO5 (3-stencil, 5-point) smoothness / optimal-weight / flux stencils.
# Smoothness indicator is beta_r = (sqrt(13/12) * A_r . u)^2 + (0.5 * B_r . u)^2
# for each of the 3 candidate stencils r.
WENO5_BETA_A = np.sqrt(13.0 / 12.0) * np.array(
    [
        [1.0, -2.0, 1.0, 0.0, 0.0],
        [0.0, 1.0, -2.0, 1.0, 0.0],
        [0.0, 0.0, 1.0, -2.0, 1.0],
    ]
)

WENO5_BETA_B = 0.5 * np.array(
    [
        [1.0, -4.0, 3.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, -1.0, 0.0],
        [0.0, 0.0, 3.0, -4.0, 1.0],
    ]
)

# Optimal (linear) weights gamma_r.
WENO5_GAMMA = np.array([1.0, 6.0, 3.0]) / 10.0

# Candidate-stencil reconstruction coefficients.
WENO5_STENCILS = (1.0 / 6.0) * np.array(
    [
        [2.0, -7.0, 11.0, 0.0, 0.0],
        [0.0, -1.0, 5.0, 2.0, 0.0],
        [0.0, 0.0, 2.0, 5.0, -1.0],
    ]
)

WENO5_EPS = 1e-16

# --- Central-difference taps on a 5-point window (4th-order for d1/d2,
# 2nd-order for d3/d4), https://en.wikipedia.org/wiki/Finite_difference_coefficient
FDM_D1 = np.array([1.0 / 12.0, -2.0 / 3.0, 0.0, 2.0 / 3.0, -1.0 / 12.0])
FDM_D2 = np.array([-1.0 / 12.0, 4.0 / 3.0, -5.0 / 2.0, 4.0 / 3.0, -1.0 / 12.0])
FDM_D3 = np.array([-1.0 / 2.0, 1.0, 0.0, -1.0, 1.0 / 2.0])
FDM_D4 = np.array([1.0, -4.0, 6.0, -4.0, 1.0])
