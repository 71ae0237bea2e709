"""Chebyshev pseudospectral differentiation with boundary bordering (a
numpy copy of msmp_pde_tpu/equations/cheb.py: the port imports nothing of
the JAX package).

The m-th derivative on a Chebyshev extremal grid is computed in
coefficient space, with boundary conditions imposed by *bordering*: the
interior collocation rows are augmented with boundary(-derivative) rows
of the basis and the bordered system is inverted once (pseudo-inverse)
and cached. Under the wave equation's homogeneous boundary conditions the
bordered solve collapses to one constant [N, N-2] matrix applied to the
interior values (``homogeneous_interior_operator``), which makes the
wave equation's right-hand side a linear map (equations/we.py).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


def cheb_points(n: int) -> np.ndarray:
    """Chebyshev extremal points cos(i*pi/(n-1)), descending from 1 to -1
    (reference equations/PDEs.py:314-318)."""
    return np.cos(np.arange(n) * np.pi / (n - 1))


def chebyshev_basis(n: int) -> np.ndarray:
    """T[i, j] = T_j(x_i) on the extremal grid (reference :437-456)."""
    x = cheb_points(n)[:, None]
    j = np.arange(n)[None, :]
    return np.cos(j * np.arccos(np.clip(x, -1.0, 1.0)))


def chebder_matrix(n: int, m: int) -> np.ndarray:
    """[n-m, n] map: Chebyshev coefficients -> coefficients of m-th derivative
    (reference :421-435, built column-by-column via np.polynomial)."""
    out = np.zeros((n - m, n))
    for i in range(n):
        c = np.zeros(n)
        c[i] = 1.0
        out[:, i] = np.polynomial.chebyshev.chebder(c, m=m)
    return out


@functools.lru_cache(maxsize=None)
def bordered_diffmat(
    n: int, m: int, bc_orders: Tuple[Tuple[int, Tuple], ...], L: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Boundary-bordered m-th derivative matrix on a domain of length L.

    Args:
        n: number of grid points.
        m: derivative order to compute.
        bc_orders: tuple of (order, (left, right)) — the derivative order of
            each boundary condition and its (left, right) values, with None
            meaning "no condition on that side" (reference :458-517).
        L: domain length |x[0] - x[-1]|.
    Returns:
        (diffmat [n, n_bordered], bc_values [n_bc]): the m-th derivative of u
        is diffmat @ concat([bc_values, u[1:-1]]).
    """
    T = chebyshev_basis(n)
    t0, t1 = T[:1, :], T[-1:, :]
    T_int = T[1:-1, :]
    bc_rows = []
    bc_vals = []
    for order, (left, right) in bc_orders:
        if order > 0:
            D = chebder_matrix(n, order) * (-2.0 / L) ** order
            t0m = t0[:, : n - order] @ D
            t1m = t1[:, : n - order] @ D
        else:
            t0m, t1m = t0, t1
        # Bordering layout matches the reference's concatenation order
        # (PDEs.py:497-508): both -> [left_row, right_row, ...interior].
        if left is not None and right is not None:
            bc_rows = [t0m, t1m] + bc_rows
            bc_vals = [left, right] + bc_vals
        elif left is not None:
            bc_rows = [t0m] + bc_rows
            bc_vals = [left] + bc_vals
        elif right is not None:
            bc_rows = [t1m] + bc_rows
            bc_vals = [right] + bc_vals
    T_bordered = np.concatenate(bc_rows + [T_int], axis=0)
    Tinv = np.linalg.pinv(T_bordered)
    D_m = chebder_matrix(n, m) * (-2.0 / L) ** m
    diffmat = T[:, : n - m] @ D_m @ Tinv
    return diffmat, np.asarray(bc_vals, dtype=float)


def homogeneous_interior_operator(
    n: int, m: int, bc_left_order: int, bc_right_order: int, L: float
) -> np.ndarray:
    """[n, n-2] operator: m-th derivative from interior values under
    homogeneous BCs (value for order 0 / slope for order 1 pinned to zero).

    This is the matrix the wave-equation RHS reduces to; see we.py.
    """
    if bc_left_order == bc_right_order:
        bcs = ((bc_left_order, (0.0, 0.0)),)
    else:
        bcs = ((bc_left_order, (0.0, None)), (bc_right_order, (None, 0.0)))
    diffmat, bc_vals = bordered_diffmat(n, m, bcs, L)
    n_bc = len(bc_vals)
    assert np.all(bc_vals == 0.0)
    return diffmat[:, n_bc:]
