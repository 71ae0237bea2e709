"""Finite-difference and WENO5 spatial operators (counterpart of
msmp_pde_tpu/ops/fd.py).

All operators act on the last axis and broadcast over leading batch axes.
A k-tap correlation is one product of the padded field's sliding windows
(``Tensor.unfold``) with the taps, several stencils stacked as the columns
of one product; the stencil constants are cached per dtype and device, so
no call copies them to the card.

Grid convention: ``nx`` points spanning [0, L] with the two endpoints
identified, u[0] and u[nx-1] being the same physical point. The periodic
pad is therefore u[..., -3:-1] on the left and u[..., 1:3] on the right,
not a circular pad of the whole row.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from msmp_pde_torch.ops import stencils as st

# the WENO5 reconstruction's nine stencils in one product: rows 0-2 the
# smoothness taps A_r, 3-5 the taps B_r, 6-8 the candidate reconstructions
_WENO5_TAPS = np.concatenate(
    [st.WENO5_BETA_A, st.WENO5_BETA_B, st.WENO5_STENCILS])


@functools.lru_cache(maxsize=None)
def _const(name: str, dtype: torch.dtype, device: torch.device):
    arr = _WENO5_TAPS if name == "WENO5_TAPS" else getattr(st, name)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def periodic_pad(u: torch.Tensor, width: int = 2) -> torch.Tensor:
    """Pad the last axis periodically for a duplicated-endpoint grid."""
    return torch.cat([u[..., -width - 1:-1], u, u[..., 1:width + 1]], dim=-1)


def correlate1d(padded: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation of the last axis with taps [k] -> [..., n_out],
    or with the rows of taps [m, k] -> [..., m, n_out]:

    out[..., i] = sum_k taps[k] * padded[..., i + k]
    """
    windows = padded.unfold(-1, taps.shape[-1], 1)  # [..., n_out, k]
    if taps.ndim == 1:
        return windows @ taps
    return (windows @ taps.T).transpose(-1, -2)


def _taps(u: torch.Tensor, name: str) -> torch.Tensor:
    return _const(name, u.dtype, u.device)


# --- FDM derivatives (input must already be periodic_pad'ed by 2). ---------

def fdm_first_derivative(u_padded, dx):
    return correlate1d(u_padded, _taps(u_padded, "FDM_D1")) / dx


def fdm_second_derivative(u_padded, dx):
    return correlate1d(u_padded, _taps(u_padded, "FDM_D2")) / dx**2


def fdm_third_derivative(u_padded, dx):
    return correlate1d(u_padded, _taps(u_padded, "FDM_D3")) / dx**3


def fdm_fourth_derivative(u_padded, dx):
    return correlate1d(u_padded, _taps(u_padded, "FDM_D4")) / dx**4


# --- WENO5 -----------------------------------------------------------------

def weno_pad(u: torch.Tensor, order: int = 3) -> torch.Tensor:
    """Periodic pad by (order - 1) on each side."""
    return periodic_pad(u, width=order - 1)


def weno_reconstruct(u_padded: torch.Tensor) -> torch.Tensor:
    """WENO5 reconstruction: the smoothness-weighted combination of the
    three candidate stencils. Input padded by 2 on each side; output the
    unpadded size."""
    c = correlate1d(u_padded, _taps(u_padded, "WENO5_TAPS"))  # [..., 9, nx]
    b1, b2, cand = c[..., 0:3, :], c[..., 3:6, :], c[..., 6:9, :]
    beta = b1 * b1 + b2 * b2
    gamma = _taps(u_padded, "WENO5_GAMMA")
    w_tilde = gamma[:, None] / (st.WENO5_EPS + beta) ** 2
    w = w_tilde / torch.sum(w_tilde, dim=-2, keepdim=True)
    return torch.sum(w * cand, dim=-2)


def weno_godunov(u_padded: torch.Tensor, dx, flux_fn) -> torch.Tensor:
    """Godunov flux divergence."""
    # right-biased reconstruction: flip, reconstruct, flip back, shift by -1
    rec_plus = torch.flip(weno_reconstruct(torch.flip(u_padded, [-1])), [-1])
    rec_plus = torch.roll(rec_plus, -1, dims=-1)
    rec_minus = weno_reconstruct(u_padded)

    flux_plus = flux_fn(rec_plus)
    flux_minus = flux_fn(rec_minus)
    flux_out = torch.where(
        rec_plus >= rec_minus,
        torch.minimum(flux_minus, flux_plus),
        torch.maximum(flux_minus, flux_plus),
    )
    flux_in = torch.roll(flux_out, 1, dims=-1)
    return (flux_out - flux_in) / dx


def weno_laxfriedrichs(u_padded: torch.Tensor, dx, flux_fn) -> torch.Tensor:
    """Lax-Friedrichs flux divergence, with the per-sample max over the
    spatial axis as the JAX package takes it."""
    f = flux_fn(u_padded)
    alpha = torch.amax(u_padded, dim=-1, keepdim=True)
    f_plus = f + alpha * u_padded
    f_minus = f - alpha * u_padded

    flux_plus = weno_reconstruct(f_plus) / 2.0
    flux_minus = torch.flip(
        weno_reconstruct(torch.flip(f_minus, [-1])), [-1]) / 2.0
    flux_minus = torch.roll(flux_minus, -1, dims=-1)

    flux_out = flux_plus + flux_minus
    flux_in = torch.roll(flux_out, 1, dims=-1)
    return (flux_out - flux_in) / dx
