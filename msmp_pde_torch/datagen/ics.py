"""Initial conditions for dataset generation (counterpart of
msmp_pde_tpu/datagen/ics.py): the sum of sines, KF's squared zero-phase
sum of sines and KS's sum of sines on its periodic domain (both from
``sample_sine_params``' draws, msmp_pde_tpu/datagen/generate.py:264-266
and :354-356), and the advection system's square, sinesum, gaussian and
gaussian_triple families.

The parameters are drawn on the host from an explicit
``numpy.random.Generator``, so the card and the CPU make the same data
from one seed. The JAX package draws from threefry keys; the two draw
the same distributions, not the same numbers. Draw order, each of shape
[batch, 1, n_waves]: A ~ U(-0.5, 0.5), then omega ~ 0.8 * U(-0.5, 0.5),
then phi ~ U(0, 2 pi), then l ~ randint[lmin, lmax) (high exclusive).

The advection families draw their parameters with ``sample_*_ic`` (numpy
arrays, in the order each docstring gives) and evaluate them with the
matching ``*_ic`` builder, whose ``u0_fn(pts [B, M]) -> [B, 2, M]`` takes
points already shifted along the characteristics and wraps them into
[0, L). ``pseudo_random_grid`` is RPU's unstructured grid, the
reference's integer LCG, bitwise the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch


def sample_sine_params(rng: np.random.Generator, batch: int, n_waves: int,
                       lmin: int, lmax: int):
    """(A, omega, phi, l) as numpy float64 arrays [batch, 1, n_waves]."""
    shape = (batch, 1, n_waves)
    A = rng.uniform(size=shape) - 0.5
    omega = 0.8 * (rng.uniform(size=shape) - 0.5)
    phi = 2.0 * np.pi * rng.uniform(size=shape)
    l = rng.integers(lmin, lmax, size=shape).astype(np.float64)
    return A, omega, phi, l


def sum_of_sines(A, omega, phi, l, L):
    """f(x, t) -> [B, nx] with u(x, t) = sum_k A_k sin(omega_k t +
    2 pi l_k x / L + phi_k); the parameters are [B, 1, N] tensors, x [nx]."""

    def fnc(x, t=0.0):
        arg = omega * t + 2.0 * torch.pi * l * x[:, None] / L + phi
        return torch.sum(A * torch.sin(arg), dim=-1)

    return fnc


def kf_ic(A, l, x, L):
    """KF's initial condition [B, nx]: (sum_k A_k sin(2 pi l_k x / L))^2,
    the sum of sines without its phases, squared; A and l [B, 1, N]
    tensors, x [nx]."""
    arg = 2.0 * torch.pi * l * x[:, None] / L
    return torch.sum(A * torch.sin(arg), dim=-1) ** 2


def ks_ic(A, phi, l, x, L):
    """KS's initial condition [B, nx] on x [nx] in [0, 2 pi L]: sum_k A_k
    sin(2 pi l_k (x / 2 pi) / L + phi_k); A, phi, l [B, 1, N] tensors."""
    arg = 2.0 * torch.pi * l * (x / (2.0 * torch.pi))[:, None] / L + phi
    return torch.sum(A * torch.sin(arg), dim=-1)


def pseudo_random_grid(xmin: float, xmax: float, n: int) -> np.ndarray:
    """RPU's unstructured grid [n], float64: the LCG n_{k+1} = (75 n_k +
    74) mod (2^16 + 1) from n_0 = 74 in exact integers, scaled by its
    maximum onto [xmin, xmax], sorted, the ends pinned to xmin and
    xmax."""
    c, p, a = 74, 2**16 + 1, 75
    ns = [c % p]
    for _ in range(n - 1):
        ns.append((a * ns[-1] + c) % p)
    ns = np.asarray(ns, dtype=float)
    ns = ns / ns.max()
    ns = ns * (xmax - xmin) + xmin
    ns = np.sort(ns)
    ns[0] = xmin
    ns[-1] = xmax
    return ns


def von_mises_pdf(x, kappa, loc=0.0):
    """Wrapped-Gaussian density exp(kappa cos(x - loc)) / (2 pi I0(kappa)),
    in the exponentially scaled form exp(kappa (cos(x - loc) - 1)) /
    (2 pi i0e(kappa)), which stays finite at MSWG3's kappa up to 150."""
    return (torch.exp(kappa * (torch.cos(x - loc) - 1.0))
            / (2.0 * torch.pi * torch.special.i0e(kappa)))


# --- the advection system's initial conditions -----------------------------
def sample_square_ic(rng: np.random.Generator, batch: int, nx: int,
                     L: float):
    """Two breakpoint pairs drawn from the integers [0, nx), [batch, 2, 2],
    scaled by L / nx: (lo, hi) [batch, 2], the smaller and the larger of
    each pair."""
    bounds = L * rng.integers(0, nx, size=(batch, 2, 2)).astype(
        np.float64) / nx
    return bounds.min(axis=1), bounds.max(axis=1)


def square_ic(lo, hi, L):
    """u1 the indicator of (lo, hi) of the first pair, u2 = 0."""

    def u0_fn(pts):
        p = torch.remainder(pts, L)
        u1 = ((p > lo[:, 0:1]) & (torch.abs(p) < hi[:, 0:1])).to(p.dtype)
        return torch.stack([u1, torch.zeros_like(u1)], dim=1)

    return u0_fn


def sample_sinesum_ic(rng: np.random.Generator, batch: int, n_waves=5,
                      lmin=1, lmax=3):
    """Sum-of-sines parameters of 2 batch rows (``sample_sine_params``'s
    draws, [2 batch, 1, n_waves] each): rows 2i and 2i + 1 are sample i's
    two components."""
    return sample_sine_params(rng, 2 * batch, n_waves, lmin, lmax)


def sinesum_ic(A, omega, phi, l, L):
    """u0_fn of ``sample_sinesum_ic``'s parameters (tensors): each
    component a sum of sines at t = 0."""

    def u0_fn(pts):
        p = torch.remainder(pts, L)
        p2 = torch.repeat_interleave(p, 2, dim=0)  # rows (2i, 2i + 1)
        arg = omega * 0.0 + 2.0 * torch.pi * l * p2[:, :, None] / L + phi
        vals = torch.sum(A * torch.sin(arg), dim=-1)  # [2B, M]
        return vals.reshape(pts.shape[0], 2, pts.shape[1])

    return u0_fn


def sample_gaussian_ic(rng: np.random.Generator, batch: int):
    """kappa ~ U(1e-5, 10), [batch, 1]."""
    return (1e-5 + rng.uniform(size=(batch, 1)) * (10.0 - 1e-5),)


def gaussian_ic(kappa, L):
    """u1 a wrapped Gaussian at pi of sharpness kappa, u2 = 1."""

    def u0_fn(pts):
        u1 = von_mises_pdf(torch.remainder(pts, L), kappa, loc=torch.pi)
        return torch.stack([u1, torch.ones_like(u1)], dim=1)

    return u0_fn


def sample_gaussian_triple_ic(rng: np.random.Generator, batch: int):
    """scales ~ U(0, 1), then sharpnesses ~ U(50, 150), each [batch, 3,
    1]."""
    scales = rng.uniform(size=(batch, 3, 1))
    sharps = 50.0 + rng.uniform(size=(batch, 3, 1)) * 100.0
    return scales, sharps


def gaussian_triple_ic(scales, sharps, L):
    """u1 the scaled sum of three wrapped Gaussians at pi/2, pi and 3 pi/2,
    u2 = 1."""

    def u0_fn(pts):
        p = torch.remainder(pts, L)
        locs = torch.tensor([np.pi / 2.0, np.pi, 3.0 * np.pi / 2.0],
                            dtype=pts.dtype, device=pts.device)[None, :, None]
        comps = von_mises_pdf(p[:, None, :], sharps, loc=locs)  # [B, 3, M]
        u1 = torch.sum(scales * comps, dim=1)
        return torch.stack([u1, torch.ones_like(u1)], dim=1)

    return u0_fn


# family -> (the parameters' sampler, their builder)
AD_ICS = {
    "square": (sample_square_ic, square_ic),
    "sinesum": (sample_sinesum_ic, sinesum_ic),
    "gaussian": (sample_gaussian_ic, gaussian_ic),
    "gaussian_triple": (sample_gaussian_triple_ic, gaussian_triple_ic),
}
