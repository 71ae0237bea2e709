"""Initial conditions for dataset generation (counterpart of
msmp_pde_tpu/datagen/ics.py, the sum-of-sines family).

The parameters are drawn on the host from an explicit
``numpy.random.Generator``, so the card and the CPU make the same data
from one seed. The JAX package draws from threefry keys; the two draw
the same distributions, not the same numbers. Draw order, each of shape
[batch, 1, n_waves]: A ~ U(-0.5, 0.5), then omega ~ 0.8 * U(-0.5, 0.5),
then phi ~ U(0, 2 pi), then l ~ randint[lmin, lmax) (high exclusive).

The LCG grid, the von Mises and the square / gaussian samplers come with
the advection family (ROADMAP.md Queue 1 item 15).
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
