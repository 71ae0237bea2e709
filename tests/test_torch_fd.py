"""PyTorch port, the spatial operators (ops/fd.py) and the CE right-hand
side (equations/ce.py::CE.make_rhs) against the JAX package, float64
(tests/conftest.py puts JAX in x64), on numpy-seeded fields.

Tolerance: rtol = atol = 1e-12 on every output. The port sums a
stencil's taps in one product, the JAX package as shifted slices, so the
two differ by float64 rounding only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.equations import CE as JCE
from msmp_pde_tpu.ops import fd as jfd
from msmp_pde_torch.equations import CE
from msmp_pde_torch.ops import fd

from _torch_helpers import one_thread, tt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-12, atol=1e-12)
NX = 40


def _field(seed, shape=(3, 1, NX)):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 16.0, shape[-1])
    # a smooth part and a steep front, so the WENO weights leave the
    # linear limit
    return (np.sin(2 * np.pi * x / 16.0) + 0.3 * rng.normal(size=shape)
            + np.where(x > 8.0, 1.0, 0.0))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_periodic_pad_duplicated_endpoints():
    u = _field(0)
    got = fd.periodic_pad(tt(u))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfd.periodic_pad(jnp.asarray(u))))
    # the identified endpoint is skipped: not a circular pad of the row
    np.testing.assert_array_equal(got[..., :2].numpy(), u[..., -3:-1])


@pytest.mark.parametrize("name", ["fdm_first_derivative",
                                  "fdm_second_derivative",
                                  "fdm_third_derivative",
                                  "fdm_fourth_derivative"])
def test_fdm_derivatives_match_jax(name):
    u = fd.periodic_pad(tt(_field(1)))
    dx = 16.0 / NX
    _close(getattr(fd, name)(u, dx),
           getattr(jfd, name)(jnp.asarray(u.numpy()), dx))


def test_correlate_rows_match_single_taps():
    u = tt(_field(2))
    taps = np.random.default_rng(2).normal(size=(4, 5))
    rows = fd.correlate1d(u, tt(taps))
    for r in range(4):
        _close(rows[..., r, :], jfd.correlate1d(jnp.asarray(u.numpy()),
                                                taps[r]))


def test_weno_reconstruct_matches_jax():
    u = fd.weno_pad(tt(_field(3)))
    _close(fd.weno_reconstruct(u), jfd.weno_reconstruct(jnp.asarray(u.numpy())))


@pytest.mark.parametrize("name", ["weno_godunov", "weno_laxfriedrichs"])
def test_weno_fluxes_match_jax(name):
    u = fd.weno_pad(tt(_field(4)))
    dx = 16.0 / NX
    flux = lambda v: 0.5 * v * v
    _close(getattr(fd, name)(u, dx, flux),
           getattr(jfd, name)(jnp.asarray(u.numpy()), dx, flux))


@pytest.mark.parametrize("splitting", ["godunov", "laxfriedrichs"])
def test_ce_rhs_per_sample_coefficients_and_forcing(splitting):
    B = 3
    rng = np.random.default_rng(5)
    u = _field(5, (B, 1, NX))
    coefs = [rng.uniform(0.1, 3.0, size=(B, 1, 1)) for _ in range(3)]
    amp = rng.normal(size=(B, 1, NX))
    x = np.linspace(0.0, 16.0, NX)
    kw = dict(tmax=4.0, grid_size=(250, NX), flux_splitting=splitting)
    rhs = CE(**kw).make_rhs(*(tt(c) for c in coefs),
                            force=lambda t: tt(amp) * torch.sin(t + tt(x)))
    jrhs = JCE(**kw).make_rhs(
        *(jnp.asarray(c) for c in coefs),
        force=lambda t: jnp.asarray(amp) * jnp.sin(t + jnp.asarray(x)))
    for t in (0.0, 0.37):
        _close(rhs(t, tt(u)), jrhs(t, jnp.asarray(u)))
    # the instance's scalar coefficients, no forcing
    _close(CE(**kw).make_rhs()(0.0, tt(u)), JCE(**kw).make_rhs()(0.0,
                                                               jnp.asarray(u)))


def test_ce_rhs_rejects_unknown_splitting():
    with pytest.raises(ValueError, match="flux splitting"):
        CE(flux_splitting="upwind").make_rhs()
