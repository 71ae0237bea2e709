"""PyTorch port, the evaluation metrics (training/metrics.py) against the
JAX package's (msmp_pde_tpu/training/metrics.py), float64, on an
MSMP-PDE of hidden 96 with two gated pairs (nx 24, tw 20, nt 100) whose
weights are carried from the JAX parameters by ``params_from_flax``.

Each metric runs with the set divisible by the batch (4 samples, batch 2)
and not (3 samples, batch 2: the short last batch weighs as much as a
full one in the one-step and unrolled losses); the L2 norms also with one
short batch (3 samples, batch 4) and over the first two windows only. The JAX ``compute_l2_norms`` raises where a short batch follows
full ones; there the port is held against the JAX package's
``l2_norms_from_store(rollout_store(...))``, the same per-sample mean.
Tolerance: rtol = atol = 1e-9 on every value.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from msmp_pde_tpu.training import metrics as jmetrics
from msmp_pde_torch.training import metrics

from _torch_helpers import one_thread, tt  # noqa: F401
from test_torch_train import _trainers

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-9, atol=1e-9)
TW, NT, NR_GT = 20, 100, 2
QUIET = dict(log=lambda *a: None)


@pytest.fixture(scope="module")
def pair():
    jtr, params, trainer = _trainers(TW, NT)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(4, NT, 24)) * 0.5
    ub = u + 0.1 * rng.normal(size=u.shape)
    return jtr, params, trainer, u, ub


CASES = [(4, 2), (3, 2)]  # (samples, batch)


@pytest.mark.parametrize("n,bs", CASES)
def test_timestep_losses_match_jax(pair, n, bs):
    jtr, params, trainer, u, _ = pair
    got = metrics.test_timestep_losses(trainer, tt(u[:n]), {}, bs, NT,
                                       **QUIET)
    want = jmetrics.test_timestep_losses(jtr, params, jnp.asarray(u[:n]), {},
                                         bs, NT, **QUIET)
    assert list(got) == list(want) == [20, 40, 60, 80]
    np.testing.assert_allclose([got[s] for s in got],
                               [want[s] for s in want], **TOL)


@pytest.mark.parametrize("n,bs", CASES)
def test_unrolled_losses_match_jax(pair, n, bs):
    jtr, params, trainer, u, ub = pair
    got = metrics.test_unrolled_losses(trainer, tt(u[:n]), tt(ub[:n]), {}, bs,
                                       NR_GT, NT, 24, **QUIET)
    want = jmetrics.test_unrolled_losses(
        jtr, params, jnp.asarray(u[:n]), jnp.asarray(ub[:n]), {}, bs, NR_GT,
        NT, 24, **QUIET)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n,bs,max_windows", [(4, 2, 0), (4, 2, 2),
                                              (3, 2, 0), (3, 4, 0)])
def test_l2_norms_match_jax(pair, n, bs, max_windows):
    jtr, params, trainer, u, _ = pair
    got = metrics.compute_l2_norms(trainer, tt(u[:n]), {}, bs, NR_GT, NT,
                                   max_windows=max_windows, **QUIET)
    args = (jtr, params, jnp.asarray(u[:n]), {}, bs, NR_GT, NT)
    if n % bs and n > bs:
        with pytest.raises(ValueError):  # the JAX package stacks batches
            jmetrics.compute_l2_norms(*args, **QUIET)
        want = jmetrics.l2_norms_from_store(
            *jmetrics.rollout_store(*args), **QUIET)
    else:
        want = jmetrics.compute_l2_norms(*args, max_windows=max_windows,
                                         **QUIET)
    np.testing.assert_allclose(got, want, **TOL)


def test_rollout_store_and_norms_from_it_match_jax(pair):
    """Two windows past the data horizon, whose targets are zeros."""
    jtr, params, trainer, u, _ = pair
    n_more = 2
    p, t = metrics.rollout_store(trainer, tt(u[:3]), {}, 2, NR_GT, NT,
                                 n_more_rollout=n_more)
    jp, jt = jmetrics.rollout_store(jtr, params, jnp.asarray(u[:3]), {}, 2,
                                    NR_GT, NT, n_more_rollout=n_more)
    assert p.shape == jp.shape == (3, (3 + n_more) * TW, 1, 24)
    np.testing.assert_allclose(p, jp, **TOL)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(metrics.l2_norms_from_store(p, t, **QUIET),
                               jmetrics.l2_norms_from_store(jp, jt, **QUIET),
                               **TOL)
    with np.errstate(divide="ignore"):  # zero targets past the horizon
        for a, b in zip(metrics.compute_space_l2_norms(p, t),
                        jmetrics.compute_space_l2_norms(jp, jt)):
            np.testing.assert_allclose(a, b, **TOL)
