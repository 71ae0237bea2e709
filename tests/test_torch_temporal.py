"""PyTorch port, the time integrators (temporal/erk.py,
temporal/tableaux.py) against the JAX package, float64, on a nonlinear
batched right-hand side (the CE equation's, with a forcing).

Tolerances: one ``erk_step`` of every tableau, with and without
``conserve``, and ``solve_fixed`` at rtol = atol = 1e-12;
``solve_adaptive`` at 1e-10 (the same accept / reject pattern on both
sides, the error summed in another order), in a case that forces
rejections (the first trial step over a long interval fails) and in one
that hits the depth cap (a tolerance no step can meet, max_depth 3).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.equations import CE as JCE
from msmp_pde_tpu.temporal import erk as jerk
from msmp_pde_tpu.temporal import tableaux as jtab
from msmp_pde_torch.equations import CE
from msmp_pde_torch.temporal import erk, tableaux

from _torch_helpers import one_thread, tt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TABLEAUX = ["FORWARD_EULER", "EXPLICIT_MIDPOINT", "RK3", "RK4", "DOPRI45"]
NX = 32


def _problem(seed=0, B=3):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 16.0, NX)
    u0 = (np.sin(2 * np.pi * x / 16.0)[None, None]
          + 0.2 * rng.normal(size=(B, 1, NX)))
    amp = rng.normal(size=(B, 1, NX)) * 0.1
    kw = dict(alpha=1.0, beta=0.05, gamma=0.01, tmax=2.0,
              grid_size=(20, NX))
    rhs = CE(**kw).make_rhs(force=lambda t: tt(amp) * np.cos(t))
    jrhs = JCE(**kw).make_rhs(force=lambda t: jnp.asarray(amp) * jnp.cos(t))
    return u0, rhs, jrhs


def test_tableaux_are_the_jax_packages():
    for name in TABLEAUX:
        a, b = getattr(tableaux, name), getattr(jtab, name)
        assert (a.name, a.order, a.atol, a.rtol) == (b.name, b.order, b.atol,
                                                     b.rtol)
        for f in ("a", "b", "c", "blo"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("conserve", [False, True])
@pytest.mark.parametrize("name", TABLEAUX)
def test_erk_step_matches_jax(name, conserve):
    u0, rhs, jrhs = _problem()
    hi, lo = erk.erk_step(getattr(tableaux, name), rhs, 0.1, tt(u0), 0.05,
                          conserve=conserve)
    jhi, jlo = jerk.erk_step(getattr(jtab, name), jrhs, 0.1, jnp.asarray(u0),
                             0.05, conserve=conserve)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=1e-12,
                               atol=1e-12)
    assert (lo is None) == (jlo is None)
    if lo is not None:
        np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=1e-12,
                                   atol=1e-12)


def test_solve_fixed_matches_jax():
    u0, rhs, jrhs = _problem(1)
    ts = np.linspace(0.0, 1.0, 11)
    got = erk.solve_fixed(rhs, tt(u0), ts, tableaux.RK4)
    want = jerk.solve_fixed(jrhs, jnp.asarray(u0), jnp.asarray(ts), jtab.RK4)
    assert got.shape == (3, 11, 1, NX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def _count_trials(monkeypatch):
    """Count solve_adaptive's trial steps and rejected ones."""
    seen = {"trials": 0, "rejected": 0}
    orig = erk._error_scalar

    def counting(*a):
        err = orig(*a)
        seen["trials"] += 1
        seen["rejected"] += int(err.item() >= 1.0)
        return err

    monkeypatch.setattr(erk, "_error_scalar", counting)
    return seen


@pytest.mark.parametrize("case", ["rejections", "depth_cap"])
def test_solve_adaptive_matches_jax(case, monkeypatch):
    u0, rhs, jrhs = _problem(2)
    tab, jt, depth = tableaux.DOPRI45, jtab.DOPRI45, 12
    if case == "depth_cap":
        # no step meets this tolerance: every interval subdivides to the
        # cap and its one-unit steps are accepted by force
        tab = dataclasses.replace(tab, atol=1e-30, rtol=1e-30)
        jt = dataclasses.replace(jt, atol=1e-30, rtol=1e-30)
        depth = 3
    # two long output intervals: the first trial step over each fails
    ts = np.array([0.0, 0.8, 1.6])
    seen = _count_trials(monkeypatch)
    got = erk.solve_adaptive(rhs, tt(u0), ts, tab, max_depth=depth)
    want = jerk.solve_adaptive(jrhs, jnp.asarray(u0), jnp.asarray(ts), jt,
                               max_depth=depth)
    assert seen["rejected"] > 0
    if case == "depth_cap":
        # each interval: 8 forced one-unit accepts; the aligned steps
        # tried at units 0 (8, 4, 2), 2 (2), 4 (4, 2) and 6 (2) fail
        assert seen["trials"] == 2 * (8 + 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10)


def test_solve_adaptive_needs_an_embedded_tableau():
    u0, rhs, _ = _problem()
    with pytest.raises(ValueError, match="adaptive"):
        erk.solve_adaptive(rhs, tt(u0), [0.0, 0.1], tableaux.RK4)
