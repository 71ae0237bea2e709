"""PyTorch port, the wave equation (equations/cheb.py, equations/we.py and
the WE branch of datagen/generate.py) against the JAX package, float64.

* the Chebyshev operators (points, basis, coefficient derivative, the
  bordered matrix, the homogeneous interior operator), the wave equation's
  interior operator and its exact propagator for the boundary pairs
  (Dirichlet, Neumann and both mixed orders) at nx 20 and 40: 1e-12;
* the rollout (``we_solve``, 249 products on the CPU) against the JAX
  package's ``generate_we`` program (its ``lax.scan``, written out here)
  from the same initial states: 1e-9 (each product sums in its BLAS's
  order, torch's and XLA's differ, and 249 of them carry the rounding:
  1.8e-11 seen at Neumann); and the generate CLI's stored trajectories are
  that rollout time-reversed (1e-12, the same torch products);
* one Radau sample (``--we_solver radau``) against the JAX package's
  ``_we_radau_solve``: 1e-12 (the same scipy integration), and within its
  tolerance 1e-3 of the exact propagator;
* the CLI schema of WE1 and WE3: every resolution of ``RES_WE``, the
  attributes (the Chebyshev x, dx = L / (nx - 1)), bc_left and bc_right as
  ints, WE3's quirk (bc_left drawn, bc_right Dirichlet), c.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.datagen import generate as jgenerate
from msmp_pde_tpu.equations import cheb as jcheb
from msmp_pde_tpu.equations import we as jwe
from msmp_pde_torch.datagen import generate, hdf5_io
from msmp_pde_torch.equations import cheb, we
from msmp_pde_torch.equations.we import WE

from _torch_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
TOL = dict(rtol=1e-12, atol=1e-12)
PAIRS = [("dirichlet", "dirichlet"), ("neumann", "neumann"),
         ("neumann", "dirichlet"), ("dirichlet", "neumann")]


@pytest.mark.parametrize("n", [20, 40])
def test_cheb_operators_match_jax(n):
    L = 16.0
    np.testing.assert_allclose(cheb.cheb_points(n), jcheb.cheb_points(n),
                               **TOL)
    np.testing.assert_allclose(cheb.chebyshev_basis(n),
                               jcheb.chebyshev_basis(n), **TOL)
    for m in (1, 2):
        np.testing.assert_allclose(cheb.chebder_matrix(n, m),
                                   jcheb.chebder_matrix(n, m), **TOL)
    for bcs in (((0, (0.0, 0.0)),), ((1, (0.0, None)), (0, (None, 0.0)))):
        for a, b in zip(cheb.bordered_diffmat(n, 2, bcs, L),
                        jcheb.bordered_diffmat(n, 2, bcs, L)):
            np.testing.assert_allclose(a, b, **TOL)
    for ol, orr in ((0, 0), (1, 1), (0, 1)):
        np.testing.assert_allclose(
            cheb.homogeneous_interior_operator(n, 2, ol, orr, L),
            jcheb.homogeneous_interior_operator(n, 2, ol, orr, L), **TOL)
    np.testing.assert_allclose(we.cheb_grid_ascending(-8.0, 8.0, n),
                               jwe.cheb_grid_ascending(-8.0, 8.0, n), **TOL)


@pytest.mark.parametrize("n", [20, 40])
@pytest.mark.parametrize("bc_left,bc_right", PAIRS)
def test_propagator_matches_jax(n, bc_left, bc_right):
    L, c, dt = 16.0, 2.0, 100.0 / 249
    got = we.wave_interior_operator(n, bc_left, bc_right, L)
    want = jwe.wave_interior_operator(n, bc_left, bc_right, L)
    assert got.shape == (n, n - 2)
    np.testing.assert_allclose(got, want, **TOL)
    P = we.wave_propagator(n, bc_left, bc_right, L, c, dt)
    assert P.shape == (2 * n, 2 * n)
    np.testing.assert_allclose(
        P, jwe.wave_propagator(n, bc_left, bc_right, L, c, dt), **TOL)
    pde = WE(tmax=100.0, grid_size=(250, n), bc_left=bc_left,
             bc_right=bc_right)
    assert pde.L == 16.0 and pde.dx == 16.0 / (n - 1)
    np.testing.assert_allclose(pde.propagator(c), P, **TOL)


def _jax_rollout(P, states, length):
    """The JAX package's generate_we rollout: [length + 1, B, 2n]."""
    def step(s, _):
        s2 = s @ P.T
        return s2, s2

    _, traj = jax.lax.scan(step, states, None, length=length)
    return np.asarray(jnp.concatenate([states[None], traj], axis=0))


@pytest.mark.parametrize("bc_left,bc_right", PAIRS[:3])
def test_rollout_matches_jax(bc_left, bc_right):
    pde = WE(tmax=100.0, grid_size=(250, 40), bc_left=bc_left,
             bc_right=bc_right)
    starts = np.random.default_rng(1).uniform(-4.0, 4.0, 3)
    states = generate.we_initial_state(pde.x, starts, 2.0)
    got = generate.we_solve(pde, states, 2.0, torch.float64, "cpu")
    want = _jax_rollout(jnp.asarray(pde.propagator(2.0)),
                        jnp.asarray(states), 249)
    assert got.shape == (3, 250, 40)
    np.testing.assert_allclose(got, np.moveaxis(want[..., :40], 1, 0),
                               rtol=1e-9, atol=1e-9)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.5


def test_radau_sample_matches_jax():
    """One sample through scipy's Radau at the reference's tolerances, as
    both packages call it, on a short horizon."""
    pde = WE(tmax=10.0, grid_size=(50, 20), bc_left="neumann",
             bc_right="dirichlet")
    jpde = jwe.WE(tmax=10.0, grid_size=(50, 20), bc_left="neumann",
                  bc_right="dirichlet")
    state = generate.we_initial_state(pde.x, np.array([0.7]), 2.0)
    got = generate.we_solve(pde, state, 2.0, torch.float64, "cpu", "radau")
    t_eval = np.linspace(0.0, 10.0, 50)
    want = jgenerate._we_radau_solve(jpde, jpde.x, state[0], t_eval, 2.0)
    assert got.shape == (1, 50, 20)
    np.testing.assert_allclose(got[0], want[:, :20], **TOL)
    exact = generate.we_solve(pde, state, 2.0, torch.float64, "cpu")
    assert np.abs(got - exact).max() < 0.1  # Radau's rtol = atol = 1e-3


@pytest.mark.parametrize("experiment", ["WE1", "WE3"])
def test_generate_cli_schema(tmp_path, experiment):
    n = {"train": 5, "valid": 2, "test": 3}
    args = generate.build_parser().parse_args(
        [f"--experiment={experiment}", "--device=cpu", "--seed=3",
         f"--data_dir={tmp_path}"] + [f"--{m}_samples={k}"
                                      for m, k in n.items()])
    assert args.wave_speed == 2.0 and args.we_solver == "expm"
    seconds = generate.main(args)
    assert set(seconds) == {(m, "pde_%d-%d" % r) for m in generate.MODES
                            for r in generate.RES_WE}
    assert (250, 20) in generate.RES_WE and len(generate.RES_WE) == 5
    rng = np.random.default_rng(3)
    npz, h5 = (tmp_path / f"WE_{experiment}.{ext}" for ext in ("npz", "h5"))
    with hdf5_io.open_dataset(str(npz)) as z, \
            hdf5_io.open_dataset(str(h5)) as f:
        for mode in generate.MODES:
            bc_l, bc_r, starts = generate.draw_we_mode(
                rng, n[mode], generate.WE_EXPERIMENTS[experiment])
            for key in ("bc_left", "bc_right"):
                for reader in (z, f):
                    v = reader.array(f"{mode}/{key}")
                    assert v.dtype.kind == "i" and v.shape == (n[mode],)
            left, right = (z.array(f"{mode}/bc_{side}")
                           for side in ("left", "right"))
            np.testing.assert_array_equal(left, bc_l)
            np.testing.assert_array_equal(right, bc_r)
            assert (right == 0).all()  # WE3's bc_right stays Dirichlet
            assert set(left) <= {0, 1}
            if experiment == "WE1":
                assert (left == 0).all()
            np.testing.assert_array_equal(z.array(f"{mode}/c"),
                                          np.full(n[mode], 2.0))
            for nt, nx in generate.RES_WE:
                name = f"{mode}/pde_{nt}-{nx}"
                u, a = z.array(name), z.attrs(name)
                assert u.shape == (n[mode], nt, nx) and u.dtype == np.float64
                np.testing.assert_array_equal(u, f.array(name))
                pde = WE(tmax=100.0, grid_size=(nt, nx))
                assert (int(a["nt"]), int(a["nx"])) == (nt, nx)
                assert float(a["dt"]) == 100.0 / 249
                assert float(a["dx"]) == 16.0 / (nx - 1)
                assert (float(a["tmin"]), float(a["tmax"])) == (0.0, 100.0)
                np.testing.assert_array_equal(a["x"], pde.x)
                # the rollout, stored time-reversed
                pde.bc_left = we.BC_NAMES[left[0]]
                sel = left == left[0]
                traj = generate.we_solve(
                    pde, generate.we_initial_state(pde.x, starts[sel], 2.0),
                    2.0, torch.float64, "cpu")
                np.testing.assert_allclose(u[sel], traj[:, ::-1], **TOL)
                np.testing.assert_array_equal(
                    u[sel][:, -1], generate.we_initial_state(
                        pde.x, starts[sel], 2.0)[:, :nx])
