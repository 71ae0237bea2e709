"""PyTorch port, the Kolmogorov-Fisher equation (equations/kf.py, the KF
initial condition of datagen/ics.py and the KF branch of
datagen/generate.py) against the JAX package, float64.

* ``KF.make_rhs`` with per-sample r and D [B, 1]: the default Dirichlet
  diagonal quirk (-49/18 u / dx^2), the full 6th-order band on a zero pad
  of 3, and the periodic 4th-order stencil: 1e-12;
* one chunk's solve (``generate.kf_solver``: the squared zero-phase sum of
  sines, DOPRI45 at rtol 1e-7, atol 1e-9, at most 14 halvings) against the
  JAX package's ``generate_kf`` program (written out here) from the same
  draws, at nt 20 and nx 40 and 100: 1e-9 (the adaptive steps are the
  same; the values differ by rounding);
* the generate CLI's schema: every resolution of ``RES_KF``, the
  attributes, r and D by groups within their ranges (D log-uniform), the
  first chunk equal to ``kf_solver`` of its draws.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.equations import KF as JKF
from msmp_pde_tpu.temporal import DOPRI45 as JDOPRI45
from msmp_pde_tpu.temporal import solve_adaptive as jsolve_adaptive
from msmp_pde_torch.datagen import generate, hdf5_io, ics
from msmp_pde_torch.equations import KF

from _torch_helpers import one_thread, tt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("bc,quirk", [("dirichlet", True),
                                      ("dirichlet", False),
                                      ("periodic", True)])
def test_make_rhs_matches_jax(bc, quirk):
    rng = np.random.default_rng(5)
    kw = dict(tmax=5.0, grid_size=(250, 40), bc=bc, diag_quirk=quirk)
    u = rng.uniform(size=(3, 40))
    r = rng.uniform(0.0, 2.0, size=(3, 1))
    D = np.exp(rng.uniform(np.log(1e-6), np.log(1e-2), size=(3, 1)))
    got = KF(**kw).make_rhs(r=tt(r), D=tt(D))(0.0, tt(u))
    want = JKF(**kw).make_rhs(r=jnp.asarray(r), D=jnp.asarray(D))(
        0.0, jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    assert KF().lmax == 8 and f"{KF()}" == "KF"


def _jax_kf_solve(pde, r, D, A, l):
    """The JAX package's generate_kf program."""
    tab = dataclasses.replace(JDOPRI45, rtol=1e-7, atol=1e-9)
    x = jnp.linspace(0.0, pde.L, pde.nx)
    ts = jnp.linspace(pde.tmin, pde.tmax, pde.nt)

    def f(r, D, A, l):
        arg = 2.0 * jnp.pi * l * x[:, None] / pde.L
        u0 = jnp.sum(A * jnp.sin(arg), axis=-1) ** 2
        rhs = pde.make_rhs(r=r[:, None], D=D[:, None])
        return jsolve_adaptive(rhs, u0, ts, tab, max_depth=14)

    return np.asarray(jax.jit(f)(*(jnp.asarray(a) for a in (r, D, A, l))))


@pytest.mark.parametrize("nx", [40, 100])
def test_solve_matches_jax(nx):
    kw = dict(tmin=0.0, tmax=5.0, grid_size=(20, nx))
    pde = KF(**kw)
    draws = generate.draw_kf_chunk(np.random.default_rng(nx), 4, 2,
                                   (0.0, 2.0), (1e-6, 1e-2), pde)
    r, D, A, _, _, l = draws
    assert np.array_equal(r[::2], r[1::2]) and np.array_equal(D[::2], D[1::2])
    got = generate.kf_solver(pde, torch.float64, "cpu")(*map(tt, draws))
    want = _jax_kf_solve(JKF(**kw), r, D, A, l)
    assert got.shape == want.shape == (4, 20, nx)
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        got[:, 0].numpy(),
        ics.kf_ic(tt(A), tt(l), tt(np.linspace(0.0, 16.0, nx)), 16.0),
        rtol=1e-12, atol=1e-12)


def test_generate_cli_schema(tmp_path):
    n = {"train": 3, "valid": 2, "test": 2}
    args = generate.build_parser().parse_args(
        ["--experiment=KF", "--device=cpu", "--seed=4", "--chunk=2",
         "--batch_size=2", f"--data_dir={tmp_path}"]
        + [f"--{m}_samples={k}" for m, k in n.items()])
    seconds = generate.main(args)
    assert set(seconds) == {(m, "pde_%d-%d" % res) for m in generate.MODES
                            for res in generate.RES_KF}
    with hdf5_io.open_dataset(str(tmp_path / "KF_KF.npz")) as z, \
            hdf5_io.open_dataset(str(tmp_path / "KF_KF.h5")) as f:
        for mode, k in n.items():
            for nt, nx in generate.RES_KF:
                name = f"{mode}/pde_{nt}-{nx}"
                u, a = z.array(name), z.attrs(name)
                assert u.shape == (k, nt, nx) and np.isfinite(u).all()
                np.testing.assert_array_equal(u, f.array(name))
                pde = KF(tmax=5.0, grid_size=(nt, nx))
                assert float(a["dt"]) == pde.dt and float(a["dx"]) == pde.dx
                assert (float(a["tmin"]), float(a["tmax"])) == (0.0, 5.0)
                np.testing.assert_array_equal(a["x"],
                                              np.linspace(0.0, 16.0, nx))
            r, D = z.array(f"{mode}/r"), z.array(f"{mode}/D")
            assert ((0.0 <= r) & (r <= 2.0)).all()
            assert ((1e-6 <= D) & (D <= 1e-2)).all()
            assert r[0] == r[1] and D[0] == D[1]  # groups of 2
        chunk = z.array("train/pde_250-100")[:2]
    pdes = generate.kf_pdes(5.0)
    draws = generate.draw_kf_chunk(np.random.default_rng(4), 2, 2,
                                   (0.0, 2.0), (1e-6, 1e-2),
                                   pdes["pde_250-200"])
    want = generate.kf_solver(pdes["pde_250-100"], torch.float64, "cpu")(
        *map(tt, draws)).numpy()
    np.testing.assert_array_equal(chunk, want)
