"""PyTorch port, E1 data generation (datagen/ics.py, datagen/hdf5_io.py,
datagen/generate.py) and the dataset reader (data/dataset.py) against the
JAX package, float64.

* the CE solve of one chunk (``generate.ce_solver``: the sum of sines as
  the initial condition and as the forcing, ``CE.make_rhs``,
  ``solve_adaptive`` with ``DOPRI45``) against the JAX package's
  (``generate_ce``'s program, written out here) from the same parameter
  draws, E1's coefficients and time grid, at nx 100 and 200: rtol = atol =
  1e-9 over the 250 output times;
* the generate CLI end to end on the CPU (E1, the four resolutions),
  read back by the port's ``PDEDataset`` from the ``.npz`` and from the
  ``.h5``, and by the JAX package's ``PDEDataset`` from the ``.h5``:
  equal arrays;
* ``_avg_downproject`` bitwise against the JAX package's numpy path;
* ``sum_of_sines`` at rtol = atol = 1e-12, the sine parameters'
  distributions, and the entry points' device rule (and that RPU
  generates).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.data import dataset as jdataset
from msmp_pde_tpu.datagen import ics as jics
from msmp_pde_tpu.equations import CE as JCE
from msmp_pde_tpu.temporal import DOPRI45 as JDOPRI45
from msmp_pde_tpu.temporal import solve_adaptive as jsolve_adaptive
from msmp_pde_tpu.utils import native
from msmp_pde_torch.data.dataset import PDEDataset, _avg_downproject
from msmp_pde_torch.datagen import generate, hdf5_io, ics
from msmp_pde_torch.equations import CE

from _torch_helpers import one_thread, tt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _jax_ce_solve(pde, A, omega, phi, l):
    """The JAX package's generate_ce program for E1's coefficients."""
    x = jnp.asarray(np.linspace(0.0, pde.L, pde.nx))
    ts = jnp.asarray(np.linspace(pde.tmin, pde.tmax, pde.nt))

    def f(al, be, ga, A, omega, phi, l):
        def force(t):
            arg = omega * t + 2.0 * jnp.pi * l * x[:, None] / pde.L + phi
            return jnp.sum(A * jnp.sin(arg), axis=-1)[:, None, :]

        return jsolve_adaptive(pde.make_rhs(al, be, ga, force), force(0.0),
                               ts, JDOPRI45)

    ones = jnp.ones((A.shape[0], 1, 1))
    return np.asarray(jax.jit(f)(ones, 0.0 * ones, 0.0 * ones,
                                 *(jnp.asarray(a) for a in (A, omega, phi,
                                                            l))))


@pytest.mark.parametrize("nx", [100, 200])
def test_ce_solve_matches_jax(nx):
    B = 2
    A, omega, phi, l = ics.sample_sine_params(np.random.default_rng(nx), B,
                                              5, 1, 3)
    kw = dict(tmin=0.0, tmax=4.0, grid_size=(250, nx))
    solve = generate.ce_solver(CE(**kw), torch.float64, "cpu")
    ones = torch.ones((B, 1, 1), dtype=torch.float64)
    got = solve(ones, 0 * ones, 0 * ones, *(tt(a) for a in (A, omega, phi,
                                                           l)))
    want = _jax_ce_solve(JCE(**kw), A, omega, phi, l)
    assert got.shape == want.shape == (B, 250, 1, nx)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)


def test_sine_params_distributions():
    A, omega, phi, l = ics.sample_sine_params(np.random.default_rng(0),
                                              4000, 5, 1, 3)
    assert A.shape == omega.shape == phi.shape == l.shape == (4000, 1, 5)
    assert -0.5 <= A.min() and A.max() < 0.5
    assert -0.4 <= omega.min() and omega.max() < 0.4
    assert 0.0 <= phi.min() and phi.max() < 2 * np.pi
    assert set(np.unique(l)) == {1.0, 2.0}  # randint high is exclusive
    assert abs(A.mean()) < 0.02 and abs(l.mean() - 1.5) < 0.03


def test_sum_of_sines_matches_jax():
    params = ics.sample_sine_params(np.random.default_rng(2), 3, 5, 1, 3)
    x = np.linspace(0.0, 16.0, 50)
    f = ics.sum_of_sines(*(tt(a) for a in params), 16.0)
    jf = jics.sum_of_sines(*(jnp.asarray(a) for a in params), 16.0)
    for t in (0.0, 1.3):
        np.testing.assert_allclose(f(tt(x), t).numpy(),
                                   np.asarray(jf(jnp.asarray(x), t)),
                                   rtol=1e-12, atol=1e-12)


def test_avg_downproject_bitwise_jax_numpy_path(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    u = np.random.default_rng(1).normal(size=(3, 50, 200))
    for ratio in (2, 4, 5):
        np.testing.assert_array_equal(
            _avg_downproject(u, ratio),
            jdataset._avg_downproject(u, ratio, "periodic"))


def _args(out, *extra):
    return generate.build_parser().parse_args(
        ["--experiment=E1", "--train_samples=2", "--valid_samples=1",
         "--test_samples=1", "--chunk=2", "--batch_size=2", "--device=cpu",
         f"--data_dir={out}", *extra])


def test_generate_cli_schema_and_readers(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    seconds = generate.main(_args(tmp_path))
    assert set(seconds) == {(m, "pde_%d-%d" % r) for m in generate.MODES
                            for r in generate.RES_CE}
    npz, h5 = tmp_path / "CE_E1.npz", tmp_path / "CE_E1.h5"
    assert npz.exists() and h5.exists()
    assert not (tmp_path / "CE_E1.npz.tmp").exists()
    with hdf5_io.open_dataset(str(npz)) as z, \
            hdf5_io.open_dataset(str(h5)) as f:
        for mode, n in (("train", 2), ("valid", 1), ("test", 1)):
            for nt, nx in generate.RES_CE:
                name = f"{mode}/pde_{nt}-{nx}"
                u = z.array(name)
                assert u.shape == (n, nt, nx) and u.dtype == np.float64
                assert np.isfinite(u).all()
                np.testing.assert_array_equal(u, f.array(name))
                za, fa = z.attrs(name), f.attrs(name)
                pde = CE(tmax=4.0, grid_size=(nt, nx))
                assert float(za["dt"]) == pde.dt and float(za["dx"]) == pde.dx
                assert int(za["nt"]) == nt and int(za["nx"]) == nx
                assert (float(za["tmin"]), float(za["tmax"])) == (0.0, 4.0)
                np.testing.assert_array_equal(za["x"],
                                              np.linspace(0.0, 16.0, nx))
                for a in hdf5_io.ATTRS:
                    np.testing.assert_array_equal(za[a], fa[a])
            # E1: alpha 1, beta 0, gamma 0, stored as drawn
            for name, v in (("alpha", 1.0), ("beta", 0.0), ("gamma", 0.0)):
                np.testing.assert_array_equal(z.array(f"{mode}/{name}"),
                                              np.full(n, v))

    pde = CE(tmax=4.0, grid_size=(250, 100))
    jpde = JCE(tmax=4.0, grid_size=(250, 100))
    for mode in generate.MODES:
        sets = [PDEDataset(str(npz), pde, mode), PDEDataset(str(h5), pde, mode),
                jdataset.PDEDataset(str(h5), jpde, mode)]
        for ds in sets[1:]:
            for attr in ("u_base", "u_super", "x"):
                a, b = getattr(sets[0], attr), getattr(ds, attr)
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            assert (ds.nt, ds.dt, ds.dx, ds.tmin, ds.tmax) == (
                sets[0].nt, sets[0].dt, sets[0].dx, sets[0].tmin,
                sets[0].tmax)
            for k, v in sets[0].variables.items():
                np.testing.assert_array_equal(v, ds.variables[k])
        assert sets[0].u_super.shape == (len(sets[0]), 250, 100)


def test_nonfinite_values_warn(tmp_path, capsys):
    res = {"pde_4-3": dict(nt=4, nx=3, dt=1.0, dx=1.0, tmin=0.0, tmax=3.0,
                           x=np.arange(3.0))}
    with hdf5_io.DatasetWriter(str(tmp_path / "d")) as out:
        w = out.mode("train", 2, res)
        w.write("pde_4-3", 0, np.full((2, 4, 3), np.nan))
    assert "WARNING: 24/24 non-finite values" in capsys.readouterr().out


def test_generate_device_rule_and_families(tmp_path):
    args = generate.build_parser().parse_args(
        ["--experiment=E1", f"--data_dir={tmp_path}"])
    assert args.device == "cuda" and args.dtype == "float64"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate.main(args)
    args.experiment = "nope"
    with pytest.raises(ValueError, match="unknown experiment"):
        generate.main(args)
    assert not os.listdir(tmp_path)
    # RPU is a family of its own now: it writes AD_RPU on its LCG grid
    args = generate.build_parser().parse_args(
        ["--experiment=RPU", "--train_samples=1", "--valid_samples=1",
         "--test_samples=1", "--device=cpu", f"--data_dir={tmp_path}"])
    generate.main(args)
    with hdf5_io.open_dataset(str(tmp_path / "AD_RPU.npz")) as z:
        np.testing.assert_array_equal(
            z.attrs("test/pde_250-100")["x"],
            ics.pseudo_random_grid(0.0, 16.0, 100))
