"""PyTorch port, the linear advection system (equations/ad.py, the AD
families of datagen/ics.py, datagen/generate.py::generate_rp, the AD
branch of data/dataset.py, training/setup.py and serving/engine.py's grid)
against the JAX package, float64.

* the exact characteristic solve (``exact_solution_batch``) of every
  initial-condition family from the same parameters: 1e-12;
* the four formulas (the wrapped Gaussian's density, the sinesum,
  gaussian and gaussian_triple fields) at points inside and outside
  [0, L): 1e-12;
* the generate CLI's RP, MSWG and MSWG3 on the CPU: the schema of the JAX
  CLI (``tests/test_datagen.py:71``: keys, shapes [n, 2, nt, nx],
  attributes, coefficient groups and ranges), ``.npz`` equal to ``.h5``;
* the AD dataset's down-projection, the port's ``PDEDataset`` on the
  ``.npz`` and the ``.h5`` against the JAX ``PDEDataset`` on the ``.h5``:
  equal arrays;
* the experiments' PDEs and the served grid against the JAX package's;
  RPU's PDE and its LCG grids in the generate CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.data import dataset as jdataset
from msmp_pde_tpu.datagen import ics as jics
from msmp_pde_tpu.equations.ad import exact_solution_batch as jexact
from msmp_pde_tpu.serving.engine import grid_from_h5 as jgrid_from_h5
from msmp_pde_tpu.training import setup as jsetup
from msmp_pde_torch.data.dataset import PDEDataset
from msmp_pde_torch.datagen import generate, hdf5_io, ics
from msmp_pde_torch.equations.ad import exact_solution_batch
from msmp_pde_torch.serving.engine import grid_from_h5
from msmp_pde_torch.training import setup

from _torch_helpers import one_thread, tt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# family -> (the JAX sampler's call, L)
FAMILIES = {
    "sinesum": (lambda key, B: jics.sample_sinesum_ic(key, B, 16.0, 5, 1, 3),
                16.0),
    "gaussian": (lambda key, B: jics.sample_gaussian_ic(key, B, 2 * np.pi),
                 2 * np.pi),
    "gaussian_triple": (
        lambda key, B: jics.sample_gaussian_triple_ic(key, B, 2 * np.pi),
        2 * np.pi),
}


def _ics(family, B=3, seed=0):
    """(the JAX u0_fn, the port's u0_fn) of one draw of the JAX sampler."""
    sample, L = FAMILIES[family]
    params, jfn = sample(jax.random.PRNGKey(seed), B)
    if family == "gaussian":
        params = (params,)
    build = ics.AD_ICS[family][1]
    return jfn, build(*(tt(np.asarray(p)) for p in params), L), L


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_exact_solution_matches_jax(family):
    jfn, fn, L = _ics(family)
    rng = np.random.default_rng(1)
    a, b = rng.uniform(0.1, 1.0, 3), rng.uniform(1.0, 10.0, 3)
    x, t = np.linspace(0.0, L, 50), np.linspace(0.0, 4.0, 30)
    want = np.asarray(jexact(jfn, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(a), jnp.asarray(b)))
    got = exact_solution_batch(fn, tt(x), tt(t), tt(a), tt(b)).numpy()
    assert got.shape == (3, 2, 30, 50)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # at t = 0 the solution is the initial condition
    np.testing.assert_allclose(got[:, :, 0],
                               fn(tt(np.tile(x, (3, 1)))).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["von_mises"])
def test_ic_formulas_match_jax(family):
    pts = np.random.default_rng(2).uniform(-20.0, 30.0, (3, 64))
    if family == "von_mises":
        kappa = np.array([[1e-5], [3.0], [150.0]])
        want = np.asarray(jics.von_mises_pdf(jnp.asarray(pts),
                                             jnp.asarray(kappa), loc=np.pi))
        got = ics.von_mises_pdf(tt(pts), tt(kappa), loc=np.pi).numpy()
    else:
        jfn, fn, _ = _ics(family, seed=3)
        want, got = np.asarray(jfn(jnp.asarray(pts))), fn(tt(pts)).numpy()
        assert got.shape == (3, 2, 64)
        if family != "sinesum":
            assert (got[:, 1] == 1.0).all() and (got[:, 0] >= 0).all()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_ic_draws_distributions():
    rng = np.random.default_rng(4)
    (kappa,) = ics.sample_gaussian_ic(rng, 500)
    scales, sharps = ics.sample_gaussian_triple_ic(rng, 500)
    A = ics.sample_sinesum_ic(rng, 250, 5, 1, 3)[0]
    assert kappa.shape == (500, 1) and A.shape == (500, 1, 5)
    assert scales.shape == sharps.shape == (500, 3, 1)
    assert 1e-5 <= kappa.min() and kappa.max() < 10.0
    assert 0.0 <= scales.min() and scales.max() < 1.0
    assert 50.0 <= sharps.min() and sharps.max() < 150.0


def _generate(tmp_path, experiment, n=(4, 2, 2)):
    argv = [f"--experiment={experiment}", "--chunk=4", "--batch_size=2",
            "--device=cpu", f"--data_dir={tmp_path}"]
    argv += [f"--{m}_samples={k}" for m, k in zip(generate.MODES, n)]
    return generate.main(generate.build_parser().parse_args(argv))


@pytest.mark.parametrize("experiment", ["RP", "MSWG", "MSWG3"])
def test_generate_cli_schema(tmp_path, experiment):
    """The JAX CLI's schema (tests/test_datagen.py:71): keys, [n, 2, nt,
    nx] trajectories, attributes, a and b shared by groups of batch_size
    within their ranges; the .npz equal to the .h5."""
    tmax, a_range, b_range, family = generate.AD_EXPERIMENTS[experiment]
    L = 16.0 if family == "sinesum" else 2 * np.pi
    seconds = _generate(tmp_path, experiment)
    assert set(seconds) == {(m, "pde_%d-%d" % r) for m in generate.MODES
                            for r in generate.RES_AD}
    npz = tmp_path / f"AD_{experiment}.npz"
    h5 = tmp_path / f"AD_{experiment}.h5"
    with hdf5_io.open_dataset(str(npz)) as z, \
            hdf5_io.open_dataset(str(h5)) as f:
        for mode, n in zip(generate.MODES, (4, 2, 2)):
            for nt, nx in generate.RES_AD:
                name = f"{mode}/pde_{nt}-{nx}"
                u, at = z.array(name), z.attrs(name)
                assert u.shape == (n, 2, nt, nx) and u.dtype == np.float64
                assert np.isfinite(u).all()
                np.testing.assert_array_equal(u, f.array(name))
                assert int(at["nt"]) == nt and int(at["nx"]) == nx
                assert float(at["dt"]) == tmax / (nt - 1)
                assert float(at["dx"]) == L / nx
                assert (float(at["tmin"]), float(at["tmax"])) == (0.0, tmax)
                np.testing.assert_array_equal(at["x"],
                                              np.linspace(0.0, L, nx))
                for k in hdf5_io.ATTRS:
                    np.testing.assert_array_equal(at[k], f.attrs(name)[k])
            a, b = z.array(f"{mode}/a"), z.array(f"{mode}/b")
            np.testing.assert_array_equal(a, f.array(f"{mode}/a"))
            assert a[0] == a[1] and b[0] == b[1]
            assert a_range[0] <= a.min() and a.max() <= a_range[1]
            assert b_range[0] <= b.min() and b.max() <= b_range[1]


def test_generate_solves_the_draws(tmp_path):
    """The first train chunk is the exact solve of ``draw_ad_chunk``'s
    draws from the seed, at every resolution."""
    _generate(tmp_path, "RP", n=(4, 1, 1))
    tmax, a_range, b_range, family = generate.AD_EXPERIMENTS["RP"]
    pdes = generate.ad_pdes(tmax, family)
    draws = generate.draw_ad_chunk(np.random.default_rng(0), 4, 2, a_range,
                                   b_range, family, next(iter(pdes.values())))
    with hdf5_io.open_dataset(str(tmp_path / "AD_RP.npz")) as z:
        for k, pde in pdes.items():
            want = generate.ad_solver(pde, family, torch.float64, "cpu")(
                *(torch.as_tensor(d) for d in draws)).numpy()
            np.testing.assert_array_equal(z.array(f"train/{k}"), want)
        np.testing.assert_array_equal(z.array("train/a"), draws[0])


def test_dataset_matches_jax(tmp_path):
    """The AD down-projection (temporal stride, every second point, [N, nt,
    2, nx]) of the port's reader on the .npz and the .h5 against the JAX
    reader on the .h5, and the served grid's attrs-only read."""
    from msmp_pde_tpu.equations import AD as JAD
    from msmp_pde_torch.equations import AD

    _generate(tmp_path, "RP")
    npz, h5 = str(tmp_path / "AD_RP.npz"), str(tmp_path / "AD_RP.h5")
    pde = AD(tmax=4.0, grid_size=(250, 100), L=16.0)
    jpde = JAD(tmax=4.0, grid_size=(250, 100), L=16.0)
    for mode in generate.MODES:
        sets = [PDEDataset(npz, pde, mode), PDEDataset(h5, pde, mode),
                jdataset.PDEDataset(h5, jpde, mode)]
        for ds in sets[1:]:
            for attr in ("u_base", "u_super", "x"):
                a, b = getattr(sets[0], attr), getattr(ds, attr)
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            assert (ds.nt, ds.dt, ds.dx, ds.tmin, ds.tmax) == (
                sets[0].nt, sets[0].dt, sets[0].dx, sets[0].tmin,
                sets[0].tmax)
            assert ds.variables.keys() == {"a", "b"}
            for k, v in sets[0].variables.items():
                np.testing.assert_array_equal(v, ds.variables[k])
            assert ds.n_components == 2
        assert sets[0].u_super.shape == (len(sets[0]), 250, 2, 100)
        assert sets[0].u_base.shape == (len(sets[0]), 250, 2, 100)
    with hdf5_io.open_dataset(h5) as f:
        raw = f.array("test/pde_250-200")
    np.testing.assert_array_equal(
        sets[0].u_super, np.swapaxes(raw[..., 0:-1:2], 1, 2).astype(
            np.float32))
    got = grid_from_h5(npz, pde, "test", (250, 100), (250, 200))
    want = jgrid_from_h5(h5, jpde, "test", (250, 100), (250, 200))
    np.testing.assert_array_equal(got.x, want.x)
    assert (got.nt, got.dt, got.tmin, got.tmax, got.n_components) == (
        want.nt, want.dt, want.tmin, want.tmax, want.n_components) == (
        250, 4.0 / 249, 0.0, 4.0, 2)


@pytest.mark.parametrize("experiment", ["RP", "MSWG", "MSWG3"])
def test_experiment_pde_matches_jax(experiment):
    for res in ((250, 100), (500, 40)):
        got = setup.pde_for_experiment(experiment, res)
        want = jsetup.pde_for_experiment(experiment, res)
        assert f"{got}" == f"{want}" == "AD"
        assert (got.tmax, got.L, got.grid_size, got.dt, got.dx) == (
            want.tmax, want.L, want.grid_size, want.dt, want.dx)
        assert not got.unstructured_grid
    assert setup.eq_variable_norms(experiment) == {"a": 1.0, "b": 1.0}
    assert setup.data_family(experiment) == "AD"
    grid = setup.uniform_grid(got, (250, 100))
    assert grid.n_components == 2
    np.testing.assert_allclose(grid.x, np.linspace(0.0, got.L, 100),
                               rtol=1e-7)


def test_rpu_raises(tmp_path):
    """RPU no longer raises: its PDE is the JAX package's (RP's, on the
    unstructured grid, which no dataset-free grid serves), and the
    generate CLI writes it on the LCG grids (tests/test_torch_rpu.py holds
    the rest)."""
    for res in ((250, 100), (500, 40)):
        got = setup.pde_for_experiment("RPU", res)
        want = jsetup.pde_for_experiment("RPU", res)
        assert got.unstructured_grid and want.unstructured_grid
        assert (got.tmax, got.L, got.grid_size, got.dt, got.dx) == (
            want.tmax, want.L, want.grid_size, want.dt, want.dx)
    with pytest.raises(ValueError, match="data-defined"):
        setup.uniform_grid(got, (250, 100))
    _generate(tmp_path, "RPU")
    with hdf5_io.open_dataset(str(tmp_path / "AD_RPU.npz")) as z:
        for nt, nx in generate.RES_AD:
            np.testing.assert_array_equal(
                z.attrs(f"train/pde_{nt}-{nx}")["x"],
                jics.pseudo_random_grid(0.0, 16.0, nx))
