"""PyTorch port, the Kuramoto-Sivashinsky equation (equations/ks.py, the KS
initial condition of datagen/ics.py and the KS branch of
datagen/generate.py) against the JAX package, float64.

* ``etdrk4_setup``: equal arrays (the same numpy);
* ``KS.simulate`` (torch.fft, the CPU's eager loop) against the JAX
  ``KS.simulate(method='fft')`` at L = 22 / 2 pi, dt 0.025, tend 1, from
  the same initial conditions, at nx 64, 100 and 200 with the initial
  condition among the saved steps: 1e-12 (measured ~1.5e-15; the step
  folds g into the coefficients, a rounding change only);
* ``simulate_many`` (datagen's resolutions together) equal to each
  ``simulate``;
* the ``valid`` mask on a blow-up, as JAX flags it;
* ``energy_spectrum``, ``space_filter`` and ``space_filter_int`` (and its
  ValueError where the kept modes are not N_int) against JAX: 1e-12;
* the KS CLI schema through ``generate_ks(args, tend, dt_fine)`` at tend 5,
  dt 0.01 (500 fine steps, a transient of 201), its keys, attributes and
  save points, and its trajectories against the JAX ``simulate`` of the
  same draws: 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.equations import ks as jks
from msmp_pde_torch.datagen import generate, hdf5_io, ics
from msmp_pde_torch.equations import ks
from msmp_pde_torch.equations.ks import KS

from _torch_helpers import one_thread, tt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
L = 22.0 / (2 * np.pi)
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nx", [64, 100, 200])
def test_etdrk4_setup_equal(nx):
    got, want = ks.etdrk4_setup(L, nx, 0.00025), jks.etdrk4_setup(L, nx,
                                                                  0.00025)
    for f in ("k", "E", "E2", "Q", "f1", "f2", "f3", "g"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("nx", [64, 100, 200])
def test_simulate_matches_jax_fft(nx):
    kw = dict(L=L, nx=nx, dt=0.025, tend=1.0, dt_downsampled=0.1)
    u0 = np.random.default_rng(nx).normal(size=(3, nx))
    save = np.array([0, 3, 10, 25, 40])
    got, valid = KS(**kw).simulate(tt(u0), save)
    want, jvalid = jks.KS(**kw).simulate(jnp.asarray(u0), save, method="fft")
    assert got.shape == (3, 5, nx) and bool(valid.all())
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got[:, 0].numpy(), u0, **TOL)


def test_simulate_many_equals_each_simulate():
    """The resolutions together (datagen's call) give each one's own
    result."""
    jobs = [(KS(L=L, nx=nx, dt=0.025, tend=1.0, dt_downsampled=0.1),
             tt(np.random.default_rng(nx).normal(size=(2, nx))), save)
            for nx, save in ((64, [1, 5, 40]), (32, [0, 3]))]
    for (ks_, u0, save), (got, valid) in zip(jobs, ks.simulate_many(jobs)):
        want, wvalid = ks_.simulate(u0, save)
        assert torch.equal(got, want) and torch.equal(valid, wvalid)


def test_valid_mask_flags_a_blowup():
    kw = dict(L=L, nx=64, dt=0.5, tend=20.0, dt_downsampled=1.0)
    u0 = np.random.default_rng(0).normal(size=(3, 64))
    u0[1] *= 1e3
    got, valid = KS(**kw).simulate(tt(u0), np.arange(1, 40))
    _, jvalid = jks.KS(**kw).simulate(jnp.asarray(u0), np.arange(1, 40),
                                      method="fft")
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert not bool(valid[1]) and not bool(torch.isfinite(got[1]).all())
    assert bool(torch.isfinite(got[valid]).all())


@pytest.mark.parametrize("nx", [100, 256])
def test_diagnostics_match_jax(nx):
    kw = dict(L=L, nx=nx, dt=0.25, tend=10.0)
    pde, jpde = KS(**kw), jks.KS(**kw)
    u = np.random.default_rng(1).normal(size=(2, 7, nx))
    got = pde.energy_spectrum(tt(u))
    want = jpde.energy_spectrum(jnp.asarray(u))
    for k in ("Ek_kt", "Ek_k", "Ek_t", "Ek_tt"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(pde._k_grid(), jpde._k_grid())
    for a, b in zip(pde.space_filter(tt(u), 1.5),
                    jpde.space_filter(jnp.asarray(u), 1.5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    n_keep = int((np.abs(pde._k_grid()) < 2.0).sum())
    for a, b in zip(pde.space_filter_int(tt(u), 2.0, n_keep),
                    jpde.space_filter_int(jnp.asarray(u), 2.0, n_keep)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)
    with pytest.raises(ValueError, match="N_int must equal"):
        pde.space_filter_int(tt(u), 2.0, n_keep + 1)


def test_generate_ks_schema_and_jax(tmp_path):
    n = {"train": 3, "valid": 1, "test": 2}
    args = generate.build_parser().parse_args(
        ["--experiment=KS", "--device=cpu", "--seed=2", "--chunk=2",
         f"--data_dir={tmp_path}"] + [f"--{m}_samples={k}"
                                      for m, k in n.items()])
    res = [(250, 100), (250, 50)]
    tend, dt = 5.0, 0.01
    seconds = generate.generate_ks(args, tend, dt, resolutions=res)
    assert set(seconds) == {("all", "all resolutions")}
    # the draws: per mode, per chunk of 2, the sines
    rng = np.random.default_rng(2)
    draws = {m: [ics.sample_sine_params(rng, c, 5, 1, 3)
                 for _, c in generate._chunks(k, 2)] for m, k in n.items()}
    with hdf5_io.open_dataset(str(tmp_path / "KS_KS.npz")) as z, \
            hdf5_io.open_dataset(str(tmp_path / "KS_KS.h5")) as f:
        for nt, nx in res:
            pde = KS(L=L, nx=nx, dt=dt, tend=tend, dt_downsampled=tend / nt)
            save = pde.save_steps()
            assert save[0] == 201 and save[-1] == 500 and len(save) == nt
            jpde = jks.KS(L=L, nx=nx, dt=dt, tend=tend,
                          dt_downsampled=tend / nt)
            x = np.linspace(0.0, 2 * np.pi * L, nx)
            for mode, k in n.items():
                name = f"{mode}/pde_{nt}-{nx}"
                u, a = z.array(name), z.attrs(name)
                assert u.shape == (k, nt, nx) and np.isfinite(u).all()
                np.testing.assert_array_equal(u, f.array(name))
                assert (int(a["nt"]), int(a["nx"])) == (nt, nx)
                assert float(a["dt"]) == tend / nt
                assert float(a["dx"]) == 2 * np.pi * L / nx
                assert (float(a["tmin"]), float(a["tmax"])) == (0.0, tend)
                np.testing.assert_array_equal(a["x"], x)
                A, _, phi, l = (np.concatenate(p) for p in
                                zip(*draws[mode]))
                arg = 2 * np.pi * l * (x / (2 * np.pi))[:, None] / L + phi
                u0 = np.sum(A * np.sin(arg), axis=-1)
                want, _ = jpde.simulate(jnp.asarray(u0), save, method="fft")
                np.testing.assert_allclose(u, np.asarray(want), rtol=1e-9,
                                           atol=1e-9)
