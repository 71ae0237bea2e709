"""PyTorch port, the interpolation modules against the JAX package, float64
unless said (JAX in x64, tests/conftest.py):

* ``ops/interp.py``: ``interp1d`` (1-D, batched rows, rows broadcast)
  and ``interp_matrix`` (its rows on float32 or float64 grids, as
  FNO2DPU builds them from the float32 grid), with ``mask`` True and
  False and queries outside the grid and on its points: 1e-12;
* ``data/interpolate.py::interpolate_file`` against the JAX function on
  one tiny RPU file the port's generate CLI writes: every array and
  attribute of the ``_I`` file at 1e-12, a and b copied (not zeros);
  the CLI's ``--data_dir`` and its CUDA default;
* the metrics of the interpolated route, ``interp_rollout_to_unstructured``
  (float32, as the rollout store holds it: 1e-6) and
  ``compute_l2_norms_u`` (from a given store, against the JAX function;
  re-rolling, against the store's);
* the eval_interpolated CLI against the JAX CLI: one flax tree of FNO2DP
  written as a JAX checkpoint and as the port's ``.npz``, both CLIs on
  the same files in float64 (the model and the uniform data cast) with
  ``--n_more_rollout=1``: every printed metric at rtol 1e-9, the rollout
  store, the interp-back L2 equal to a direct reduction of the
  interpolated-back store; the figures where matplotlib imports, and one
  line saying they were skipped where it does not.
"""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.data.interpolate import interpolate_file as jinterpolate
from msmp_pde_tpu.ops import interp as jinterp
from msmp_pde_tpu.training import metrics as jmetrics
from msmp_pde_torch.data import interpolate
from msmp_pde_torch.datagen import generate, hdf5_io, ics
from msmp_pde_torch.ops import interp
from msmp_pde_torch.training import eval_interpolated, metrics

from _torch_helpers import np_tree, one_thread, tt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _queries(rng, x):
    """Queries inside, outside and on the grid's points (its ends too)."""
    lo, hi = x.min(), x.max()
    return np.concatenate([rng.uniform(lo - 2.0, hi + 2.0, 60),
                           x[::7], [lo, hi, lo - 1e-9, hi + 1e-9]])


@pytest.mark.parametrize("mask", [True, False])
def test_interp1d_matches_jax(mask):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 16.0, 30))
    y = rng.normal(size=30)
    t = _queries(rng, x)
    want = np.asarray(jinterp.interp1d(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(t), mask=mask))
    got = interp.interp1d(tt(x), tt(y), tt(t), mask=mask)
    assert got.shape == t.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    if mask:
        assert got.min() >= y.min() and got.max() <= y.max()
    # batched rows, and a row of x broadcast against rows of y and t
    xb = np.sort(rng.uniform(0.0, 16.0, (3, 30)), axis=1)
    yb, tb = rng.normal(size=(3, 30)), rng.uniform(-1.0, 17.0, (3, 25))
    for xs in (xb, xb[:1]):
        want = np.asarray(jinterp.interp1d(jnp.asarray(xs), jnp.asarray(yb),
                                           jnp.asarray(tb), mask=mask))
        got = interp.interp1d(tt(xs), tt(yb), tt(tb), mask=mask)
        assert got.shape == (3, 25)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("grid_dtype", [np.float64, np.float32])
def test_interp_matrix_matches_jax(mask, grid_dtype):
    """Both directions FNO2DPU takes: the LCG grid onto the uniform one and
    back; the matrix in the grid's dtype, ``W @ y`` equal to interp1d."""
    rng = np.random.default_rng(1)
    lcg = ics.pseudo_random_grid(0.0, 16.0, 40).astype(grid_dtype)
    uni = np.linspace(0.0, 16.0, 40)
    for x, t in ((lcg, uni), (uni.astype(grid_dtype), lcg),
                 (lcg, _queries(rng, lcg.astype(np.float64)))):
        want = np.asarray(jinterp.interp_matrix(jnp.asarray(x),
                                                jnp.asarray(t), mask=mask))
        got = interp.interp_matrix(torch.as_tensor(x), torch.as_tensor(t),
                                   mask=mask)
        assert got.dtype == torch.as_tensor(x).dtype
        assert want.dtype == x.dtype and got.shape == (len(t), len(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
        y = rng.normal(size=len(x))
        np.testing.assert_allclose(
            got.double().numpy() @ y,
            interp.interp1d(tt(x), tt(y), tt(t), mask=mask).numpy(),
            rtol=1e-6 if grid_dtype == np.float32 else 1e-12, atol=1e-6)
        if mask:
            np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-6)
            assert (got >= 0).all()


@pytest.fixture(scope="module")
def rpu_dir(tmp_path_factory, one_thread):
    """A directory with the port's RPU data (2/2/2 samples) under data/:
    ``.npz`` and ``.h5``."""
    root = tmp_path_factory.mktemp("rpu_interp")
    generate.main(generate.build_parser().parse_args(
        ["--experiment=RPU", "--train_samples=2", "--valid_samples=2",
         "--test_samples=2", "--device=cpu", f"--data_dir={root / 'data'}"]))
    return root


def test_interpolate_file_matches_jax(rpu_dir, tmp_path):
    h5py = pytest.importorskip("h5py")
    src = str(rpu_dir / "data" / "AD_RPU.h5")
    jdst = str(tmp_path / "jax_I.h5")
    jinterpolate(src, jdst, 0.0, 16.0)
    npz, h5 = interpolate.interpolate_file(
        str(rpu_dir / "data" / "AD_RPU.npz"), str(tmp_path / "port_I"),
        0.0, 16.0, device="cpu")
    with h5py.File(jdst, "r") as want, hdf5_io.open_dataset(npz) as z, \
            hdf5_io.open_dataset(h5) as f:
        names = sorted(z.names())
        assert names == sorted(f.names()) == sorted(
            f"{m}/{k}" for m in want for k in want[m])
        for name in names:
            w = want[name][:]
            for got in (z.array(name), f.array(name)):
                assert got.shape == w.shape and got.dtype == w.dtype
                np.testing.assert_allclose(got, w, rtol=1e-12, atol=1e-12)
            if "-" not in name:  # a and b copied, not left zero
                assert (w != 0).all()
                continue
            for a in hdf5_io.ATTRS:
                np.testing.assert_allclose(z.attrs(name)[a],
                                           want[name].attrs[a], rtol=1e-15)
                np.testing.assert_array_equal(f.attrs(name)[a],
                                              z.attrs(name)[a])
            nx = int(z.attrs(name)["nx"])
            np.testing.assert_array_equal(z.attrs(name)["x"],
                                          np.linspace(0.0, 16.0, nx))


def test_interpolate_cli_data_dir_and_device(rpu_dir, capsys):
    args = interpolate.build_parser().parse_args(
        [f"--data_dir={rpu_dir / 'data'}"])
    assert args.experiment == "RPU" and args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            interpolate.main(args)
    args.device = "cpu"
    npz, _ = interpolate.main(args)
    assert npz == f"{rpu_dir / 'data'}/AD_RPU_I.npz"
    assert "Wrote" in capsys.readouterr().out
    with hdf5_io.open_dataset(npz) as z:
        assert z.array("test/pde_250-100").shape == (2, 2, 250, 100)


def test_interp_rollout_to_unstructured_matches_jax():
    """float32 predictions and grids, as the rollout store and the
    datasets hold them."""
    rng = np.random.default_rng(2)
    preds = rng.normal(size=(3, 50, 2, 40)).astype(np.float32)
    xu = np.linspace(0.0, 16.0, 40).astype(np.float32)
    xr = ics.pseudo_random_grid(0.0, 16.0, 40).astype(np.float32)
    want = jmetrics.interp_rollout_to_unstructured(preds, xu, xr)
    got = metrics.interp_rollout_to_unstructured(preds, xu, xr, "cpu")
    assert got.shape == want.shape == (3, 50, 2, 40)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _tiny_trainer():
    """MP-PDE2D (one layer, float64) on the uniform grid of 40, nt 250."""
    import dataclasses

    from msmp_pde_torch.training.loop import Trainer
    from msmp_pde_torch.training.setup import GridInfo, build_trainer

    grid = GridInfo(x=np.linspace(0.0, 16.0, 40), nt=250, dt=4.0 / 249,
                    tmin=0.0, tmax=4.0, n_components=2)
    tr = build_trainer("RP", "MP-PDE2D", base_resolution=(250, 40),
                       n_graph_layers=1, device="cpu", grid=grid)
    return Trainer(model=tr.model.double(), kind=tr.kind,
                   spec=dataclasses.replace(tr.spec,
                                            t_grid=tr.spec.t_grid.double()),
                   eq_norms=tr.eq_norms)


def test_compute_l2_norms_u_matches_jax_and_rerolling():
    rng = np.random.default_rng(3)
    tr = _tiny_trainer()
    u = tt(rng.normal(size=(3, 250, 2, 40)) * 0.5)
    var = {k: tt(rng.uniform(0.1, 1.0, 3)) for k in ("a", "b")}
    u_r = rng.normal(size=(3, 250, 2, 40))
    xu = np.linspace(0.0, 16.0, 40)
    xr = ics.pseudo_random_grid(0.0, 16.0, 40)
    quiet = dict(log=lambda *a: None)
    preds, _ = metrics.rollout_store(tr, u, var, 2, 2, 250)
    assert preds.shape == (3, 200, 2, 40)
    got = metrics.compute_l2_norms_u(tr, u, var, u_r, xu, xr, 2, 2, 250,
                                     preds=preds, **quiet)
    want = jmetrics.compute_l2_norms_u(
        tr, None, None, None, u_r, xu, xr, 2, 2, 250, preds=preds, **quiet)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    again = metrics.compute_l2_norms_u(tr, u, var, u_r, xu, xr, 2, 2, 250,
                                       **quiet)
    assert again == got
    # a direct reduction of the interpolated-back store
    back = metrics.interp_rollout_to_unstructured(preds, xu, xr, "cpu")
    assert metrics.l2_norms_from_store(back, u_r[:, 50:250], **quiet) == got


def _eval_argv(*extra):
    return ["--experiment=RPU", "--model=FNO2DP", "--batch_size=2",
            "--n_more_rollout=1", *extra]


def _f64_uniform(module, monkeypatch):
    """``module``'s PDEDataset with float64 trajectories (the uniform
    data the model runs on)."""
    base = module.PDEDataset

    class F64(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.u_super = self.u_super.astype(np.float64)
            self.u_base = self.u_base.astype(np.float64)

    monkeypatch.setattr(module, "PDEDataset", F64)


PRINTED = re.compile(r"^(Step \d+, mean loss|L2 error|L2 relative error|"
                     r"Unrolled forward losses|Unrolled forward base "
                     r"losses) (\S+)", re.M)


def test_eval_interpolated_matches_the_jax_cli(rpu_dir, monkeypatch,
                                               capsys):
    import msmp_pde_tpu.data as jdata
    import msmp_pde_torch.data.dataset as tdataset
    from msmp_pde_tpu.training import eval_interpolated as jeval_i
    from msmp_pde_tpu.training import loop as jloop
    from msmp_pde_tpu.training import setup as jsetup
    from msmp_pde_tpu.utils.checkpoint import save_checkpoint
    from msmp_pde_torch.training import setup as tsetup
    from msmp_pde_torch.utils.convert import params_from_flax, save_npz

    monkeypatch.chdir(rpu_dir)
    if not os.path.exists("data/AD_RPU_I.npz"):
        interpolate.main(interpolate.build_parser().parse_args(
            ["--device=cpu"]))
    jargs = jeval_i.build_parser().parse_args(
        _eval_argv("--model_to_test=fno2dp_jax", "--platform=cpu"))
    exp = jsetup.setup_experiment(jargs, modes=("test",))
    tree = np_tree(exp.trainer.init_params(jax.random.PRNGKey(5), 2))
    save_checkpoint("fno2dp_jax", tree)
    save_npz("fno2dp_port.npz", params_from_flax(tree))
    # the restore template of the JAX CLI's uniform-grid trainer: float64
    monkeypatch.setattr(jloop.Trainer, "init_params",
                        lambda self, key, batch_size=2: tree)
    tsetup_fn = tsetup.setup_experiment

    def port_f64(*a, **k):
        e = tsetup_fn(*a, **k)
        e.trainer.model.double()
        return e

    monkeypatch.setattr(tsetup, "setup_experiment", port_f64)
    for module in (jdata, jsetup, tdataset):  # the port's setup imports
        _f64_uniform(module, monkeypatch)     # from tdataset when called
    capsys.readouterr()
    jl2, jrel = jeval_i.main(jargs)
    want = [(k, float(v)) for k, v in PRINTED.findall(
        capsys.readouterr().out)]
    got = eval_interpolated.main(eval_interpolated.build_parser().parse_args(
        _eval_argv("--model_to_test=fno2dp_port.npz", "--device=cpu")))
    out = capsys.readouterr().out
    printed = [(k, float(v)) for k, v in PRINTED.findall(out)]
    assert [k for k, _ in printed] == [k for k, _ in want]
    np.testing.assert_allclose([v for _, v in printed],
                               [v for _, v in want], rtol=1e-9)
    np.testing.assert_allclose((got["interp_L2"], got["interp_rel_L2"]),
                               (jl2, jrel), rtol=1e-9)
    assert got["preds"].shape == (2, 225, 2, 100)
    assert got["preds_interp_back"].shape == (2, 200, 2, 100)
    quiet = dict(log=lambda *a: None)
    assert (got["interp_L2"], got["interp_rel_L2"]) == \
        metrics.l2_norms_from_store(got["preds_interp_back"],
                                    got["trues_unstructured"], **quiet)
    assert got["figures"]
    assert os.path.getsize("plots/plot_interp_back.png") > 0
    long = np.load("plots/long_rollout_interp_pred.npy")
    np.testing.assert_array_equal(long, got["preds"])


def test_eval_interpolated_without_matplotlib(rpu_dir, monkeypatch, capsys,
                                              tmp_path):
    """The figures skipped, one line saying so; the CUDA default raises
    where there is no card."""
    from msmp_pde_torch.data.graph import build_neighbors_radius
    from msmp_pde_torch.training import setup as tsetup
    from msmp_pde_torch.utils.convert import save_npz

    monkeypatch.chdir(rpu_dir)
    if not os.path.exists("data/AD_RPU_I.npz"):
        interpolate.main(interpolate.build_parser().parse_args(
            ["--device=cpu"]))
    tr = tsetup.build_trainer("RPU", "FNO2DP", device="cpu",
                              data_suffix="_I")
    save_npz(str(tmp_path / "w.npz"), tr.model.state_dict())
    argv = _eval_argv(f"--model_to_test={tmp_path / 'w.npz'}")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            eval_interpolated.main(
                eval_interpolated.build_parser().parse_args(argv))
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    got = eval_interpolated.main(eval_interpolated.build_parser().parse_args(
        argv + ["--device=cpu"]))
    assert not got["figures"]
    assert "the figures were skipped" in capsys.readouterr().out
    assert np.isfinite(got["interp_L2"]) and got["interp_L2"] > 0
    # the model ran on the uniform grid of the _I files: the radius stencil
    idx, _ = build_neighbors_radius(np.linspace(0.0, 16.0, 100), 3)
    assert tr.spec.idx.shape == idx.shape
    np.testing.assert_array_equal(tr.spec.idx.numpy(), idx)
