"""PyTorch port, the evaluation and cross-validation CLIs
(training/eval.py, training/cv.py) on the CPU, on a tiny RP dataset that
the port's generate CLI writes (2/2/2 samples, nx 100):

* eval against the JAX package's eval CLI: one flax tree of FNO2DP
  written twice, as a JAX checkpoint (``save_checkpoint``) and as the
  port's ``.npz`` (``save_npz``); both CLIs run in float64 (the datasets'
  trajectories and the model cast, the inputs float32 values, the
  equation variables float32 on both sides, as the CLIs cast them) with
  ``--n_more_rollout=1``; the rollout store and every printed L2, rel-L2
  and unrolled loss at rtol 1e-9;
* eval on FNO2DP's one-epoch ``fit`` checkpoint: every metric it prints
  and returns (test L2 / rel-L2, the short-horizon norms, the unrolled
  losses, the rollout store) equals the metrics functions called directly
  on the same weights; its figures are written (matplotlib imports here);
* eval on the same weights as an ``.npz`` of flax paths, with matplotlib
  made unimportable: the same metrics, one line saying the figures were
  skipped, and ``--n_more_rollout``'s ``plots/long_rollout_pred.npy``;
* ``--ks_spectrum`` on a KS fixture (the port's ``generate_ks`` at tend
  10, dt 0.01, 2/2/2 samples; an MSMP-PDE of one pair saved with random
  weights): its arrays equal the JAX package's ``KS.energy_spectrum`` and
  ``space_filter`` on the same rollout at 1e-12, its ``.npz`` and figure
  are written, ``plot_ks_spectrum`` raises naming matplotlib where it does
  not import, and the flag raises on another experiment; both CLIs raise
  without CUDA where ``--device`` is left at its default;
* cv's split against the JAX cv CLI (its ``fit`` replaced by one that
  keeps the data it is given): on the RP set, the port's split arrays
  equal the JAX CLI's; on indices alone (the JAX CLI given a stand-in
  experiment whose trajectories are their sample indices), proportionally
  below 1024/128/128 and at it;
* ``cv.main`` trains BaseCNN2D one epoch on the merged, re-split samples.
"""
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

import jax

from msmp_pde_tpu.training import cv as jcv
from msmp_pde_tpu.training import eval as jeval
from msmp_pde_tpu.training import setup as jsetup
from msmp_pde_tpu.training import train as jtrain
from msmp_pde_tpu.utils.checkpoint import save_checkpoint
from msmp_pde_torch.datagen import generate
from msmp_pde_torch.training import cv
from msmp_pde_torch.training import eval as evaluate
from msmp_pde_torch.training import metrics, train
from msmp_pde_torch.training import setup as tsetup
from msmp_pde_torch.training.setup import setup_experiment
from msmp_pde_torch.utils.checkpoint import restore_params
from msmp_pde_torch.utils.convert import params_from_flax, save_npz

from _torch_helpers import np_tree, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FIT = ["--experiment=RP", "--num_epochs=1", "--batch_size=2",
       "--print_interval=1000"]
METRICS = ("test_L2", "test_rel_L2", "test_L2_short", "test_rel_L2_short",
           "test_loss", "test_base_loss")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, one_thread):
    """A directory with RP data (2/2/2 samples) and FNO2DP's one-epoch
    checkpoint under models/; returns (directory, checkpoint path)."""
    root = tmp_path_factory.mktemp("eval_cv")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        generate.main(generate.build_parser().parse_args(
            ["--experiment=RP", "--train_samples=2", "--valid_samples=2",
             "--test_samples=2", "--device=cpu"]))
        train.main(train.build_parser().parse_args(
            FIT + ["--model=FNO2DP", "--device=cpu"]))
        (ckpt,) = os.listdir("models")
    finally:
        os.chdir(cwd)
    return root, f"models/{ckpt}"


def _eval_args(ckpt, *extra):
    return evaluate.build_parser().parse_args(
        ["--experiment=RP", "--model=FNO2DP", "--batch_size=2",
         f"--model_to_test={ckpt}", "--short_horizon_windows=2",
         "--device=cpu", *extra])


def _direct(args, ckpt):
    """The metrics functions on the checkpoint's weights."""
    exp = setup_experiment(args, modes=("test",), data_dir="data")
    tr = exp.trainer
    tr.model.load_state_dict(restore_params(ckpt), strict=True)
    u, ub, var = train.device_arrays(exp.datasets["test"], "cpu")
    quiet = dict(log=lambda *a: None)
    nt = exp.datasets["test"].nt
    out = dict(zip(("test_L2", "test_rel_L2"), metrics.compute_l2_norms(
        tr, u, var, 2, 2, nt, **quiet)))
    out.update(zip(("test_L2_short", "test_rel_L2_short"),
                   metrics.compute_l2_norms(tr, u, var, 2, 2, nt,
                                            max_windows=2, **quiet)))
    out.update(zip(("test_loss", "test_base_loss"),
                   metrics.test_unrolled_losses(tr, u, ub, var, 2, 2, nt, 100,
                                                **quiet)))
    return out, metrics.rollout_store(tr, u, var, 2, 2, nt)


PRINTED = re.compile(r"^(Step \d+, mean loss|L2 error|L2 relative error|"
                     r"Unrolled forward losses|Unrolled forward base "
                     r"losses) (\S+)", re.M)


def _printed(out):
    """[(label, value)] of every metric line a CLI printed, in order."""
    return [(k, float(v)) for k, v in PRINTED.findall(out)]


def _float64(module, monkeypatch, on_exp):
    """``module.setup_experiment`` with the datasets' trajectories in
    float64, then ``on_exp(exp)``."""
    setup = module.setup_experiment

    def wrapped(*a, **k):
        exp = setup(*a, **k)
        for ds in exp.datasets.values():
            ds.u_super = ds.u_super.astype(np.float64)
            ds.u_base = ds.u_base.astype(np.float64)
        on_exp(exp)
        return exp

    monkeypatch.setattr(module, "setup_experiment", wrapped)


def test_eval_matches_the_jax_cli(workdir, monkeypatch, capsys):
    root, _ = workdir
    monkeypatch.chdir(root)
    argv = ["--experiment=RP", "--model=FNO2DP", "--batch_size=2",
            "--short_horizon_windows=2", "--n_more_rollout=1", "--dp=1"]
    jargs = jeval.build_parser().parse_args(
        argv + ["--model_to_test=fno2dp_jax", "--platform=cpu"])
    exp = jsetup.setup_experiment(jargs, modes=("test",))
    tree = np_tree(exp.trainer.init_params(jax.random.PRNGKey(3), 2))
    save_checkpoint("fno2dp_jax", tree)
    save_npz("fno2dp_port.npz", params_from_flax(tree))

    def jax_f64(exp):  # the restore template: float64 leaves
        exp.trainer.init_params = lambda key, batch_size=2: tree

    _float64(jsetup, monkeypatch, jax_f64)
    _float64(tsetup, monkeypatch, lambda exp: exp.trainer.model.double())
    capsys.readouterr()
    want_preds, want_trues = jeval.main(jargs)
    want = _printed(capsys.readouterr().out)
    got = evaluate.main(evaluate.build_parser().parse_args(
        argv + ["--model_to_test=fno2dp_port.npz", "--device=cpu"]))
    printed = _printed(capsys.readouterr().out)
    assert [k for k, _ in printed] == [k for k, _ in want]
    np.testing.assert_allclose([v for _, v in printed],
                               [v for _, v in want], rtol=1e-9)
    assert got["preds"].shape == want_preds.shape == (2, 225, 2, 100)
    np.testing.assert_array_equal(got["trues"], want_trues)
    np.testing.assert_allclose(got["preds"], want_preds, rtol=1e-9,
                               atol=1e-9 * np.abs(want_preds).max())
    assert got["test_L2"] == printed[0][1]


def test_eval_metrics_equal_the_metrics_functions(workdir, monkeypatch,
                                                  capsys):
    root, ckpt = workdir
    monkeypatch.chdir(root)
    args = _eval_args(ckpt)
    got = evaluate.main(args)
    want, (preds, trues) = _direct(args, ckpt)
    for k in METRICS:
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["preds"], preds)
    np.testing.assert_array_equal(got["trues"], trues)
    assert preds.shape == (2, 200, 2, 100)  # 8 windows of 25 from step 50
    assert got["figures"]
    for name in ("plot1d.png", "plot2d.png", "plot_relerror.png"):
        assert os.path.getsize(f"plots/{name}") > 0
    out = capsys.readouterr().out
    assert f"L2 error {want['test_L2']}" in out
    assert f"Unrolled forward losses {want['test_loss']}" in out


def test_eval_npz_without_matplotlib_and_long_rollout(workdir, monkeypatch,
                                                      capsys):
    root, ckpt = workdir
    monkeypatch.chdir(root)
    save_npz("fno2dp.npz", restore_params(ckpt))
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    args = _eval_args("fno2dp.npz", "--n_more_rollout=1")
    got = evaluate.main(args)
    want, (preds, _) = _direct(args, ckpt)
    for k in METRICS:
        assert got[k] == want[k], k
    assert not got["figures"]
    assert "the figures were skipped" in capsys.readouterr().out
    long = np.load("plots/long_rollout_pred.npy")
    assert long.shape == (2, 225, 2, 100)
    np.testing.assert_array_equal(long[:, :200], preds)
    assert np.isfinite(long).all()


def test_eval_ks_spectrum_and_default_device_raise(workdir, monkeypatch,
                                                   tmp_path):
    import jax.numpy as jnp

    from msmp_pde_tpu.equations import KS as JKS
    from msmp_pde_torch.utils.checkpoint import save_checkpoint

    root, ckpt = workdir
    monkeypatch.chdir(root)
    with pytest.raises(ValueError, match="KS-family"):
        evaluate.main(_eval_args(ckpt, "--ks_spectrum"))
    monkeypatch.chdir(tmp_path)
    generate.generate_ks(generate.build_parser().parse_args(
        ["--experiment=KS", "--train_samples=2", "--valid_samples=2",
         "--test_samples=2", "--device=cpu"]), 10.0, 0.01,
        resolutions=[(250, 200), (250, 100)])
    ks_args = ["--experiment=KS", "--model=MSMP-PDE", "--n_graph_layers=1",
               "--batch_size=2", "--device=cpu"]
    exp = setup_experiment(train.build_parser().parse_args(ks_args),
                           modes=("test",), data_dir="data")
    save_checkpoint("ks.pt", exp.trainer.model)
    args = evaluate.build_parser().parse_args(
        ks_args + ["--model_to_test=ks.pt", "--ks_spectrum"])
    out = evaluate.main(args)
    diag = out["ks_spectrum"]
    pde = JKS(L=22.0 / (2 * np.pi), nx=100, dt=0.00025, tend=100.0,
              dt_downsampled=0.4)
    for tag, arr in (("pred", out["preds"]), ("true", out["trues"])):
        u = jnp.asarray(arr[0, :, 0, :].astype(np.float64))
        ek = pde.energy_spectrum(u)
        filt, resid = pde.space_filter(u, args.ks_k_cut)
        want = {f"{n}_{tag}": np.asarray(ek[n])
                for n in ("Ek_k", "Ek_t", "Ek_tt")}
        want[f"filt_{tag}"] = np.asarray(filt)
        want[f"resid_rms_{tag}"] = np.sqrt(np.mean(np.asarray(resid) ** 2,
                                                   -1))
        for k, v in want.items():
            assert diag[k].shape == v.shape, k
            np.testing.assert_allclose(diag[k], v, rtol=1e-12, atol=1e-12,
                                       err_msg=k)
    np.testing.assert_array_equal(diag["k"], np.abs(pde._k_grid()))
    with np.load("plots/ks_spectrum.npz") as z:
        assert set(z.files) == set(diag)
        for k in z.files:
            np.testing.assert_array_equal(z[k], diag[k])
    assert out["figures"] and os.path.isfile("plots/ks_spectrum.png")
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    with pytest.raises(RuntimeError, match="matplotlib"):
        evaluate.plot_ks_spectrum(diag, out_path="again.png")
    monkeypatch.chdir(root)
    if not torch.cuda.is_available():
        argv = ["--experiment=RP", "--model=FNO2DP"]
        for cli, extra in ((evaluate, [f"--model_to_test={ckpt}"]),
                           (cv, [])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(cli.build_parser().parse_args(argv + extra))


def _stand_in(n_total):
    """An experiment for the JAX cv CLI whose trajectories are their
    sample indices, 0..n_total-1 across train, valid and test."""
    idx = np.arange(n_total, dtype=np.float64)[:, None]
    cuts = np.split(idx, [n_total // 2, 3 * n_total // 4])
    return types.SimpleNamespace(pde="AD", datasets={
        m: types.SimpleNamespace(u_super=c, u_base=c, variables={})
        for m, c in zip(cv.MODES, cuts)})


def _keep_data(module, monkeypatch, into):
    monkeypatch.setattr(module, "fit",
                        lambda args, exp, data, path: into.append(data))


@pytest.mark.parametrize("n_total,seed,rep", [
    (6, 0, 0), (64, 0, 3), (1279, 7, 1), (1280, 0, 0), (2048, 3, 2)])
def test_cv_split_matches_the_jax_cli(n_total, seed, rep, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jsetup, "setup_experiment",
                        lambda args: _stand_in(n_total))
    seen = []
    _keep_data(jtrain, monkeypatch, seen)
    jcv.main(jcv.build_parser().parse_args(
        ["--experiment=RP", "--model=BaseCNN2D", f"--seed={seed}",
         f"--rep={rep}", "--platform=cpu"]))
    (data,) = seen
    want = [np.asarray(data[m][0])[:, 0].astype(np.int64) for m in cv.MODES]
    got = cv.split_indices(n_total, seed, rep)
    assert cv.CV_SPLIT == tuple(jcv.CV_SPLIT)
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    sizes = [len(a) for a in got]
    if n_total >= 1280:
        assert sizes == [1024, 128, 128]
    else:
        assert sum(sizes) == n_total and sizes[1] >= 1
    assert len(np.unique(np.concatenate(got))) == sum(sizes)


def test_cv_data_equals_the_jax_cli(workdir, monkeypatch):
    root, _ = workdir
    monkeypatch.chdir(root)
    jseen, seen = [], []
    _keep_data(jtrain, monkeypatch, jseen)
    _keep_data(train, monkeypatch, seen)
    argv = ["--experiment=RP", "--model=BaseCNN2D", "--seed=1", "--rep=2",
            "--cv_folder=cv_split"]
    jcv.main(jcv.build_parser().parse_args(argv + ["--platform=cpu"]))
    cv.main(cv.build_parser().parse_args(argv + ["--device=cpu"]))
    (want,), (got,) = jseen, seen
    for m in cv.MODES:
        (u, ub, var), (ju, jub, jvar) = got[m], want[m]
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(ub.numpy(), np.asarray(jub))
        assert var.keys() == jvar.keys() == {"a", "b"}
        for k in var:
            np.testing.assert_array_equal(var[k].numpy(),
                                          np.asarray(jvar[k]))


def test_cv_main_one_epoch(workdir, monkeypatch, capsys):
    root, _ = workdir
    monkeypatch.chdir(root)
    res = cv.main(cv.build_parser().parse_args(
        FIT + ["--model=BaseCNN2D", "--device=cpu", "--rep=1",
               "--cv_folder=cvRP"]))
    assert all(np.isfinite(res[k]) for k in ("valid_L2", "test_L2",
                                             "min_val_loss", "test_loss"))
    (h,) = res["history"]
    sizes = [len(a) for a in cv.split_indices(6, 0, 1)]
    assert sizes == [4, 1, 1]
    assert h["losses"].shape == (250, sizes[0] // 2)
    (ckpt,) = os.listdir("cvRP")
    assert ckpt.startswith("BaseCNN2D_AD_RP_rep1_") and ckpt.endswith(".pt")
    out = capsys.readouterr().out
    for mode, n in zip(("train", "valid", "test"), sizes):
        assert f"CV {mode}: {n} samples" in out
