"""PyTorch port, the wave equation, KF and KS end to end on the CPU
against the JAX package: the datasets the port's generate CLI writes
(WE3 at 2/2/2 samples, every resolution; KF at 2/2/2; KS at 2/2/2 through
``generate_ks`` at tend 5, dt 0.01, the resolutions 250-200 and 250-40)
read by both packages, the k-NN graph, the experiments' PDEs and grids,
and the slice as a whole: ``setup_experiment`` on those files.

* the dataset families (WE's mean kernel and its down-projected x, KF's
  zero pad, KS's periodic pad) against the JAX ``PDEDataset`` on the same
  ``.h5``: equal arrays, and the port's ``.npz`` equal to its ``.h5``;
* ``build_neighbors_knn`` against the JAX package's numpy path on the
  Chebyshev grids (nx 100, 50, 40, 20, the float32 coordinates the
  dataset holds) and on cylindrical coordinates: equal lists, ties broken
  alike; the graph's in-degrees are unequal (2 to 5 at K = 3);
* ``pde_for_experiment``, ``uniform_grid`` (KS: x over [0, 2 pi L), dt =
  tend / nt) and ``grid_from_h5`` (WE: the super grid's x down-projected)
  against the JAX functions, the ValueErrors on resolutions outside the
  reference's;
* MSMP-PDE and MP-PDE (one layer or pair, hidden 128, the JAX MPSolver with
  ``mp_impl="xla"``, ``lem_impl="xla"``) built by each package's
  ``setup_experiment`` on WE3 (nx 20 from 40: K = 3 k-NN, the variables
  bc_left and bc_right, V = 3 with t), KF (nx 40 from 200, r and D) and KS
  (nx 40 from 200, no variable), the JAX weights carried across by
  ``params_from_flax`` (and through ``save_npz`` / ``load_npz``), in
  float64: a forward at 1e-9, and a step's loss and every gradient at
  unrolled 0 and 1 (the JAX ``_one_step`` with SGD at rate R = 2^20, grad
  = (p - p') / R, as ``test_torch_model_2d.py`` reads it) at 1e-9.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msmp_pde_tpu.data import dataset as jdataset
from msmp_pde_tpu.data import graph as jgraph
from msmp_pde_tpu.models.registry import get_model as jget_model
from msmp_pde_tpu.serving import engine as jengine
from msmp_pde_tpu.training import setup as jsetup
from msmp_pde_tpu.training.loop import Trainer as JTrainer
from msmp_pde_tpu.utils import native
from msmp_pde_torch.data.dataset import PDEDataset
from msmp_pde_torch.data.graph import build_neighbors_knn
from msmp_pde_torch.datagen import generate
from msmp_pde_torch.equations.we import cheb_grid_ascending
from msmp_pde_torch.serving import engine
from msmp_pde_torch.training import setup, train
from msmp_pde_torch.training.loop import Trainer
from msmp_pde_torch.utils.convert import load_npz, params_from_flax, save_npz

from _torch_helpers import np_tree, one_thread, tt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
# experiment -> (base resolution, super resolution, dataset stem)
CASES = {"WE3": ((250, 20), (250, 40), "WE_WE3"),
         "KF": ((250, 40), (250, 200), "KF_KF"),
         "KS": ((250, 40), (250, 200), "KS_KS")}
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("families")
    argv = ["--train_samples=2", "--valid_samples=2", "--test_samples=2",
            "--device=cpu", "--chunk=2", "--batch_size=2",
            f"--data_dir={out}"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for e in ("WE3", "KF"):
            generate.main(generate.build_parser().parse_args(
                [f"--experiment={e}"] + argv))
        generate.generate_ks(generate.build_parser().parse_args(
            ["--experiment=KS"] + argv), 5.0, 0.01,
            resolutions=[(250, 200), (250, 40)])
    finally:
        torch.set_num_threads(n)
    return str(out)


def _args(experiment, model="MSMP-PDE", data_dir="data"):
    base, sup, _ = CASES[experiment]
    return train.build_parser().parse_args(
        [f"--experiment={experiment}", f"--model={model}",
         "--base_resolution=%d,%d" % base, "--super_resolution=%d,%d" % sup,
         "--n_graph_layers=1", "--batch_size=2", "--device=cpu",
         f"--data_dir={data_dir}"])


@pytest.mark.parametrize("experiment", list(CASES))
def test_dataset_matches_jax(data_dir, experiment, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    base, sup, stem = CASES[experiment]
    pde = setup.pde_for_experiment(experiment, base)
    jpde = jsetup.pde_for_experiment(experiment, base)
    for mode in generate.MODES:
        path = os.path.join(data_dir, stem)
        sets = [PDEDataset(f"{path}.npz", pde, mode, base, sup),
                PDEDataset(f"{path}.h5", pde, mode, base, sup),
                jdataset.PDEDataset(f"{path}.h5", jpde, mode, base, sup)]
        want = sets[2]
        assert want.u_super.shape == (2, 250, base[1])
        for ds in sets[:2]:
            for attr in ("u_base", "u_super", "x"):
                a, b = getattr(ds, attr), getattr(want, attr)
                assert a.dtype == b.dtype == np.float32, attr
                np.testing.assert_array_equal(a, b, err_msg=attr)
            assert (ds.nt, ds.dt, ds.dx, ds.tmin, ds.tmax) == (
                want.nt, want.dt, want.dx, want.tmin, want.tmax)
            assert set(ds.variables) == set(want.variables) == set(
                PDEDataset.VAR_NAMES[f"{pde}"])
            for k, v in want.variables.items():
                np.testing.assert_array_equal(ds.variables[k], v)
            assert ds.n_components == 1


@pytest.mark.parametrize("nx", [100, 50, 40, 20])
def test_knn_matches_jax(nx, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    x = cheb_grid_ascending(-8.0, 8.0, nx).astype(np.float32)
    for pts in (x.astype(np.float64), jgraph.cylindrical_coords(
            np.linspace(0.0, 16.0, nx))):
        got = build_neighbors_knn(pts, 3)
        want = jgraph.build_neighbors_knn(pts, 3)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    idx, mask = build_neighbors_knn(x, 3)
    deg = np.bincount(idx.ravel(), minlength=nx)
    assert mask.shape == (nx, 3) and (mask == 1).all()
    assert deg.min() == 2 and deg.max() == 5 and deg.sum() == 3 * nx


@pytest.mark.parametrize("experiment", ["WE1", "WE2", "WE3", "KF", "KS"])
def test_experiment_pde_and_grids(data_dir, experiment):
    fam = setup.data_family(experiment)
    base, sup, stem = CASES.get(experiment, CASES["WE3"])
    got = setup.pde_for_experiment(experiment, base)
    want = jsetup.pde_for_experiment(experiment, base)
    assert f"{got}" == f"{want}" == fam and got.n_components == 1
    for a in ("nt", "nx", "dt", "dx", "L", "tmin", "tmax"):
        if hasattr(want, a):
            assert getattr(got, a) == getattr(want, a), a
    bad = {"WE": (250, 30), "KF": (250, 20), "KS": (100, 100)}[fam]
    with pytest.raises(ValueError, match="runs at"):
        setup.pde_for_experiment(experiment, bad)
    if fam == "WE":
        for uniform in (setup.uniform_grid, jengine.uniform_grid):
            with pytest.raises(ValueError, match="data-defined"):
                uniform(got, base)
    else:
        g, w = setup.uniform_grid(got, base), jengine.uniform_grid(want, base)
        np.testing.assert_array_equal(g.x, w.x)
        assert (g.nt, g.dt, g.tmin, g.tmax, g.n_components) == (
            w.nt, w.dt, w.tmin, w.tmax, w.n_components)
    if experiment in CASES:
        path = os.path.join(data_dir, stem)
        w = jengine.grid_from_h5(f"{path}.h5", want, "test", base, sup)
        for ext in ("npz", "h5"):
            g = engine.grid_from_h5(f"{path}.{ext}", got, "test", base, sup)
            np.testing.assert_array_equal(g.x, w.x)
            assert (g.nt, g.dt, g.tmin, g.tmax, g.n_components) == (
                w.nt, w.dt, w.tmin, w.tmax, w.n_components)


@functools.lru_cache(maxsize=None)
def _jax_side(data_dir, experiment, model):
    """(JAX trainer in float64 with mp_impl="xla", lem_impl="xla", its
    float64 params, the JAX experiment) built on the .h5 as the JAX
    setup_experiment builds it."""
    args = _args(experiment, model)
    cwd = os.getcwd()
    os.chdir(os.path.dirname(data_dir))
    try:
        jexp = jsetup.setup_experiment(args, modes=("train",),
                                       data_dir=os.path.basename(data_dir))
    finally:
        os.chdir(cwd)
    ds = jexp.datasets["train"]
    jm, kind = jget_model(
        model, tw=args.time_window, n_eq_vars=len(jexp.eq_norms),
        L=float(getattr(jexp.pde, "L", 16.0)), tmax=float(ds.tmax),
        dt=float(ds.dt), n_layers=1, eq_var_names=tuple(jexp.eq_norms),
        positions=np.asarray(ds.x), mp_impl="xla", lem_impl="xla")
    s = jexp.spec
    f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
    spec = dataclasses.replace(s, x=f64(s.x), mask=f64(s.mask),
                               t_grid=f64(s.t_grid))
    jtr = JTrainer(model=jm, kind=kind, spec=spec, eq_norms=jexp.eq_norms)
    B, nx, V = 2, spec.nx, 1 + len(jexp.eq_norms)
    f = lambda a: jnp.asarray(a, jnp.float32)
    params = np_tree(jax.jit(jm.init)(
        jax.random.PRNGKey(0), f(np.zeros((B, nx, args.time_window))),
        f(np.broadcast_to(np.asarray(s.x), (B, nx))), f(np.zeros(B)),
        f(np.zeros((B, V))), s.idx, f(s.mask)))
    return jtr, params, jexp


def _port_side(data_dir, experiment, model, params, tmp_path):
    """The port's setup_experiment trainer in float64 with the JAX weights,
    carried by params_from_flax and through an .npz."""
    exp = setup.setup_experiment(_args(experiment, model, data_dir),
                                 modes=("train",), data_dir=data_dir)
    tr = exp.trainer
    path = str(tmp_path / "w.npz")
    save_npz(path, params_from_flax(params))
    tr.model.load_state_dict(load_npz(path), strict=True)
    s = tr.spec
    spec = dataclasses.replace(s, x=s.x.double(), mask=s.mask.double(),
                               t_grid=s.t_grid.double())
    return Trainer(model=tr.model.double(), kind=tr.kind, spec=spec,
                   eq_norms=tr.eq_norms), exp


def _sides(data_dir, experiment, model, tmp_path):
    jtr, params, jexp = _jax_side(data_dir, experiment, model)
    trainer, exp = _port_side(data_dir, experiment, model, params, tmp_path)
    np.testing.assert_array_equal(trainer.spec.idx.numpy(),
                                  np.asarray(jtr.spec.idx))
    np.testing.assert_array_equal(trainer.spec.x.numpy(),
                                  np.asarray(jtr.spec.x))
    assert trainer.eq_norms == jexp.eq_norms
    ds = exp.datasets["train"]
    u = ds.u_super.astype(np.float64)
    var = {k: v.astype(np.float64) for k, v in ds.variables.items()}
    return jtr, params, trainer, u, var


MODELS = ["MSMP-PDE", "MP-PDE"]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("experiment", list(CASES))
def test_forward_matches_jax(data_dir, experiment, model, tmp_path):
    jtr, params, trainer, u, var = _sides(data_dir, experiment, model,
                                          tmp_path)
    if experiment == "WE3":
        assert trainer.spec.idx.shape == (20, 3)
        assert set(trainer.eq_norms) == {"bc_left", "bc_right"}
    steps = np.array([25, 140])  # each sample's window ends at its step
    window = np.stack([u[0, 0:25].T, u[1, 115:140].T])
    want, _ = jax.jit(jtr.forward)(
        params, jnp.asarray(window), jnp.asarray(steps),
        {k: jnp.asarray(v) for k, v in var.items()})
    with torch.no_grad():
        got, _ = trainer.forward(tt(window), torch.as_tensor(steps),
                                 {k: tt(v) for k, v in var.items()})
    assert got.shape == window.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _leaf(tree, name):
    node = tree["params"]
    for part in name.split("."):
        node = node[part]
    return np.asarray(node)


@pytest.mark.parametrize("unrolled", [0, 1])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("experiment", list(CASES))
def test_step_matches_jax(data_dir, experiment, model, unrolled, tmp_path):
    jtr, params, trainer, u, var = _sides(data_dir, experiment, model,
                                          tmp_path)
    ib = np.array([1, 0])
    st = np.array([25, 250 - 25 * (unrolled + 1)])
    R = 2.0 ** 20
    tx = optax.sgd(R)
    new, _, jloss = jax.jit(jtr._one_step(tx, unrolled))(
        params, tx.init(params), jnp.asarray(u),
        {k: jnp.asarray(v) for k, v in var.items()}, jnp.asarray(ib),
        jnp.asarray(st))
    loss = trainer.step_loss(tt(u), {k: tt(v) for k, v in var.items()},
                             torch.as_tensor(ib), torch.as_tensor(st),
                             unrolled)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    named = list(trainer.model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    new = jax.device_get(new)
    for (name, _), g in zip(named, grads):
        want = (_leaf(params, name) - _leaf(new, name)) / R
        np.testing.assert_allclose(g.numpy(), want, err_msg=name, **TOL)
