"""PyTorch port, RPU: the advection system on the unstructured LCG grid
(datagen/ics.py::pseudo_random_grid and the square family, data/graph.py's
cylindrical k-NN graph and random edges, RPU in datagen/generate.py,
data/dataset.py, training/setup.py and serving/engine.py), against the
JAX package, float64 unless said:

* the LCG grid at nx 40, 50, 100 and 200: bitwise;
* the k-NN lists (K = 3) on the cylindrical coordinates of the
  float32-rounded grid, as the dataset holds it, at nx 40 and 100:
  exactly, through ``build_graph_spec`` on both sides; nx 40 and 100 have
  nodes of in-degree 0; ``add_random_edges`` from one seed: exactly;
* the square initial condition (the JAX sampler's breakpoints) and the
  exact solve on the LCG grid of the square and sinesum families: 1e-12;
* the generate CLI's RPU on the CPU: each resolution's stored x is the
  LCG grid bit for bit, the first chunk the exact solve of the draws on
  it; ``PDEDataset`` (the .npz and the .h5) against the JAX reader:
  equal arrays, the target the base trajectories; the served grid;
* the repairs: ``--data_suffix _I`` makes ``setup_experiment`` (``fit``)
  and the server build the uniform grid's radius stencil, as JAX's
  ``setup_experiment`` and ``build_serving_trainer`` do; without it the
  k-NN graph, as JAX's;
* MSMP-PDE2D and MP-PDE2D (one pair or layer) on RPU's nx-40 graph, which
  has a node of in-degree 0: a forward and a step's loss and gradients at
  unrolled 0 and 1 against the JAX registry's models (one JAX program a
  model: its ``_one_step`` with a transformation that hands back the
  gradients): 1e-9 (of the scale of each gradient).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msmp_pde_tpu.data import graph as jgraph
from msmp_pde_tpu.data.dataset import PDEDataset as JPDEDataset
from msmp_pde_tpu.datagen import ics as jics
from msmp_pde_tpu.equations.ad import exact_solution_batch as jexact
from msmp_pde_tpu.models.registry import get_model as jget_model
from msmp_pde_tpu.serving import engine as jengine
from msmp_pde_tpu.training import setup as jsetup
from msmp_pde_tpu.training.loop import Trainer as JTrainer
from msmp_pde_torch.data import graph
from msmp_pde_torch.data.dataset import PDEDataset
from msmp_pde_torch.data.interpolate import interpolate_file
from msmp_pde_torch.datagen import generate, hdf5_io, ics
from msmp_pde_torch.serving import engine
from msmp_pde_torch.training import setup
from msmp_pde_torch.training.loop import Trainer

from chip_smoke import grad_scales

from _torch_helpers import np_tree, one_thread, tt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
L, TMAX, TW = 16.0, 4.0, 25


@pytest.mark.parametrize("nx", [40, 50, 100, 200])
def test_lcg_grid_bitwise(nx):
    got = ics.pseudo_random_grid(0.0, L, nx)
    want = jics.pseudo_random_grid(0.0, L, nx)
    assert got.dtype == want.dtype == np.float64 and got.shape == (nx,)
    assert got.tobytes() == want.tobytes()
    assert got[0] == 0.0 and got[-1] == L and (np.diff(got) > 0).all()


def _grid(nx):
    """RPU's grid at nx as a dataset holds it: float32."""
    x = ics.pseudo_random_grid(0.0, L, nx).astype(np.float32)
    return setup.GridInfo(x=x, nt=250, dt=TMAX / 249, tmin=0.0, tmax=TMAX,
                          n_components=2)


@pytest.mark.parametrize("nx", [40, 100])
def test_knn_lists_match_jax(nx):
    grid = _grid(nx)
    spec = graph.build_graph_spec(setup.pde_for_experiment("RPU", (250, nx)),
                                  grid, 3, TW, "cpu")
    jspec = jgraph.build_graph_spec(
        jsetup.pde_for_experiment("RPU", (250, nx)), grid, 3, TW)
    idx = spec.idx.numpy()
    np.testing.assert_array_equal(idx, np.asarray(jspec.idx))
    np.testing.assert_array_equal(spec.mask.numpy(), np.asarray(jspec.mask))
    assert idx.shape == (nx, 3) and (spec.mask.numpy() == 1).all()
    # the lists of the float32-rounded grid, embedded in float64
    pts = graph.cylindrical_coords(grid.x.astype(np.float64))
    np.testing.assert_array_equal(
        pts, jgraph.cylindrical_coords(grid.x.astype(np.float64)))
    np.testing.assert_array_equal(idx, graph.build_neighbors_knn(pts, 3)[0])
    deg = np.bincount(idx.ravel(), minlength=nx)
    assert deg.min() == 0 and deg.max() == 6  # nodes that send no message
    np.testing.assert_array_equal(spec.x.numpy(), grid.x)


@pytest.mark.parametrize("p", [0.05, 0.2])
def test_add_random_edges_matches_jax(p):
    """On RPU's k-NN graph and on a radius stencil with masked slots, from
    one seed; and through ``build_graph_spec``."""
    for idx, mask in (
            graph.build_neighbors_knn(
                graph.cylindrical_coords(_grid(40).x.astype(np.float64)), 3),
            graph.build_neighbors_radius(np.linspace(0.0, L, 30), 2)):
        got = graph.add_random_edges(idx, mask, p, np.random.default_rng(3))
        want = jgraph.add_random_edges(idx, mask, p,
                                       np.random.default_rng(3))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[0].shape[1] > idx.shape[1]
    grid = _grid(40)
    spec = graph.build_graph_spec(setup.pde_for_experiment("RPU", (250, 40)),
                                  grid, 3, TW, "cpu", random_edge_prob=p)
    jspec = jgraph.build_graph_spec(
        jsetup.pde_for_experiment("RPU", (250, 40)), grid, 3, TW,
        random_edge_prob=p)
    np.testing.assert_array_equal(spec.idx.numpy(), np.asarray(jspec.idx))
    np.testing.assert_array_equal(spec.mask.numpy(), np.asarray(jspec.mask))


def test_square_ic_and_the_exact_solve_match_jax():
    """The square field from the JAX sampler's breakpoints at points in
    and outside [0, L); the exact solve of the square and the sinesum
    families on the LCG grid (``generate.ad_solver``) against the JAX
    solve on the same grid; the port's sampler's draws."""
    (lo, hi), jfn = jics.sample_square_ic(jax.random.PRNGKey(0), 3, 200, L)
    fn = ics.square_ic(tt(np.asarray(lo)), tt(np.asarray(hi)), L)
    pts = np.random.default_rng(1).uniform(-20.0, 30.0, (3, 64))
    got = fn(tt(pts)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(pts))))
    assert set(np.unique(got[:, 0])) <= {0.0, 1.0} and (got[:, 1] == 0).all()
    rng = np.random.default_rng(2)
    a, b = rng.uniform(0.1, 1.0, 3), rng.uniform(1.0, 10.0, 3)
    pdes = generate.ad_pdes(TMAX, "square")
    pde = pdes["pde_250-100"]
    assert pde.L == L
    x = jnp.asarray(jics.pseudo_random_grid(0.0, L, 100))
    ts = jnp.linspace(0.0, TMAX, 250)
    sines, jsine = jics.sample_sinesum_ic(jax.random.PRNGKey(1), 3, L, 5, 1,
                                          3)
    for family, jfn_, params in (("square", jfn, (lo, hi)),
                                 ("sinesum", jsine, sines)):
        want = np.asarray(jexact(jfn_, x, ts, jnp.asarray(a),
                                 jnp.asarray(b)))
        solve = generate.ad_solver(pde, family, torch.float64, "cpu",
                                   unstructured_grid=True)
        got = solve(tt(a), tt(b), *(tt(np.asarray(p)) for p in params))
        assert got.shape == (3, 2, 250, 100)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)
    lo, hi = generate.draw_ad_chunk(np.random.default_rng(4), 8, 2,
                                    (0.1, 1.0), (1.0, 10.0), "square",
                                    next(iter(pdes.values())))[2:]
    assert lo.shape == hi.shape == (8, 2) and (lo <= hi).all()
    steps = np.concatenate([lo, hi]) * 200 / L  # multiples of L / nx
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-12)
    assert lo.min() >= 0.0 and hi.max() < L


@pytest.fixture(scope="module")
def rpu_data(tmp_path_factory, one_thread):
    """The generate CLI's RPU (4/2/2 samples, chunk 4, groups of 2) and its
    interpolated ``_I`` files, under data/ of a fresh directory."""
    root = tmp_path_factory.mktemp("rpu")
    data = root / "data"
    argv = ["--experiment=RPU", "--chunk=4", "--batch_size=2",
            "--device=cpu", f"--data_dir={data}", "--train_samples=4",
            "--valid_samples=2", "--test_samples=2"]
    generate.main(generate.build_parser().parse_args(argv))
    interpolate_file(str(data / "AD_RPU.npz"), str(data / "AD_RPU_I"),
                     device="cpu")
    return root


def test_generate_rpu_schema_and_draws(rpu_data):
    """Each resolution's x is the LCG grid bit for bit (the JAX CLI's
    ``grid_for``); the rest of RP's schema; the first train chunk the
    exact solve of ``draw_ad_chunk``'s draws on that grid."""
    tmax, a_range, b_range, family = generate.AD_EXPERIMENTS["RPU"]
    assert (tmax, family) == (TMAX, "sinesum")
    pdes = generate.ad_pdes(tmax, family)
    with hdf5_io.open_dataset(str(rpu_data / "data" / "AD_RPU.npz")) as z, \
            hdf5_io.open_dataset(str(rpu_data / "data" / "AD_RPU.h5")) as f:
        for mode, n in zip(generate.MODES, (4, 2, 2)):
            for nt, nx in generate.RES_AD:
                name = f"{mode}/pde_{nt}-{nx}"
                u, at = z.array(name), z.attrs(name)
                assert u.shape == (n, 2, nt, nx) and np.isfinite(u).all()
                np.testing.assert_array_equal(u, f.array(name))
                x = jics.pseudo_random_grid(0.0, L, nx)
                assert at["x"].tobytes() == x.tobytes()
                assert f.attrs(name)["x"].tobytes() == x.tobytes()
                assert (float(at["dt"]), float(at["dx"])) == (
                    tmax / (nt - 1), L / nx)
            a = z.array(f"{mode}/a")
            assert a[0] == a[1] and a_range[0] <= a.min() <= a_range[1]
        draws = generate.draw_ad_chunk(np.random.default_rng(0), 4, 2,
                                       a_range, b_range, family,
                                       next(iter(pdes.values())))
        for k, pde in pdes.items():
            want = generate.ad_solver(pde, family, torch.float64, "cpu",
                                      unstructured_grid=True)(
                *(torch.as_tensor(d) for d in draws)).numpy()
            np.testing.assert_array_equal(z.array(f"train/{k}"), want)


def test_dataset_and_served_grid_match_jax(rpu_data):
    npz = str(rpu_data / "data" / "AD_RPU.npz")
    h5 = str(rpu_data / "data" / "AD_RPU.h5")
    pde = setup.pde_for_experiment("RPU", (250, 100))
    jpde = jsetup.pde_for_experiment("RPU", (250, 100))
    for mode in generate.MODES:
        sets = [PDEDataset(npz, pde, mode), PDEDataset(h5, pde, mode),
                JPDEDataset(h5, jpde, mode)]
        for ds in sets[1:]:
            for attr in ("u_base", "u_super", "x"):
                a, b = getattr(sets[0], attr), getattr(ds, attr)
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            for k, v in sets[0].variables.items():
                np.testing.assert_array_equal(v, ds.variables[k])
        # the target is the base trajectory itself, on the base's grid
        np.testing.assert_array_equal(sets[0].u_super, sets[0].u_base)
        assert sets[0].u_super.shape == (len(sets[0]), 250, 2, 100)
        np.testing.assert_array_equal(
            sets[0].x, ics.pseudo_random_grid(0.0, L, 100).astype(np.float32))
    got = engine.grid_from_h5(npz, pde, "test", (250, 100), (250, 200))
    want = jengine.grid_from_h5(h5, jpde, "test", (250, 100), (250, 200))
    np.testing.assert_array_equal(got.x, want.x)
    assert (got.nt, got.dt, got.tmin, got.tmax, got.n_components) == (
        want.nt, want.dt, want.tmin, want.tmax, want.n_components)


def _train_args(data, *extra):
    from msmp_pde_tpu.training.train import build_parser as jparser
    from msmp_pde_torch.training.train import build_parser

    argv = ["--experiment=RPU", "--model=MSMP-PDE2D", "--n_graph_layers=1",
            f"--data_dir={data}", *extra]
    return build_parser().parse_args(argv + ["--device=cpu"]), \
        jparser().parse_args(argv)


RADIUS = graph.build_neighbors_radius(np.linspace(0.0, L, 100), 3)


@pytest.mark.parametrize("suffix", ["", "_I"])
def test_setup_experiment_data_suffix_matches_jax(rpu_data, suffix):
    """Repair 1: ``fit``'s set-up on the ``_I`` files builds the uniform
    grid's radius stencil, as JAX's does; on the raw files the k-NN
    graph."""
    data = rpu_data / "data"
    args, jargs = _train_args(data, f"--data_suffix={suffix}")
    exp = setup.setup_experiment(args, data_dir=str(data))
    jexp = jsetup.setup_experiment(jargs, data_dir=str(data))
    idx = exp.trainer.spec.idx.numpy()
    np.testing.assert_array_equal(idx, np.asarray(jexp.spec.idx))
    np.testing.assert_array_equal(exp.trainer.spec.mask.numpy(),
                                  np.asarray(jexp.spec.mask))
    np.testing.assert_array_equal(exp.trainer.spec.x.numpy(),
                                  np.asarray(jexp.spec.x))
    for m, ds in exp.datasets.items():
        np.testing.assert_array_equal(ds.u_super, jexp.datasets[m].u_super)
    if suffix:
        np.testing.assert_array_equal(idx, RADIUS[0])
        assert not exp.pde.unstructured_grid
    else:
        assert idx.shape == (100, 3) and exp.pde.unstructured_grid


@pytest.mark.parametrize("suffix", ["", "_I"])
def test_server_data_suffix_matches_jax(rpu_data, tmp_path, suffix):
    """Repair 2: the server's trainer takes ``--data_suffix`` and applies
    the same override, as JAX's ``build_serving_trainer``; the HTTP
    server's CLI passes it through."""
    from msmp_pde_torch.serving import serve
    from msmp_pde_torch.utils.checkpoint import save_checkpoint

    data = rpu_data / "data"
    path = setup.resolve_data_path(str(data), "AD", "RPU", suffix, "test")
    kw = dict(base_resolution=(250, 100), n_graph_layers=1,
              data_suffix=suffix)
    tr = engine.build_serving_trainer("RPU", "MSMP-PDE2D", data_path=path,
                                      device="cpu", **kw)
    jtr = jengine.build_serving_trainer(
        "RPU", "MSMP-PDE2D", data_path=path.replace(".npz", ".h5"), **kw)
    np.testing.assert_array_equal(tr.spec.idx.numpy(),
                                  np.asarray(jtr.spec.idx))
    np.testing.assert_array_equal(tr.spec.x.numpy(), np.asarray(jtr.spec.x))
    ckpt = str(tmp_path / "w.pt")
    save_checkpoint(ckpt, tr.model)
    sargs = serve.build_parser().parse_args([
        "--experiment=RPU", "--model=MSMP-PDE2D", f"--checkpoint={ckpt}",
        f"--data_dir={data}", f"--data_suffix={suffix}", "--port=0",
        "--n_graph_layers=1", "--warmup_windows=0", "--device=cpu"])
    srv, eng = serve.build_server(sargs)
    srv.server_close()
    np.testing.assert_array_equal(eng.trainer.spec.idx.numpy(),
                                  tr.spec.idx.numpy())
    if suffix:
        np.testing.assert_array_equal(tr.spec.idx.numpy(), RADIUS[0])
    else:
        assert tr.spec.idx.shape == (100, 3)


# --- the graph models on RPU's nx-40 graph -----------------------------------
NX, B, NT = 40, 2, 100
DT = TMAX / (NT - 1)
EQ = {"a": 1.0, "b": 1.0}
# hands the gradients back as the optimizer's state, the parameters kept
GRAB = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _rpu_graph():
    """(x as float64 of the float32 grid, idx, mask) of RPU at nx 40,
    ``build_graph_spec``'s lists (equal to JAX's, above)."""
    grid = _grid(NX)
    spec = graph.build_graph_spec(setup.pde_for_experiment("RPU", (250, NX)),
                                  grid, 3, TW, "cpu")
    return grid.x.astype(np.float64), spec.idx.numpy(), spec.mask.numpy()


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(the JAX params, the inputs, the JAX forward and the (loss,
    gradients) at unrolled 0 and 1), from one jitted program."""
    x, idx, mask = _rpu_graph()
    deg = np.bincount(idx.ravel(), minlength=NX)
    assert deg.min() == 0  # a node that sends no message
    jm, kind = jget_model(name, tw=TW, n_eq_vars=2, L=L, tmax=TMAX, dt=DT,
                          n_layers=1, eq_var_names=tuple(EQ), mp_impl="xla",
                          lem_impl="xla")
    jspec = jgraph.GraphSpec(
        idx=jnp.asarray(idx), mask=jnp.asarray(mask, jnp.float64),
        x=jnp.asarray(x), t_grid=jnp.asarray(np.linspace(0.0, TMAX, NT)),
        tw=TW, n_components=2, L=L, tmax=TMAX, dt=DT)
    jtr = JTrainer(model=jm, kind=kind, spec=jspec, eq_norms=EQ)
    f = lambda a: jnp.asarray(a, jnp.float32)
    params = np_tree(jm.init(
        jax.random.PRNGKey(7), f(np.zeros((B, NX, 2 * TW))),
        f(np.broadcast_to(x, (B, NX))), f(np.zeros(B)), f(np.zeros((B, 3))),
        jnp.asarray(idx), f(mask)))
    rng = np.random.default_rng(8)
    var = lambda n: {"a": rng.uniform(0.1, 1.0, n),
                     "b": rng.uniform(1.0, 10.0, n)}
    inp = types.SimpleNamespace(
        window=rng.normal(size=(B, NX, 2 * TW)),
        steps=rng.integers(TW, NT - TW, size=B), var=var(B),
        u=rng.normal(size=(4, NT, 2, NX)), var4=var(4),
        ib=rng.permutation(4)[:B],
        st=[rng.integers(TW, NT - TW * (k + 1) + 1, size=B) for k in (0, 1)])
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}

    def ref(p):
        fwd, _ = jtr.forward(p, jnp.asarray(inp.window),
                             jnp.asarray(inp.steps), J(inp.var))
        steps = []
        for unrolled in (0, 1):
            _, g, loss = jtr._one_step(GRAB, unrolled)(
                p, GRAB.init(p), jnp.asarray(inp.u), J(inp.var4),
                jnp.asarray(inp.ib), jnp.asarray(inp.st[unrolled]))
            steps.append((loss, g))
        return fwd, steps

    out = jax.device_get(jax.jit(ref)(
        jax.tree_util.tree_map(jnp.asarray, params)))
    return params, inp, out


def _port(name, params):
    from msmp_pde_torch.models.registry import get_model
    from msmp_pde_torch.utils.convert import params_from_flax

    x, idx, mask = _rpu_graph()
    m, kind = get_model(name, tw=TW, n_eq_vars=2, L=L, tmax=TMAX, dt=DT,
                        n_layers=1)
    m.load_state_dict(params_from_flax(params), strict=True)
    spec = graph.GraphSpec(idx=torch.as_tensor(idx, dtype=torch.int64),
                           mask=tt(mask), x=tt(x),
                           t_grid=tt(np.linspace(0.0, TMAX, NT)), tw=TW,
                           n_components=2, L=L, tmax=TMAX, dt=DT)
    return Trainer(model=m.double(), kind=kind, spec=spec, eq_norms=EQ)


def _leaf(tree, name):
    node = tree["params"]
    for part in name.split("."):
        node = node[part]
    return np.asarray(node)


@pytest.mark.parametrize("part", ["forward", "unrolled0", "unrolled1"])
@pytest.mark.parametrize("name", ["MSMP-PDE2D", "MP-PDE2D"])
def test_graph_model_on_rpu_graph_matches_jax(name, part):
    params, inp, (fwd, steps) = _reference(name)
    tr = _port(name, params)
    T = lambda d: {k: tt(v) for k, v in d.items()}
    if part == "forward":
        with torch.no_grad():
            got, _ = tr.forward(tt(inp.window), torch.as_tensor(inp.steps),
                                T(inp.var))
        np.testing.assert_allclose(got.numpy(), np.asarray(fwd), rtol=1e-9,
                                   atol=1e-9 * np.abs(fwd).max())
        return
    unrolled = int(part[-1])
    jloss, jgrads = steps[unrolled]
    loss = tr.step_loss(tt(inp.u), T(inp.var4), torch.as_tensor(inp.ib),
                        torch.as_tensor(inp.st[unrolled]), unrolled)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-9)
    named = list(tr.model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    want = {n: _leaf(jgrads, n) for n, _ in named}
    scales = grad_scales((n, torch.as_tensor(w)) for n, w in want.items())
    for (pname, _), g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want[pname], rtol=1e-9,
                                   atol=1e-9 * scales[pname], err_msg=pname)
