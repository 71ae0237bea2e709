"""PyTorch port, the grid models' path through the trainer, the serving
engine and the metrics (training/loop.py: ``window_to_grid``,
``grid_to_window``, ``make_grid_vars``, the grid branch of
``Trainer.forward``) against the JAX package's, float64 unless said:

* the layout maps at d = 1 and 2: exact;
* the grid variables on E3 (norms 3.0 / 0.4 / 1.0) and RP (b differs from
  a, and b stays b): exact;
* a training step's loss and every gradient at unrolled 0 and 1, BaseCNN
  on E1's spec, FNO2DP on RP's and FNO2DPU on RPU's LCG grid (nx 40, nt
  100, batch 2), the port's
  ``Trainer.step_loss`` against the JAX ``_one_step`` with SGD at rate R =
  2^20, grad = (p - p') / R (``test_torch_model_variants.py``): 1e-8;
* the engine's rollout of FNO on E1's uniform grid at nx 40 against the
  JAX engine (both float32 on the CPU: 1e-4, FFT orders differ) and
  against the chain of forwards (exact);
* ``compute_l2_norms`` of FNOP (E3's variables) and BaseCNN2D (RP):
  1e-9;
* chip_smoke's grid helpers: ``flax_tree`` draws each grid model's leaves
  within their initializers' bounds and loads strictly,
  ``expected_launches`` counts none, ``plain_forward`` is the forward.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msmp_pde_tpu.data.graph import GraphSpec as JSpec
from msmp_pde_tpu.data.graph import build_neighbors_radius
from msmp_pde_tpu.models.registry import get_model as jget_model
from msmp_pde_tpu.training import loop as jloop
from msmp_pde_torch.data.graph import GraphSpec, advance_windows
from msmp_pde_torch.datagen.ics import pseudo_random_grid
from msmp_pde_torch.models.registry import get_model
from msmp_pde_torch.training import loop
from msmp_pde_torch.utils.convert import params_from_flax

from _torch_helpers import np_tree, one_thread, tt  # noqa: F401

NX, B, TW, NT, L, TMAX = 40, 2, 25, 100, 16.0, 4.0
DT = TMAX / (NT - 1)
NORMS = {"E1": {}, "E3": {"alpha": 3.0, "beta": 0.4, "gamma": 1.0},
         "RP": {"a": 1.0, "b": 1.0}, "RPU": {"a": 1.0, "b": 1.0}}
pytestmark = pytest.mark.usefixtures("one_thread")


def _d(experiment):
    return 2 if experiment in ("RP", "RPU") else 1


def _x(experiment):
    """The grid: uniform, or RPU's LCG grid (float32, as its dataset
    holds it), which FNO2DPU resamples from."""
    if experiment == "RPU":
        return pseudo_random_grid(0.0, L, NX).astype(np.float32)
    return np.linspace(0.0, L, NX)


@functools.lru_cache(maxsize=None)
def _jax_side(name, experiment):
    """(JAX trainer, its float64 params) of ``name`` on ``experiment``'s
    grid at nx 40, nt 100."""
    x = _x(experiment)
    idx, mask = build_neighbors_radius(np.linspace(0.0, L, NX), 3)
    eq = NORMS[experiment]
    jm, kind = jget_model(name, tw=TW, n_eq_vars=len(eq), L=L, tmax=TMAX,
                          dt=DT, eq_var_names=tuple(eq),
                          positions=x.astype(np.float32))
    jspec = JSpec(idx=jnp.asarray(idx), mask=jnp.asarray(mask),
                  x=jnp.asarray(x), t_grid=jnp.asarray(
                      np.linspace(0.0, TMAX, NT)), tw=TW,
                  n_components=_d(experiment), L=L, tmax=TMAX, dt=DT)
    jtr = jloop.Trainer(model=jm, kind=kind, spec=jspec, eq_norms=eq)
    return jtr, np_tree(jtr.init_params(jax.random.PRNGKey(0), B))


def _models(name, experiment):
    jtr, params = _jax_side(name, experiment)
    x = _x(experiment)
    idx, mask = build_neighbors_radius(np.linspace(0.0, L, NX), 3)
    eq = NORMS[experiment]
    m, kind = get_model(name, tw=TW, n_eq_vars=len(eq), L=L, tmax=TMAX,
                        dt=DT, eq_var_names=tuple(eq),
                        positions=x.astype(np.float32))
    spec = GraphSpec(idx=torch.as_tensor(idx), mask=tt(mask),
                     x=torch.as_tensor(x),
                     t_grid=tt(np.linspace(0.0, TMAX, NT)), tw=TW,
                     n_components=_d(experiment), L=L, tmax=TMAX, dt=DT)
    trainer = loop.Trainer(model=m.double(), kind=kind, spec=spec,
                           eq_norms=eq)
    trainer.model.load_state_dict(params_from_flax(params), strict=True)
    return jtr, params, trainer


def _variables(experiment, rng, n):
    if experiment in ("RP", "RPU"):
        return {"a": rng.uniform(0.1, 1.0, n), "b": rng.uniform(1.0, 10.0, n)}
    return {k: rng.uniform(0.1, 1.0, n) * v
            for k, v in NORMS[experiment].items()}


def _traj(experiment, rng, n):
    shape = (n, NT, 2, NX) if _d(experiment) == 2 else (n, NT, NX)
    return rng.normal(size=shape) * 0.5


@pytest.mark.parametrize("d", [1, 2])
def test_window_grid_layout_matches_jax(d):
    w = np.random.default_rng(d).normal(size=(3, NX, d * TW))
    want = np.asarray(jloop.window_to_grid(jnp.asarray(w), d, TW))
    got = loop.window_to_grid(tt(w), d, TW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == ((3, TW, NX) if d == 1 else (3, TW, d, NX))
    np.testing.assert_array_equal(
        loop.grid_to_window(got, d, TW).numpy(),
        np.asarray(jloop.grid_to_window(jnp.asarray(want), d, TW)))
    np.testing.assert_array_equal(loop.grid_to_window(got, d, TW).numpy(), w)


@pytest.mark.parametrize("experiment", ["E1", "E3", "RP"])
def test_grid_vars_match_jax(experiment):
    rng = np.random.default_rng(4)
    var = _variables(experiment, rng, 3)
    norms = NORMS[experiment]
    want = jloop.make_var_fns(norms, TMAX)[1](
        {k: jnp.asarray(v) for k, v in var.items()})
    got = loop.make_grid_vars(norms)({k: tt(v) for k, v in var.items()})
    if not norms:
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    names = [n for n in ("alpha", "beta", "gamma", "a", "b") if n in norms]
    for i, n in enumerate(names):  # raw over the norm: beta not negated
        np.testing.assert_array_equal(got[:, i].numpy(), var[n] / norms[n])
    if experiment == "RP":  # b stays b, unlike the graph path
        assert not np.allclose(got[:, 1].numpy(), got[:, 0].numpy())


def _leaf(tree, name):
    node = tree["params"]
    for part in name.split("."):
        node = node[part]
    return np.asarray(node)


@pytest.mark.parametrize("unrolled", [0, 1])
@pytest.mark.parametrize("name,experiment", [("BaseCNN", "E1"),
                                             ("FNO2DP", "RP"),
                                             ("FNO2DPU", "RPU")])
def test_step_matches_jax(name, experiment, unrolled):
    jtr, params, trainer = _models(name, experiment)
    rng = np.random.default_rng(10 + unrolled)
    u = _traj(experiment, rng, 4)
    var = _variables(experiment, rng, 4)
    ib = rng.permutation(4)[:B]
    st = rng.integers(TW, NT - TW * (unrolled + 1) + 1, size=B)
    R = 2.0 ** 20
    tx = optax.sgd(R)
    new, _, jloss = jax.jit(jtr._one_step(tx, unrolled))(
        params, tx.init(params), jnp.asarray(u),
        {k: jnp.asarray(v) for k, v in var.items()}, jnp.asarray(ib),
        jnp.asarray(st))
    loss = trainer.step_loss(tt(u), {k: tt(v) for k, v in var.items()},
                             torch.as_tensor(ib), torch.as_tensor(st),
                             unrolled)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-8)
    named = list(trainer.model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    new = jax.device_get(new)
    for (pname, _), g in zip(named, grads):
        want = (_leaf(params, pname) - _leaf(new, pname)) / R
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-8, atol=1e-8,
                                   err_msg=pname)


def test_engine_rollout_fno_matches_jax():
    """FNO served on E1's uniform grid at nx 40 (float32, both engines on
    the CPU), from a start step whose windows cross nt - tw."""
    from msmp_pde_tpu.serving.engine import RolloutEngine as JEngine
    from msmp_pde_tpu.serving.engine import build_serving_trainer as jbuild
    from msmp_pde_torch.serving.engine import (
        RolloutEngine,
        build_serving_trainer,
    )

    res = (250, 40)
    jt = jbuild("E1", "FNO", base_resolution=res)
    jparams = jt.init_params(jax.random.PRNGKey(2), batch_size=2)
    jeng = JEngine(jt, jparams, batch_buckets=(2,))
    tr = build_serving_trainer("E1", "FNO", base_resolution=res,
                               device="cpu")
    assert tr.kind == "grid" and tr.spec.nx == 40
    eng = RolloutEngine(tr, params_from_flax(np_tree(jparams, np.float32)),
                        batch_buckets=(2,))
    window = np.random.default_rng(9).normal(size=(3, 40, 25)).astype(
        np.float32)
    got = eng.rollout(window, start_step=200, n_windows=3)
    want = jeng.rollout(window, start_step=200, n_windows=3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    w, preds = torch.as_tensor(window), []
    with torch.no_grad():
        for i in range(3):
            s = torch.clamp(torch.full((3,), 200 + 25 * i), 25, 225)
            pred, state = tr.forward(w, s, {})
            assert state is None
            preds.append(pred.numpy())
            w = advance_windows(w, pred, 1, 25)
    np.testing.assert_array_equal(got, np.stack(preds, axis=1))


@pytest.mark.parametrize("name,experiment", [("FNOP", "E3"),
                                             ("BaseCNN2D", "RP")])
def test_l2_norms_match_jax(name, experiment):
    from msmp_pde_tpu.training import metrics as jmetrics
    from msmp_pde_torch.training import metrics

    jtr, params, trainer = _models(name, experiment)
    rng = np.random.default_rng(6)
    u = _traj(experiment, rng, 3)
    var = _variables(experiment, rng, 3)
    quiet = dict(log=lambda *a: None)
    got = metrics.compute_l2_norms(trainer, tt(u),
                                   {k: tt(v) for k, v in var.items()}, 3, 1,
                                   NT, **quiet)
    want = jmetrics.compute_l2_norms(jtr, params, jnp.asarray(u),
                                     {k: jnp.asarray(v)
                                      for k, v in var.items()},
                                     3, 1, NT, **quiet)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("name", ["BaseCNN", "FNO", "FNOP", "VNO",
                                  "BaseCNN2D", "FNO2D", "FNO2DP"])
def test_chip_smoke_grid_helpers(name):
    from chip_smoke import (
        GRID_PARAMS,
        expected_launches,
        flax_tree,
        plain_forward,
    )
    from msmp_pde_torch.tools.model_times import experiment_of
    from msmp_pde_torch.training.setup import build_trainer

    tr = build_trainer(experiment_of(name), name, device="cpu")
    assert sum(p.numel() for p in tr.model.parameters()) == GRID_PARAMS[name]
    tree = flax_tree(tr.model, seed=1)
    state = params_from_flax(tree)
    tr.model.load_state_dict(state, strict=True)
    for key, v in state.items():
        v = v.double()
        if v.dim() == 4:  # spectral: scale U(0, 1)
            assert v.min() >= 0 and v.max() <= 1.0 / (v.shape[0] * v.shape[1])
        elif key.startswith("_CircularConv") and key.endswith("kernel"):
            o, c, k = v.shape
            assert v.abs().max() <= (6.0 / (c * k + o * k)) ** 0.5
        else:
            k = state[key[:-len("bias")] + "kernel"] if key.endswith(
                "bias") else v
            fan = k.shape[1] * k.shape[2] if k.dim() == 3 else k.shape[0]
            assert v.abs().max() <= fan ** -0.5, key
    assert not any(expected_launches(tr.model, 8, 2).values())
    assert plain_forward(tr) == tr.forward
