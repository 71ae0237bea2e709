"""PyTorch port, the five 1-D graph variants of MSMP-PDE (models/gnn.py::
MPSolver with the LSTM encoder, the GLU and diff_only decoders, the twin
towers and the stateful LEM; models/lstm.py; models/common.py::GLUConv)
against the JAX MPSolver built by the JAX registry on the same converted
weights: MSSMP-PDE, MSGMP-PDE (hidden 164, the only width its GLU decoder
takes), SaveMSMP-PDE, LSTMGated and LSTM at hidden 128, one layer or pair,
nx=24, B=2, JAX ``mp_impl="xla"``, ``lem_impl="xla"``, in float64 except
the LSTM models: the JAX LSTM's carry is float32 (flax's
``initialize_carry`` at its float32 ``param_dtype``), and its scan refuses
a float64 step, so both sides run those in float32.

* the forward, and SaveMSMP-PDE's returned state, with a zero and with a
  non-zero initial state: 1e-10 (float32: 1e-5, the summation order of
  25 recurrent steps and one layer);
* one training step's loss and every parameter's gradient at unrolled 0
  and 1, the port's ``Trainer.step_loss`` against the JAX ``_one_step``
  (SaveMSMP-PDE's state threaded through the pushforward): 1e-8 (float32:
  the loss 1e-5 relative, each gradient 1e-3 of its largest entry, as
  ``chip_smoke.grad_scales`` takes it: two summation orders through 25
  recurrent steps and back).
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
from msmp_pde_tpu.training.loop import Trainer as JTrainer
from msmp_pde_torch.data.graph import GraphSpec
from msmp_pde_torch.models.registry import get_model
from msmp_pde_torch.training.loop import Trainer
from msmp_pde_torch.utils.convert import params_from_flax

from chip_smoke import grad_scales

from _torch_helpers import np_tree, one_thread, tt  # noqa: F401

NX, B, TW, NT, L, TMAX = 24, 2, 25, 100, 16.0, 4.0
DT = TMAX / (NT - 1)
MODELS = ("MSSMP-PDE", "MSGMP-PDE", "SaveMSMP-PDE", "LSTMGated", "LSTM")
HIDDEN = {"MSGMP-PDE": 164}
F32 = ("LSTMGated", "LSTM")  # see the docstring
pytestmark = pytest.mark.usefixtures("one_thread")


def _grid():
    x = np.linspace(0.0, L, NX)
    idx, mask = build_neighbors_radius(x, 3)
    return x, idx, mask


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """(JAX trainer, its params), float64 (float32 for the LSTM models),
    built once a model."""
    x, idx, mask = _grid()
    dt = np.float32 if name in F32 else np.float64
    x, mask = x.astype(dt), mask.astype(dt)
    t_grid = np.linspace(0.0, TMAX, NT)
    jm, kind = jget_model(name, tw=TW, n_eq_vars=0, L=L, tmax=TMAX, dt=DT,
                          n_layers=1, mp_impl="xla", lem_impl="xla")
    meta = dict(tw=TW, n_components=1, L=L, tmax=TMAX, dt=DT)
    jspec = JSpec(idx=jnp.asarray(idx), mask=jnp.asarray(mask),
                  x=jnp.asarray(x), t_grid=jnp.asarray(t_grid, dt), **meta)
    jtr = JTrainer(model=jm, kind=kind, spec=jspec, eq_norms={})
    f = lambda a: jnp.asarray(a, jnp.float32)
    params = np_tree(jax.jit(jm.init)(
        jax.random.PRNGKey(0), f(np.zeros((B, NX, TW))),
        f(np.broadcast_to(x, (B, NX))), f(np.zeros(B)), f(np.zeros((B, 1))),
        jnp.asarray(idx), f(mask)), dt)
    return jtr, params


def _models(name):
    """(JAX trainer, its params, the port's trainer with the same
    weights)."""
    jtr, params = _jax_side(name)
    x, idx, mask = _grid()
    meta = dict(tw=TW, n_components=1, L=L, tmax=TMAX, dt=DT)
    m, kind = get_model(name, tw=TW, n_eq_vars=0, L=L, tmax=TMAX, dt=DT,
                        n_layers=1)
    assert m.hidden == HIDDEN.get(name, 128) == jtr.model.hidden
    m.load_state_dict(params_from_flax(params), strict=True)
    tdt = torch.float32 if name in F32 else torch.float64
    spec = GraphSpec(idx=torch.as_tensor(idx, dtype=torch.int64),
                     mask=tt(mask, tdt), x=tt(x, tdt),
                     t_grid=tt(np.linspace(0.0, TMAX, NT), tdt), **meta)
    return jtr, params, Trainer(model=m.to(tdt), kind=kind, spec=spec,
                                eq_norms={})


def _inputs(seed, name):
    rng = np.random.default_rng(seed)
    dt = np.float32 if name in F32 else np.float64
    return (rng.normal(size=(B, NX, TW)).astype(dt),
            rng.integers(TW, NT - TW, size=B))


def _tt(a):
    return tt(a, torch.float32 if a.dtype == np.float32 else torch.float64)


def _tol(name):
    return 1e-5 if name in F32 else 1e-10


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name):
    jtr, params, trainer = _models(name)
    window, steps = _inputs(1, name)
    want, state = jax.jit(jtr.forward)(params, jnp.asarray(window),
                                       jnp.asarray(steps), {})
    with torch.no_grad():
        got, got_state = trainer.forward(_tt(window), torch.as_tensor(steps),
                                         {})
    assert got.shape == (B, NX, TW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_tol(name), atol=_tol(name))
    assert (state is None) == (got_state is None) == (name != "SaveMSMP-PDE")


@pytest.mark.parametrize("nonzero", [False, True])
def test_save_state_matches_jax(nonzero):
    """SaveMSMP-PDE returns the LEM's final (y, z) as [B, nx, H] and starts
    from a given state: the output and the new state."""
    jtr, params, trainer = _models("SaveMSMP-PDE")
    window, steps = _inputs(2, "SaveMSMP-PDE")
    H = trainer.model.hidden
    rng = np.random.default_rng(3)
    state = (tuple(rng.normal(size=(B, NX, H)) * 0.5 for _ in "yz")
             if nonzero else None)
    want, wstate = jax.jit(jtr.forward)(
        params, jnp.asarray(window), jnp.asarray(steps), {},
        lem_state=None if state is None else tuple(map(jnp.asarray, state)))
    with torch.no_grad():
        got, gstate = trainer.forward(
            tt(window), torch.as_tensor(steps), {},
            lem_state=None if state is None else tuple(map(tt, state)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10)
    assert len(gstate) == 2
    for a, b in zip(gstate, wstate):
        assert a.shape == (B, NX, H)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)
    if nonzero:  # the state reaches the output
        with torch.no_grad():
            zero, _ = trainer.forward(tt(window), torch.as_tensor(steps), {})
        assert not torch.allclose(got, zero)


def _leaf(tree, name):
    node = tree["params"]
    for part in name.split("."):
        node = node[part]
    return np.asarray(node)


@pytest.mark.parametrize("unrolled", [0, 1])
@pytest.mark.parametrize("name", MODELS)
def test_step_matches_jax(name, unrolled):
    """The loss of one batch after ``unrolled`` pushforward windows and its
    gradients: the JAX ``_one_step`` with plain SGD at rate R = 2^20 moves
    each parameter by R times its gradient, grad = (p - p') / R (a rate so
    large that p's own rounding, eps |p| / R, does not show)."""
    jtr, params, trainer = _models(name)
    rng = np.random.default_rng(10 + unrolled)
    u = rng.normal(size=(4, NT, NX)).astype(
        np.float32 if name in F32 else np.float64)
    ib = rng.permutation(4)[:B]
    st = rng.integers(TW, NT - TW * (unrolled + 1) + 1, size=B)
    R = 2.0 ** 20
    tx = optax.sgd(R)
    new, _, jloss = jax.jit(jtr._one_step(tx, unrolled))(
        params, tx.init(params), jnp.asarray(u), {}, jnp.asarray(ib),
        jnp.asarray(st))
    loss = trainer.step_loss(_tt(u), {}, torch.as_tensor(ib),
                             torch.as_tensor(st), unrolled)
    f32 = name in F32
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=1e-5 if f32 else 1e-8)
    named = list(trainer.model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    new = jax.device_get(new)
    want = {n: (_leaf(params, n) - _leaf(new, n)) / R for n, _ in named}
    scales = grad_scales((n, torch.as_tensor(w)) for n, w in want.items())
    for (pname, _), g in zip(named, grads):
        atol = 1e-3 * scales[pname] if f32 else 1e-8
        np.testing.assert_allclose(g.numpy(), want[pname],
                                   rtol=0 if f32 else 1e-8, atol=atol,
                                   err_msg=pname)


@pytest.mark.parametrize("metric", ["unrolled", "l2", "store"])
def test_stateful_metrics_match_jax(metric):
    """SaveMSMP-PDE's metrics thread the LEM state through the rollout;
    ``rollout_store``'s windows past the data horizon run without it
    (msmp_pde_tpu/training/metrics.py:224-232). 1e-9 on every value."""
    from msmp_pde_tpu.training import metrics as jmetrics
    from msmp_pde_torch.training import metrics

    jtr, params, trainer = _models("SaveMSMP-PDE")
    rng = np.random.default_rng(4)
    u = rng.normal(size=(3, NT, NX)) * 0.5
    quiet = dict(log=lambda *a: None)
    ju = jnp.asarray(u)
    if metric == "unrolled":
        ub = u + 0.1 * rng.normal(size=u.shape)
        got = metrics.test_unrolled_losses(trainer, tt(u), tt(ub), {}, 3, 1,
                                           NT, NX, **quiet)
        want = jmetrics.test_unrolled_losses(jtr, params, ju,
                                             jnp.asarray(ub), {}, 3, 1, NT,
                                             NX, **quiet)
    elif metric == "l2":
        got = metrics.compute_l2_norms(trainer, tt(u), {}, 3, 1, NT, **quiet)
        want = jmetrics.compute_l2_norms(jtr, params, ju, {}, 3, 1, NT,
                                         **quiet)
    else:
        got = metrics.rollout_store(trainer, tt(u), {}, 3, 1, NT,
                                    n_more_rollout=2)
        want = jmetrics.rollout_store(jtr, params, ju, {}, 3, 1, NT,
                                      n_more_rollout=2)
        assert got[0].shape == (3, 5 * TW, 1, NX)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("name", MODELS)
def test_reference_apply_equals_forward(name):
    """``chip_smoke.reference_apply`` (the on-card reference of the kernel
    path, written out through the plain versions) computes what the
    model's forward computes, SaveMSMP-PDE also from a non-zero state and
    with its new state; on CPU tensors both run the plain versions. The
    port alone, float64, 1e-12."""
    from chip_smoke import reference_apply

    x, idx, mask = _grid()
    m, _ = get_model(name, tw=TW, n_eq_vars=0, L=L, tmax=TMAX, dt=DT,
                     n_layers=1, seed=3)
    m = m.to(torch.float64)
    rng = np.random.default_rng(5)
    H = m.hidden
    state = (tuple(tt(rng.normal(size=(B, NX, H))) for _ in "yz")
             if m.save_state else None)
    args = (tt(rng.normal(size=(B, NX, TW))), tt(np.tile(x, (B, 1))),
            tt(rng.uniform(0, TMAX, B)), tt(rng.normal(size=(B, 1))),
            torch.as_tensor(idx), tt(mask))
    with torch.no_grad():
        a, sa = m(*args, lem_state=state)
        b, sb = reference_apply(m, args[0], args[1], args[3], args[4],
                                args[5], state)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert (sa is None) == (sb is None) == (not m.save_state)
    for u, v in zip(sa or (), sb or ()):
        torch.testing.assert_close(u, v, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,lem,pair,layer", [
    ("MSSMP-PDE", 2, 12, 0), ("MSGMP-PDE", 1, 6, 0),
    ("SaveMSMP-PDE", 1, 6, 0), ("LSTMGated", 0, 6, 0), ("LSTM", 0, 0, 6)])
def test_expected_launches_of_one_forward(name, lem, pair, layer):
    """``chip_smoke.expected_launches``, which holds the card's runs to
    their kernels: per forward at six layers, the twin towers run two LEM
    scans and twelve pairs, the LSTM models no LEM scan; a step with grad
    adds the stash forward and a backward of each."""
    from chip_smoke import expected_launches

    m, _ = get_model(name, tw=TW, n_eq_vars=0, L=L, tmax=TMAX, dt=DT)
    got = expected_launches(m, 1)
    assert (got["lem_fwd"], got["mp_pair_fwd"], got["mp_layer_fwd"]) == (
        lem, pair, layer)
    step = expected_launches(m, 2, 1)
    assert (step["lem_fwd_stash"], step["lem_bwd"], step["mp_pair_bwd"],
            step["mp_layer_bwd"]) == (lem, lem, pair, layer)
