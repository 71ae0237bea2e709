"""PyTorch port, the ten 2-D graph models on the two-component advection
system (models/gnn.py::MPSolver with n_components = 2: the 2-D step inputs
of the recurrent encoders, the ``double_mlp`` decoder, the gradient gate
and the attention layers; training/loop.py's b-reads-a substitution)
against the JAX MPSolver built by the JAX registry on the same converted
weights: tw 25 (windows of d tw = 50), the equation variables a and b (V =
3), nx 24, B 2, one layer or pair, JAX ``mp_impl="xla"``,
``lem_impl="xla"``, float64 except the LSTM models (the JAX LSTM's carry
is float32; ``test_torch_model_variants.py`` says why).

* each model's forward: 1e-10 (float32: 1e-5);
* one training step's loss and every parameter's gradient at unrolled 0
  and 1, the port's ``Trainer.step_loss`` against the JAX ``_one_step``:
  1e-8 (float32: the loss 1e-5 relative, each gradient 1e-3 of its
  largest entry), as ``test_torch_model_variants.py`` checks the 1-D ones;
* ``grad_gate`` and ``GATLayer`` alone, with an isolated node: 1e-12;
* the model variables with b reading a: exact;
* the metrics at d = 2 (unrolled losses, L2 norms): 1e-9;
* the serving engine on RP's grid (float32, both engines on the CPU):
  1e-4, and the manual chain of ``tests/test_serving.py:150``.
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
from msmp_pde_tpu.training.loop import make_var_fns as jmake_var_fns
from msmp_pde_torch.data.graph import GraphSpec, advance_windows
from msmp_pde_torch.models.gnn import GATLayer, grad_gate
from msmp_pde_torch.models.registry import get_model
from msmp_pde_torch.training.loop import Trainer, make_var_fns
from msmp_pde_torch.utils.convert import params_from_flax

from chip_smoke import MODELS_2D, grad_scales

from _torch_helpers import np_tree, one_thread, tt  # noqa: F401

NX, B, TW, NT, L, TMAX = 24, 2, 25, 100, 16.0, 4.0
DT = TMAX / (NT - 1)
EQ = {"a": 1.0, "b": 1.0}
MODELS = MODELS_2D
HIDDEN = {"MSGMP-PDE2D": 164}
F32 = ("LSTMGated2D", "LSTM2D")
pytestmark = pytest.mark.usefixtures("one_thread")


def _grid():
    x = np.linspace(0.0, L, NX)
    idx, mask = build_neighbors_radius(x, 3)
    return x, idx, mask


def _dt(name):
    return np.float32 if name in F32 else np.float64


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """(JAX trainer, its params) of ``name``, built once a model."""
    x, idx, mask = _grid()
    dt = _dt(name)
    x, mask = x.astype(dt), mask.astype(dt)
    jm, kind = jget_model(name, tw=TW, n_eq_vars=2, L=L, tmax=TMAX, dt=DT,
                          n_layers=1, eq_var_names=tuple(EQ), mp_impl="xla",
                          lem_impl="xla")
    meta = dict(tw=TW, n_components=2, L=L, tmax=TMAX, dt=DT)
    jspec = JSpec(idx=jnp.asarray(idx), mask=jnp.asarray(mask),
                  x=jnp.asarray(x), t_grid=jnp.asarray(
                      np.linspace(0.0, TMAX, NT), dt), **meta)
    jtr = JTrainer(model=jm, kind=kind, spec=jspec, eq_norms=EQ)
    f = lambda a: jnp.asarray(a, jnp.float32)
    params = np_tree(jax.jit(jm.init)(
        jax.random.PRNGKey(0), f(np.zeros((B, NX, 2 * TW))),
        f(np.broadcast_to(x, (B, NX))), f(np.zeros(B)), f(np.zeros((B, 3))),
        jnp.asarray(idx), f(mask)), dt)
    return jtr, params


def _port_trainer(name, seed=0):
    x, idx, mask = _grid()
    tdt = torch.float32 if name in F32 else torch.float64
    m, kind = get_model(name, tw=TW, n_eq_vars=2, L=L, tmax=TMAX, dt=DT,
                        n_layers=1, seed=seed)
    spec = GraphSpec(idx=torch.as_tensor(idx, dtype=torch.int64),
                     mask=tt(mask, tdt), x=tt(x, tdt),
                     t_grid=tt(np.linspace(0.0, TMAX, NT), tdt), tw=TW,
                     n_components=2, L=L, tmax=TMAX, dt=DT)
    return Trainer(model=m.to(tdt), kind=kind, spec=spec, eq_norms=EQ)


def _models(name):
    """(JAX trainer, its params, the port's trainer with the same
    weights)."""
    jtr, params = _jax_side(name)
    trainer = _port_trainer(name)
    assert trainer.model.hidden == HIDDEN.get(name, 128) == jtr.model.hidden
    trainer.model.load_state_dict(params_from_flax(params), strict=True)
    return jtr, params, trainer


def _variables(rng, n, dt):
    return {"a": rng.uniform(0.1, 1.0, n).astype(dt),
            "b": rng.uniform(1.0, 10.0, n).astype(dt)}


def _tt(a):
    return tt(a, torch.float32 if a.dtype == np.float32 else torch.float64)


def _tol(name):
    return 1e-5 if name in F32 else 1e-10


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name):
    jtr, params, trainer = _models(name)
    rng = np.random.default_rng(1)
    dt = _dt(name)
    window = rng.normal(size=(B, NX, 2 * TW)).astype(dt)
    steps = rng.integers(TW, NT - TW, size=B)
    var = _variables(rng, B, dt)
    want, state = jax.jit(jtr.forward)(
        params, jnp.asarray(window), jnp.asarray(steps),
        {k: jnp.asarray(v) for k, v in var.items()})
    with torch.no_grad():
        got, got_state = trainer.forward(
            _tt(window), torch.as_tensor(steps),
            {k: _tt(v) for k, v in var.items()})
    assert got.shape == (B, NX, 2 * TW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_tol(name), atol=_tol(name))
    assert (state is None) == (got_state is None) == (
        name != "SaveMSMP-PDE2D")
    for a, b in zip(got_state or (), state or ()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)


def test_save_state_2d_from_a_state_matches_jax():
    """SaveMSMP-PDE2D from a non-zero state: the output and the new
    state."""
    jtr, params, trainer = _models("SaveMSMP-PDE2D")
    rng = np.random.default_rng(2)
    window = rng.normal(size=(B, NX, 2 * TW))
    steps = rng.integers(TW, NT - TW, size=B)
    var = _variables(rng, B, np.float64)
    state = tuple(rng.normal(size=(B, NX, 128)) * 0.5 for _ in "yz")
    want, wstate = jax.jit(jtr.forward)(
        params, jnp.asarray(window), jnp.asarray(steps),
        {k: jnp.asarray(v) for k, v in var.items()},
        lem_state=tuple(map(jnp.asarray, state)))
    with torch.no_grad():
        got, gstate = trainer.forward(
            tt(window), torch.as_tensor(steps),
            {k: tt(v) for k, v in var.items()},
            lem_state=tuple(map(tt, state)))
    for a, b in zip((got, *gstate), (want, *wstate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)


def _leaf(tree, name):
    node = tree["params"]
    for part in name.split("."):
        node = node[part]
    return np.asarray(node)


@pytest.mark.parametrize("unrolled", [0, 1])
@pytest.mark.parametrize("name", MODELS)
def test_step_matches_jax(name, unrolled):
    """The loss after ``unrolled`` pushforward windows and its gradients:
    the JAX ``_one_step`` with SGD at rate R = 2^20, grad = (p - p') / R
    (``test_torch_model_variants.py``)."""
    jtr, params, trainer = _models(name)
    rng = np.random.default_rng(10 + unrolled)
    dt = _dt(name)
    u = rng.normal(size=(4, NT, 2, NX)).astype(dt)
    var = _variables(rng, 4, dt)
    ib = rng.permutation(4)[:B]
    st = rng.integers(TW, NT - TW * (unrolled + 1) + 1, size=B)
    R = 2.0 ** 20
    tx = optax.sgd(R)
    new, _, jloss = jax.jit(jtr._one_step(tx, unrolled))(
        params, tx.init(params), jnp.asarray(u),
        {k: jnp.asarray(v) for k, v in var.items()}, jnp.asarray(ib),
        jnp.asarray(st))
    loss = trainer.step_loss(_tt(u), {k: _tt(v) for k, v in var.items()},
                             torch.as_tensor(ib), torch.as_tensor(st),
                             unrolled)
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


def _isolated_graph():
    """The radius graph of 12 nodes with node 5's slots all masked."""
    x = np.linspace(0.0, L, 12)
    idx, mask = build_neighbors_radius(x, 2)
    mask[5] = 0.0
    return x, idx, mask


def test_grad_gate_matches_jax():
    from msmp_pde_tpu.models.gnn import grad_gate as jgrad_gate

    _, idx, mask = _isolated_graph()
    g = np.random.default_rng(3).normal(size=(2, 12, 16))
    want = np.asarray(jgrad_gate(jnp.asarray(g), jnp.asarray(idx),
                                 jnp.asarray(mask, jnp.float64)))
    got = grad_gate(tt(g), torch.as_tensor(idx), tt(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert np.all(got[:, 5] == 0.0)  # an isolated node: tanh(0 / 1)


def test_gat_layer_matches_jax():
    """The attention layer on converted weights, its bias non-zero; the
    isolated node's output is the bias alone."""
    from msmp_pde_tpu.models.gnn import GATLayer as JGAT

    x, idx, mask = _isolated_graph()
    rng = np.random.default_rng(4)
    H, D = 16, 10
    h, u = rng.normal(size=(2, 12, H)), rng.normal(size=(2, 12, D))
    px, v = rng.normal(size=(2, 12)), rng.normal(size=(2, 12, 3))
    j = [jnp.asarray(a) for a in (h, u, px, v)]
    jidx, jmask = jnp.asarray(idx), jnp.asarray(mask, jnp.float64)
    layer = JGAT(hidden=H)
    params = np_tree(layer.init(jax.random.PRNGKey(1), *j, jidx, jmask))
    params["params"]["bias"] = rng.normal(size=H)
    want = np.asarray(layer.apply(params, *j, jidx, jmask))
    port = GATLayer(H, D, torch.Generator().manual_seed(0)).double()
    port.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(tt(h), tt(u), tt(px), tt(v), torch.as_tensor(idx),
                   tt(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[:, 5],
                                  np.broadcast_to(params["params"]["bias"],
                                                  (2, H)))


def test_b_reads_a():
    """The 2-D models' variables take a's value in b's slot; the 1-D path
    keeps b."""
    rng = np.random.default_rng(5)
    t = rng.uniform(0, TMAX, 3)
    var = {"a": rng.uniform(0.1, 1.0, 3), "b": rng.uniform(1.0, 10.0, 3)}
    norms = {"a": 1.0, "b": 2.0}
    jvars = jmake_var_fns(norms, TMAX)[0]
    port = make_var_fns(norms, TMAX)
    for flag in (False, True):
        want = np.asarray(jvars(jnp.asarray(t),
                                {k: jnp.asarray(v) for k, v in var.items()},
                                b_reads_a=flag))
        got = port(tt(t), {k: tt(v) for k, v in var.items()},
                   b_reads_a=flag).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, 2],
                                      (var["a"] if flag else var["b"]) / 2.0)
    trainer = _port_trainer("MSMP-PDE2D")
    steps = torch.tensor([25, 50, 75])
    vv = trainer.var_vec(steps, {k: tt(v) for k, v in var.items()})
    np.testing.assert_array_equal(vv[:, 2].numpy(), var["a"])


@pytest.mark.parametrize("metric", ["unrolled", "l2"])
def test_metrics_at_d2_match_jax(metric):
    """``test_unrolled_losses`` and ``compute_l2_norms`` of MSMP-PDE2D on
    [N, nt, 2, nx] trajectories with the variables: 1e-9."""
    from msmp_pde_tpu.training import metrics as jmetrics
    from msmp_pde_torch.training import metrics

    jtr, params, trainer = _models("MSMP-PDE2D")
    rng = np.random.default_rng(6)
    u = rng.normal(size=(3, NT, 2, NX)) * 0.5
    var = _variables(rng, 3, np.float64)
    jvar = {k: jnp.asarray(v) for k, v in var.items()}
    pvar = {k: tt(v) for k, v in var.items()}
    quiet = dict(log=lambda *a: None)
    if metric == "unrolled":
        ub = u + 0.1 * rng.normal(size=u.shape)
        got = metrics.test_unrolled_losses(trainer, tt(u), tt(ub), pvar, 3,
                                           1, NT, NX, **quiet)
        want = jmetrics.test_unrolled_losses(jtr, params, jnp.asarray(u),
                                             jnp.asarray(ub), jvar, 3, 1,
                                             NT, NX, **quiet)
    else:
        got = metrics.compute_l2_norms(trainer, tt(u), pvar, 3, 1, NT,
                                       **quiet)
        want = jmetrics.compute_l2_norms(jtr, params, jnp.asarray(u), jvar,
                                         3, 1, NT, **quiet)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("model", ["MSMP-PDE2D", "MSG2-PDE2D"])
def test_engine_rollout_2d_matches_jax(model):
    """The serving engines on RP's uniform grid (nx 40, two layers or
    pairs, float32 on the CPU): the rollout with a and b from a start step,
    against the JAX engine on the same weights (1e-4) and against the
    manual chain of forwards with the per-component window advance
    (tests/test_serving.py:150)."""
    from msmp_pde_tpu.serving.engine import RolloutEngine as JEngine
    from msmp_pde_tpu.serving.engine import build_serving_trainer as jbuild
    from msmp_pde_torch.serving.engine import (
        RolloutEngine,
        build_serving_trainer,
        windows_to_trajectory,
    )

    res = (250, 40)
    jt = jbuild("RP", model, base_resolution=res, n_graph_layers=2)
    jparams = jt.init_params(jax.random.PRNGKey(2), batch_size=2)
    jeng = JEngine(jt, jparams, batch_buckets=(2,))
    tr = build_serving_trainer("RP", model, base_resolution=res,
                               n_graph_layers=2, device="cpu")
    assert tr.d == 2 and tr.spec.nx == 40
    eng = RolloutEngine(tr, params_from_flax(np_tree(jparams, np.float32)),
                        batch_buckets=(2,))
    rng = np.random.default_rng(9)
    window = rng.normal(size=(2, 40, 50)).astype(np.float32)
    variables = {"a": np.array([0.3, 0.5], np.float32),
                 "b": np.array([9.0, 8.5], np.float32)}
    got = eng.rollout(window, variables=variables, start_step=200,
                      n_windows=3)
    want = jeng.rollout(window, variables=variables, start_step=200,
                        n_windows=3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    w = torch.as_tensor(window)
    var = {k: torch.as_tensor(v) for k, v in variables.items()}
    preds = []
    with torch.no_grad():
        for i in range(3):
            s = torch.clamp(torch.full((2,), 200 + 25 * i), 25, 225)
            pred, _ = tr.forward(w, s, var)
            preds.append(pred.numpy())
            w = advance_windows(w, pred, 2, 25)
    np.testing.assert_array_equal(got, np.stack(preds, axis=1))
    traj = windows_to_trajectory(got, d=2, tw=25)
    assert traj.shape == (2, 75, 2, 40)
    np.testing.assert_array_equal(traj[0, 25 + 3, 1], got[0, 1, :, 25 + 3])


@pytest.mark.parametrize("name", MODELS)
def test_reference_apply_equals_forward(name):
    """``chip_smoke.reference_apply`` (the on-card reference of the kernel
    path) computes each 2-D model's forward, SaveMSMP-PDE2D also from a
    non-zero state; the port alone, float64, 1e-12."""
    from chip_smoke import reference_apply

    x, idx, mask = _grid()
    m = _port_trainer(name, seed=3).model.to(torch.float64)
    rng = np.random.default_rng(7)
    H = m.hidden
    state = (tuple(tt(rng.normal(size=(B, NX, H))) for _ in "yz")
             if m.save_state else None)
    args = (tt(rng.normal(size=(B, NX, 2 * TW))), tt(np.tile(x, (B, 1))),
            tt(rng.uniform(0, TMAX, B)), tt(rng.normal(size=(B, 3))),
            torch.as_tensor(idx), tt(mask))
    with torch.no_grad():
        a, sa = m(*args, lem_state=state)
        b, sb = reference_apply(m, args[0], args[1], args[3], args[4],
                                args[5], state)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert (sa is None) == (sb is None) == (not m.save_state)
    for p, q in zip(sa or (), sb or ()):
        torch.testing.assert_close(p, q, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,lem,pair,layer", [
    ("MP-PDE2D", 0, 0, 6), ("Gated2D", 0, 6, 0), ("MSMP-PDE2D", 1, 6, 0),
    ("MSGMP-PDE2D", 1, 6, 0), ("SaveMSMP-PDE2D", 1, 6, 0),
    ("MSG2-PDE2D", 1, 0, 12), ("LSTMGated2D", 0, 6, 0), ("LEM2D", 1, 0, 6),
    ("GLEMGated2D", 1, 0, 0), ("LSTM2D", 0, 0, 6)])
def test_expected_launches_of_one_forward(name, lem, pair, layer):
    """``chip_smoke.expected_launches`` at six layers: MSG2-PDE2D runs its
    gate and its layer as two single layers (12 ``mp_layer_fwd``), and
    GLEMGated2D's attention layers no message-passing kernel; a step with
    grad adds the stash forward and a backward of each."""
    from chip_smoke import expected_launches

    m, _ = get_model(name, tw=TW, n_eq_vars=2, L=L, tmax=TMAX, dt=DT)
    got = expected_launches(m, 1)
    assert (got["lem_fwd"], got["mp_pair_fwd"], got["mp_layer_fwd"]) == (
        lem, pair, layer)
    step = expected_launches(m, 2, 1)
    assert (step["lem_fwd_stash"], step["lem_bwd"], step["mp_pair_bwd"],
            step["mp_layer_bwd"]) == (lem, lem, pair, layer)


@pytest.mark.parametrize("name", MODELS)
def test_chip_smoke_weights_load(name):
    """``chip_smoke.flax_tree`` draws every leaf of a 2-D model (the
    attention layers' q, k and bias, ``double_mlp``) within U(-1/sqrt(fan),
    1/sqrt(fan)), and ``params_from_flax`` loads them strictly."""
    from chip_smoke import flax_tree

    m = _port_trainer(name).model
    state = params_from_flax(flax_tree(m, seed=1))
    m.load_state_dict(state, strict=True)
    assert state.keys() == m.state_dict().keys()
    for k, v in state.items():
        assert v.dtype == torch.float32 and 0 < v.abs().max() <= 1.0, k
    if name == "GLEMGated2D":
        H = m.hidden
        for k in ("gnn_0.att_q", "gate_0.att_k", "gnn_0.bias"):
            assert state[k].abs().max() <= H ** -0.5
