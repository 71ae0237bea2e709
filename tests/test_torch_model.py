"""PyTorch port, the whole MSMP-PDE forward (models/gnn.py::MPSolver)
against the JAX MPSolver on the same converted weights: hidden 96 (tw=25
needs H >= 88), 2 gated pairs, nx=40, B=2.

* ``mp_impl="xla"``, ``lem_impl="xla"`` in float64: 1e-10;
* ``mp_impl="pallas_pair"``, ``lem_impl="pallas"`` run interpreted: both
  kernels compute in float32, so the port runs in float32; 1e-4 after the
  LEM, two pairs, InstanceNorms and the decoder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.data.graph import build_neighbors_radius
from msmp_pde_tpu.models.gnn import MPSolver as JSolver
from msmp_pde_torch.models.registry import get_model
from msmp_pde_torch.utils.convert import params_from_flax

from _torch_helpers import np_tree, tt

NX, B, TW, H, LAYERS = 40, 2, 25, 96, 2
L, TMAX, DT = 16.0, 4.0, 4.0 / 249


def _case(V, seed):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, L, NX)
    idx, mask = build_neighbors_radius(x, 3)
    window = rng.normal(size=(B, NX, TW))
    pos_x = np.broadcast_to(x, (B, NX)).copy()
    t = rng.uniform(0, TMAX, size=(B,))
    var_vec = np.concatenate([t[:, None] / TMAX,
                              rng.normal(size=(B, V - 1))], axis=1)
    return window, pos_x, t, var_vec, idx, mask


def _jax(mp_impl, lem_impl):
    return JSolver(tw=TW, hidden=H, layers=LAYERS, encoder="lem",
                   gate="sigmoid", L=L, tmax=TMAX, dt=DT, mp_impl=mp_impl,
                   lem_impl=lem_impl)


def _port(params, V, dtype):
    m, kind = get_model("MSMP-PDE", tw=TW, n_eq_vars=V - 1, L=L, tmax=TMAX,
                        dt=DT, n_layers=LAYERS, hidden=H)
    assert kind == "graph"
    m.load_state_dict(params_from_flax(params), strict=True)
    return m.to(dtype)


def _init(inputs):
    f = lambda a: jnp.asarray(a, jnp.float32)
    window, pos_x, t, var_vec, idx, mask = inputs
    return _jax("xla", "xla").init(jax.random.PRNGKey(0), f(window),
                                   f(pos_x), f(t), f(var_vec),
                                   jnp.asarray(idx), f(mask))


@pytest.mark.parametrize("V", [1, 3])
def test_forward_matches_xla_f64(V):
    inputs = _case(V, V)
    p = np_tree(_init(inputs))
    window, pos_x, t, var_vec, idx, mask = inputs
    J = lambda a: jnp.asarray(a, jnp.float64)
    want, state = _jax("xla", "xla").apply(
        p, J(window), J(pos_x), J(t), J(var_vec), jnp.asarray(idx), J(mask))
    assert state is None
    m = _port(p, V, torch.float64)
    with torch.no_grad():
        got, _ = m(tt(window), tt(pos_x), tt(t), tt(var_vec),
                   torch.as_tensor(idx), tt(mask))
    assert got.shape == (B, NX, TW)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("V", [1, 3])
def test_forward_matches_pallas_interpret_f32(V):
    inputs = _case(V, 10 + V)
    p = np_tree(_init(inputs), np.float32)
    window, pos_x, t, var_vec, idx, mask = inputs
    F = lambda a: jnp.asarray(a, jnp.float32)
    want, _ = _jax("pallas_pair", "pallas").apply(
        p, F(window), F(pos_x), F(t), F(var_vec), jnp.asarray(idx), F(mask))
    m = _port(p, V, torch.float32)
    T = lambda a: tt(a, torch.float32)
    with torch.no_grad():
        got, _ = m(T(window), T(pos_x), T(t), T(var_vec),
                   torch.as_tensor(idx), T(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("V", [1, 3])
def test_plain_impl_equals_default_on_cpu(V):
    """``chip_smoke.reference_forward`` (the on-card reference of the kernel
    path, written out through the plain versions) computes what the model's
    forward computes; on CPU tensors both run the plain versions. f64,
    1e-12."""
    from chip_smoke import reference_forward

    inputs = _case(V, 20 + V)
    m = _port(np_tree(_init(inputs)), V, torch.float64)
    window, pos_x, t, var_vec, idx, mask = inputs
    args = (tt(window), tt(pos_x), tt(t), tt(var_vec), torch.as_tensor(idx),
            tt(mask))
    with torch.no_grad():
        a, _ = m(*args)
        b = reference_forward(m, args[0], args[1], args[3], args[4], args[5])
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["FNO2DPU"])
def test_unported_models_raise(name):
    """The last unported name is ported: FNO2DPU through the trainer on
    RPU's LCG grid (nx 40, float32 as the dataset holds it), the JAX
    trainer's weights carried across by ``params_from_flax``, float64: the
    forward and the gradients of a step's loss (sqrt of the summed squared
    error on the next window) at 1e-10 (of each leaf's largest gradient
    entry)."""
    from msmp_pde_tpu.data.graph import GraphSpec as JSpec
    from msmp_pde_tpu.models.registry import get_model as jget_model
    from msmp_pde_tpu.training.loop import Trainer as JTrainer
    from msmp_pde_torch.data.graph import GraphSpec
    from msmp_pde_torch.datagen.ics import pseudo_random_grid
    from msmp_pde_torch.training.loop import Trainer

    x = pseudo_random_grid(0.0, L, NX).astype(np.float32)
    eq = {"a": 1.0, "b": 1.0}
    nt = 100
    meta = dict(tw=TW, n_components=2, L=L, tmax=TMAX, dt=DT)
    # a grid model reads no neighbour list
    idx, mask = build_neighbors_radius(np.linspace(0.0, L, NX), 3)
    jm, _ = jget_model(name, tw=TW, n_eq_vars=2, L=L, tmax=TMAX, dt=DT,
                       eq_var_names=tuple(eq))
    jtr = JTrainer(model=jm, kind="grid", spec=JSpec(
        idx=jnp.asarray(idx), mask=jnp.asarray(mask), x=jnp.asarray(x),
        t_grid=jnp.asarray(np.linspace(0.0, TMAX, nt)), **meta),
        eq_norms=eq)
    params = np_tree(jtr.init_params(jax.random.PRNGKey(4), B))
    m, kind = get_model(name, tw=TW, n_eq_vars=2, L=L, tmax=TMAX, dt=DT,
                        eq_var_names=tuple(eq))
    m.load_state_dict(params_from_flax(params), strict=True)
    spec = GraphSpec(idx=torch.as_tensor(idx), mask=tt(mask),
                     x=torch.as_tensor(x),
                     t_grid=tt(np.linspace(0.0, TMAX, nt)), **meta)
    tr = Trainer(model=m.double(), kind=kind, spec=spec, eq_norms=eq)
    rng = np.random.default_rng(6)
    window = rng.normal(size=(B, NX, 2 * TW))
    labels = rng.normal(size=(B, NX, 2 * TW))
    steps = rng.integers(TW, nt - TW, size=B)
    var = {"a": rng.uniform(0.1, 1.0, B), "b": rng.uniform(1.0, 10.0, B)}
    jvar = {k: jnp.asarray(v) for k, v in var.items()}

    def jloss(p):
        pred, _ = jtr.forward(p, jnp.asarray(window), jnp.asarray(steps),
                              jvar)
        return jnp.sqrt(jnp.sum((pred - labels) ** 2)), pred

    (want_loss, want), grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    pred, state = tr.forward(tt(window), torch.as_tensor(steps),
                             {k: tt(v) for k, v in var.items()})
    assert state is None and pred.shape == (B, NX, 2 * TW)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                               rtol=1e-10, atol=1e-10)
    loss = torch.sqrt(torch.sum((pred - tt(labels)) ** 2))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-12)
    named = list(tr.model.named_parameters())
    got = torch.autograd.grad(loss, [p for _, p in named])
    flat = dict(jax.tree_util.tree_flatten_with_path(
        jax.device_get(grads)["params"])[0])
    flat = {".".join(k.key for k in path): v for path, v in flat.items()}
    assert set(flat) == {n for n, _ in named}
    for (pname, _), g in zip(named, got):
        w = np.asarray(flat[pname])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-10 * np.abs(w).max(),
                                   err_msg=pname)
