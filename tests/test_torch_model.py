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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(name, tw=TW, n_eq_vars=0, L=L, tmax=TMAX, dt=DT)
