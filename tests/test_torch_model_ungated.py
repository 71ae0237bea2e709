"""PyTorch port, the ungated graph models and the MLP encoder
(models/gnn.py::MPSolver as ``MP-PDE``, ``LEM`` and ``Gated``) against the
JAX MPSolver on the same converted weights: hidden 96 (tw=25 needs
H >= 88), 2 layers, nx=40, B=2, as tests/test_torch_model.py does for
MSMP-PDE.

* ``mp_impl="xla"``, ``lem_impl="xla"`` in float64: 1e-10;
* the kernels run interpreted (``mp_impl="pallas"`` for the ungated
  models, which reaches ``_fwd_kernel``; ``"pallas_pair"`` for Gated;
  ``lem_impl="pallas"``): they compute in float32, so the port runs in
  float32; 1e-4 after the encoder, two layers, their InstanceNorms and the
  decoder;
* ``chip_smoke.reference_forward`` (the on-card reference, written out
  through the plain versions) equals the model's forward on CPU tensors:
  float64, 1e-12;
* one optimizer step of MP-PDE at unrolled 0 and 1 against the JAX
  ``Trainer.train_step_fn`` (XLA path) from the same parameters and batch,
  float64: the loss, every gradient and every updated parameter at 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.models.gnn import MPSolver as JSolver
from msmp_pde_torch.models.registry import get_model
from msmp_pde_torch.ops import mp_layer
from msmp_pde_torch.utils.convert import params_from_flax

from _torch_helpers import np_tree, tt
from test_torch_model import B, DT, H, L, LAYERS, NX, TMAX, TW, _case
from test_torch_train import (
    ENCODER_GATE,
    TOL,
    _assert_params,
    _leaf,
    _trainers,
)

MODELS = ["MP-PDE", "LEM", "Gated"]
V = 2


def _jax(name, mp_impl, lem_impl):
    encoder, gate = ENCODER_GATE[name]
    return JSolver(tw=TW, hidden=H, layers=LAYERS, encoder=encoder,
                   gate=gate, L=L, tmax=TMAX, dt=DT, mp_impl=mp_impl,
                   lem_impl=lem_impl)


def _models(name, seed, dtype):
    """(inputs, JAX params as numpy in ``dtype``, the port's model with
    the same weights)."""
    inputs = _case(V, seed)
    window, pos_x, t, var_vec, idx, mask = inputs
    f = lambda a: jnp.asarray(a, jnp.float32)
    p = _jax(name, "xla", "xla").init(
        jax.random.PRNGKey(seed), f(window), f(pos_x), f(t), f(var_vec),
        jnp.asarray(idx), f(mask))
    p = np_tree(p, np.float64 if dtype == torch.float64 else np.float32)
    m, kind = get_model(name, tw=TW, n_eq_vars=V - 1, L=L, tmax=TMAX,
                        dt=DT, n_layers=LAYERS, hidden=H)
    assert kind == "graph"
    m.load_state_dict(params_from_flax(p), strict=True)
    return inputs, p, m.to(dtype)


def _port(m, inputs, dtype):
    T = lambda a: tt(a, dtype)
    window, pos_x, t, var_vec, idx, mask = inputs
    before = mp_layer.launches
    with torch.no_grad():
        got, state = m(T(window), T(pos_x), T(t), T(var_vec),
                       torch.as_tensor(idx), T(mask))
    assert state is None and got.shape == (B, NX, TW)
    assert mp_layer.launches == before  # CPU tensors take the plain version
    return got.numpy()


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_xla_f64(name):
    inputs, p, m = _models(name, 1, torch.float64)
    window, pos_x, t, var_vec, idx, mask = inputs
    J = lambda a: jnp.asarray(a, jnp.float64)
    want, _ = _jax(name, "xla", "xla").apply(
        p, J(window), J(pos_x), J(t), J(var_vec), jnp.asarray(idx), J(mask))
    np.testing.assert_allclose(_port(m, inputs, torch.float64), want,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_pallas_interpret_f32(name):
    inputs, p, m = _models(name, 2, torch.float32)
    window, pos_x, t, var_vec, idx, mask = inputs
    F = lambda a: jnp.asarray(a, jnp.float32)
    mp_impl = "pallas_pair" if name == "Gated" else "pallas"
    want, _ = _jax(name, mp_impl, "pallas").apply(
        p, F(window), F(pos_x), F(t), F(var_vec), jnp.asarray(idx), F(mask))
    np.testing.assert_allclose(_port(m, inputs, torch.float32), want,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_plain_impl_equals_default_on_cpu(name):
    from chip_smoke import reference_forward

    inputs, _, m = _models(name, 3, torch.float64)
    window, pos_x, t, var_vec, idx, mask = inputs
    args = (tt(window), tt(pos_x), tt(t), tt(var_vec), torch.as_tensor(idx),
            tt(mask))
    with torch.no_grad():
        a, _ = m(*args)
        b = reference_forward(m, args[0], args[1], args[3], args[4], args[5])
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("unrolled", [0, 1])
def test_mp_pde_step_matches_jax_train_step(unrolled):
    tw, nt = 25, 100
    jtr, params, trainer = _trainers(tw, nt, "MP-PDE")
    rng = np.random.default_rng(30 + unrolled)
    u = rng.normal(size=(4, nt, trainer.spec.nx))
    ib = rng.permutation(4)[:2]
    st = rng.integers(tw, nt - tw * (unrolled + 1) + 1, size=2)
    tx = jtr.make_optimizer(1e-3, 0.4, [1, 2], 1)
    opt_state = tx.init(params)
    params, opt_state, jloss = jtr.train_step_fn(tx, unrolled)(
        params, opt_state, jnp.asarray(u), {}, jnp.asarray(ib),
        jnp.asarray(st))
    step = trainer.train_step_fn(
        trainer.make_optimizer(1e-3, 0.4, [1, 2], 1), unrolled)
    loss = step(tt(u), {}, torch.as_tensor(ib), torch.as_tensor(st))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for name, p in trainer.model.named_parameters():  # mu = (1 - b1) grad
        np.testing.assert_allclose(p.grad.numpy(),
                                   _leaf(opt_state[0].mu, name) / 0.1,
                                   err_msg=name, **TOL)
    _assert_params(trainer, params)
