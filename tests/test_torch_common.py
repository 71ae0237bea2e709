"""PyTorch port, models/common.py: each block against its JAX counterpart
on the same numpy inputs and weights, in float64 (tolerance 1e-10: only
summation order differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.models import common as jc
from msmp_pde_torch.models import common as tc
from msmp_pde_torch.utils.convert import params_from_flax

from _torch_helpers import np_tree, tt

TOL = dict(rtol=1e-10, atol=1e-10)


def _load(module, jax_params):
    module.load_state_dict(params_from_flax(np_tree(jax_params)))
    return module.double()


def test_dense():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 11))
    jm = jc.TorchDense(5)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(np_tree(p), jnp.asarray(x))
    got = _load(tc.Dense(11, 5, torch.Generator()), p)(tt(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_swish():
    x = np.random.default_rng(1).normal(size=(4, 9)) * 4
    np.testing.assert_allclose(tc.swish(tt(x)).numpy(),
                               jc.swish(jnp.asarray(x)), **TOL)


@pytest.mark.parametrize("c_in,features,k,stride", [(1, 8, 16, 3),
                                                     (8, 1, 14, 1)])
def test_conv1d(c_in, features, k, stride):
    x = np.random.default_rng(2).normal(size=(2, 5, c_in, 128))
    jm = jc.TorchConv1d(features=features, kernel_size=k, stride=stride)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x, jnp.float32))
    want = jm.apply(np_tree(p), jnp.asarray(x))
    got = _load(tc.Conv1d(c_in, features, k, stride, torch.Generator()),
                p)(tt(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_instance_norm():
    h = np.random.default_rng(3).normal(size=(3, 40, 16)) * 2 + 1
    np.testing.assert_allclose(tc.instance_norm(tt(h)).numpy(),
                               jc.instance_norm(jnp.asarray(h)), **TOL)


@pytest.mark.parametrize("tw,hidden", [(25, 128), (25, 96), (20, 128),
                                       (50, 128)])
def test_window_decoder(tw, hidden):
    x = np.random.default_rng(4).normal(size=(2, 6, 1, hidden))
    jm = jc.WindowDecoder(tw=tw)
    p = jm.init(jax.random.PRNGKey(2), jnp.asarray(x, jnp.float32))
    want = jm.apply(np_tree(p), jnp.asarray(x))
    got = _load(tc.WindowDecoder(tw, hidden, torch.Generator()), p)(tt(x))
    assert got.shape == (2, 6, 1, tw)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_window_decoder_too_narrow():
    with pytest.raises(ValueError, match="too small"):
        tc.WindowDecoder(25, 80, torch.Generator())


@pytest.mark.parametrize("norms", [
    {},
    {"beta": 0.2},
    {"alpha": 3.0, "beta": 0.4, "gamma": 1.0},
    {"bc_left": 1, "bc_right": 1},
])
def test_assemble_variables(norms):
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 4, size=(6,))
    eq = {k: rng.normal(size=(6,)) for k in norms}
    want = jc.assemble_variables(jnp.asarray(t),
                                 {k: jnp.asarray(v) for k, v in eq.items()},
                                 norms, 4.0)
    got = tc.assemble_variables(tt(t), {k: tt(v) for k, v in eq.items()},
                                norms, 4.0)
    assert got.shape == (6, 1 + len(norms))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
