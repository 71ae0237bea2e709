"""PyTorch port, LEM encoder and its scan (models/lem.py, ops/lem_scan.py)
against the JAX LEM on the same numpy inputs and weights.

* against ``LEM(impl="xla")`` in float64: 1e-10, only summation order
  differs;
* against ``LEM(impl="pallas")`` run interpreted: the Pallas scan fixes
  float32 outputs (lem_pallas.py:194), so the port runs in float32 too and
  the bound is 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.models.lem import LEM as JLEM
from msmp_pde_tpu.ops.lem_pallas import lem_scan as jlem_scan
from msmp_pde_torch.models.lem import LEM
from msmp_pde_torch.ops import lem_scan as ops

from _torch_helpers import np_tree, tt


def _case(T, N, I, H, seed, with_state):
    rng = np.random.default_rng(seed)
    seq = rng.normal(size=(T, N, I))
    state = None
    if with_state:
        state = (rng.normal(size=(N, H)) * 0.5, rng.normal(size=(N, H)) * 0.5)
    jm = JLEM(hidden=H, impl="xla")
    p = jm.init(jax.random.PRNGKey(seed), jnp.asarray(seq, jnp.float32))
    return seq, state, p


def _port(p, I, H, dtype):
    m = LEM(I, H, torch.Generator())
    m.load_state_dict({k: torch.as_tensor(v) for k, v in
                       np_tree(p["params"]).items()})
    return m.to(dtype)


@pytest.mark.parametrize("N", [7, 100, 130])
@pytest.mark.parametrize("with_state", [False, True])
def test_lem_matches_xla_f64(N, with_state):
    T, I, H = 25, 3, 32
    seq, state, p = _case(T, N, I, H, N, with_state)
    y_j, (yj, zj) = JLEM(hidden=H, impl="xla").apply(
        np_tree(p), jnp.asarray(seq),
        None if state is None else tuple(map(jnp.asarray, state)))
    m = _port(p, I, H, torch.float64)
    y_t, (yt, zt) = m(tt(seq), None if state is None else
                      tuple(map(tt, state)))
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(zt.detach().numpy(), zj, rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("N", [50, 37])
@pytest.mark.parametrize("with_state", [False, True])
def test_lem_matches_pallas_f32(N, with_state):
    T, I, H = 25, 3, 32
    seq, state, p = _case(T, N, I, H, 10 + N, with_state)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    y_j, (yj, zj) = JLEM(hidden=H, impl="pallas").apply(
        np_tree(p, np.float32), f32(seq),
        None if state is None else tuple(map(f32, state)))
    m = _port(p, I, H, torch.float32)
    with torch.no_grad():
        y_t, (yt, zt) = m(tt(seq, torch.float32), None if state is None else
                          tuple(tt(s, torch.float32) for s in state))
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", [1.0, 0.3])
def test_scan_matches_pallas_scan(dt):
    """The scan alone, including a dt other than the module default."""
    rng = np.random.default_rng(7)
    T, N, H = 25, 45, 32
    a = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    args = (a(T, N, 3 * H), a(T, N, H), a(N, H, sc=.5), a(N, H, sc=.5),
            a(H, 3 * H, sc=H ** -.5), a(H, H, sc=H ** -.5))
    yj, zj = jlem_scan(*map(jnp.asarray, args), dt=dt, interpret=True)
    before = ops.launches
    yt, zt = ops.lem_scan(*(torch.as_tensor(x) for x in args), dt=dt)
    assert ops.launches == before  # CPU tensors take the plain loop
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_cpu_tensors():
    """The kernel entry point never falls back to the plain loop."""
    x = torch.zeros(2, 3, 96)
    with pytest.raises(ValueError, match="CUDA"):
        ops.lem_scan_kernel(x, torch.zeros(2, 3, 32), torch.zeros(3, 32),
                            torch.zeros(3, 32), torch.zeros(32, 96),
                            torch.zeros(32, 32))

