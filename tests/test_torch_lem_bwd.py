"""PyTorch port, the LEM scan's backward (ops/lem_scan.py:
``lem_scan_bwd_plain``, the stash, the autograd Function ``LemScan``) and
the LEM module's gradients (models/lem.py) against the JAX package.

* against ``jax.vjp`` of ``lem_scan(..., interpret=True)``, which runs
  ``_bwd_kernel`` interpreted, in float32 with N a multiple of no tile:
  rtol 5e-4, atol 1e-5 (tests/test_lem_pallas.py:151);
* the stash: ys[t], zs[t] are the states after step t, against the JAX
  scan run for t + 1 steps, in float32 at 1e-5 (as the forward);
* the module's gradients against ``LEM(impl="xla")`` in float64, with and
  without an initial state: 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.models.lem import LEM as JLEM
from msmp_pde_tpu.ops.lem_pallas import lem_scan as jlem_scan
from msmp_pde_torch.ops import lem_scan as ops

from _torch_helpers import np_tree, tt
from test_torch_lem import _case, _port


def _scan_args(T, N, H, seed):
    rng = np.random.default_rng(seed)
    a = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    args = (a(T, N, 3 * H), a(T, N, H), a(N, H, sc=.5), a(N, H, sc=.5),
            a(H, 3 * H, sc=H ** -.5), a(H, H, sc=H ** -.5))
    return args, (a(N, H), a(N, H))


@pytest.mark.parametrize("N,dt", [(45, 1.0), (37, 0.3)])
def test_scan_bwd_matches_pallas_interpret(N, dt):
    T, H = 25, 32
    args, (cy, cz) = _scan_args(T, N, H, N)
    _, vjp = jax.vjp(lambda *a: jlem_scan(*a, dt=dt, interpret=True),
                     *map(jnp.asarray, args))
    want = vjp((jnp.asarray(cy), jnp.asarray(cz)))

    targs = [torch.as_tensor(x) for x in args]
    _, _, ys, zs = ops.lem_scan_plain(*targs, dt=dt, stash=True)
    plain = ops.lem_scan_bwd_plain(*targs, ys, zs, torch.as_tensor(cy),
                                   torch.as_tensor(cz), dt=dt)
    before = (ops.launches, ops.bwd_launches)
    leaves = [x.clone().requires_grad_() for x in targs]
    yT, zT = ops.lem_scan(*leaves, dt=dt)
    auto = torch.autograd.grad((yT, zT), leaves, (torch.as_tensor(cy),
                                                 torch.as_tensor(cz)))
    assert (ops.launches, ops.bwd_launches) == before  # plain loops on CPU
    for got in (plain, auto):
        for k, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4,
                                       atol=1e-5, err_msg=str(k))


def test_stash_is_the_per_step_states():
    T, N, H = 25, 37, 32
    args, _ = _scan_args(T, N, H, 3)
    _, _, ys, zs = ops.lem_scan_plain(*map(torch.as_tensor, args),
                                      stash=True)
    assert ys.shape == zs.shape == (T, N, H)
    for t in (0, 11, T - 1):
        yj, zj = jlem_scan(jnp.asarray(args[0][:t + 1]),
                           jnp.asarray(args[1][:t + 1]),
                           *map(jnp.asarray, args[2:]), interpret=True)
        np.testing.assert_allclose(ys[t].numpy(), yj, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(zs[t].numpy(), zj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_lem_grads_match_xla_f64(with_state):
    T, N, I, H = 25, 30, 3, 32
    seq, state, p = _case(T, N, I, H, 50, with_state)
    rng = np.random.default_rng(51)
    cy, cz = rng.normal(size=(N, H)), rng.normal(size=(N, H))
    jm = JLEM(hidden=H, impl="xla")

    def loss(params, x, st):
        _, (y, z) = jm.apply(params, x, st)
        return jnp.sum(y * cy) + jnp.sum(z * cz)

    jstate = None if state is None else tuple(map(jnp.asarray, state))
    gp, gx, gs = jax.grad(loss, argnums=(0, 1, 2))(
        np_tree(p), jnp.asarray(seq), jstate)

    m = _port(p, I, H, torch.float64)
    x = tt(seq).requires_grad_()
    st = None if state is None else tuple(
        tt(s).requires_grad_() for s in state)
    _, (y, z) = m(x, st)
    (tt(cy) * y).sum().add((tt(cz) * z).sum()).backward()
    close = lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)
    for name, prm in m.named_parameters():
        close(prm.grad, gp["params"][name])
    close(x.grad, gx)
    if st is not None:
        close(st[0].grad, gs[0])
        close(st[1].grad, gs[1])


def test_kernels_reject_cpu_tensors():
    """The stash and backward entry points never fall back to the plain
    loops."""
    args, (cy, cz) = _scan_args(2, 3, 32, 0)
    t = [torch.as_tensor(x) for x in args]
    with pytest.raises(ValueError, match="CUDA"):
        ops.lem_scan_kernel(*t, stash=True)
    ys = torch.zeros(2, 3, 32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.lem_scan_bwd_kernel(*t, ys, ys, torch.as_tensor(cy),
                                torch.as_tensor(cz))
