"""PyTorch port, the fused gated pair's backward (ops/mp_pair.py:
``fused_gated_pair_bwd_plain`` and the autograd Function ``FusedGatedPair``)
against the JAX package on the same numpy inputs, weights and cotangent.

* against ``jax.vjp`` of ``fused_gated_pair(..., interpret=True)``, which
  runs ``_pair_bwd_kernel`` interpreted: float32, so the bound is
  scale-aware, max|diff| <= max(1e-3 max|ref|, 2e-4) per gradient (b4's
  gradient is analytically zero and both sides return roundoff there);
* against ``jax.grad`` of the XLA layer path (gate layer, main layer,
  combine) in float64: 1e-10, only summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.models.common import swish as jswish
from msmp_pde_tpu.ops.mp_pallas import edge_matrices, fused_gated_pair
from msmp_pde_torch.ops import mp_pair

from _torch_helpers import np_tree, tt
from test_torch_mp_pair import CASES, _inputs, _jax_layer_params, _port_layer


def _pair_case(nx, B, H, dtw, V, n, seed, dtype):
    h, u, px, v, idx, mask = _inputs(nx, B, H, dtw, V, n, seed)
    layer, pg = _jax_layer_params(h, u, px, v, idx, mask, seed)
    _, pl = _jax_layer_params(h, u, px, v, idx, mask, seed + 1)
    g = np.random.default_rng(seed + 2).normal(size=h.shape)
    mg = _port_layer(pg, H, dtw, V, dtype)
    ml = _port_layer(pl, H, dtw, V, dtype)
    return (h, u, px, v, idx, mask, g), layer, (pg, pl), (mg, ml)


def _torch_args(arrays, mg, ml, dtype):
    h, u, px, v, idx, mask, g = arrays
    T = lambda a: tt(a, dtype)
    return (T(h), T(u), T(px)[..., None], T(v), torch.as_tensor(idx),
            T(mask), mg.weights(), ml.weights()), T(g)


def _detached(args):
    return args[:6] + tuple(tuple(w.detach() for w in W) for W in args[6:])


def _autograd(args, g):
    """dh and the 24 weight gradients through ``fused_gated_pair`` with
    grad enabled, i.e. through ``FusedGatedPair``."""
    h, u, px, v, idx, mask, Wg, Wl = args
    h = h.clone().requires_grad_()
    ws = list(Wg) + list(Wl)
    before = (mp_pair.launches, mp_pair.bwd_launches)
    out = mp_pair.fused_gated_pair(h, u, px, v, idx, mask, Wg, Wl)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, [h] + ws, g)
    # CPU tensors take the plain versions
    assert (mp_pair.launches, mp_pair.bwd_launches) == before
    return grads


def _assert_scale_aware(got, want):
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= max(1e-3 * scale, 2e-4), (k, err, scale)


@pytest.mark.parametrize("nx,B,H,dtw,V,n", CASES)
def test_pair_bwd_matches_pallas_interpret_f32(nx, B, H, dtw, V, n):
    arrays, _, _, (mg, ml) = _pair_case(nx, B, H, dtw, V, n, 10,
                                        torch.float32)
    h, u, px, v, idx, mask, g = arrays
    F = lambda a: jnp.asarray(a, jnp.float32)
    Wg = tuple(F(w.detach().numpy()) for w in mg.weights())
    Wl = tuple(F(w.detach().numpy()) for w in ml.weights())
    ega = edge_matrices(jnp.asarray(idx), F(mask))
    _, vjp = jax.vjp(
        lambda h_, wg, wl: fused_gated_pair(h_, F(u), F(px)[..., None],
                                            F(v), ega, wg, wl,
                                            interpret=True),
        F(h), Wg, Wl)
    dh, dwg, dwl = vjp(F(g))
    want = [dh] + list(dwg) + list(dwl)

    args, gt = _torch_args(arrays, mg, ml, torch.float32)
    ph, pg, pl = mp_pair.fused_gated_pair_bwd_plain(*_detached(args), gt)
    _assert_scale_aware([ph] + list(pg) + list(pl), want)
    _assert_scale_aware(_autograd(args, gt), want)


@pytest.mark.parametrize("nx,B,H,dtw,V,n", CASES)
def test_pair_grads_match_xla_f64(nx, B, H, dtw, V, n):
    arrays, layer, (pg, pl), (mg, ml) = _pair_case(nx, B, H, dtw, V, n, 20,
                                                   torch.float64)
    h, u, px, v, idx, mask, g = arrays
    J = lambda a: jnp.asarray(a, jnp.float64)
    rest = (J(u), J(px), J(v), jnp.asarray(idx), J(mask))

    def pair(h_, pg_, pl_):
        tau = jax.nn.sigmoid(layer.apply(pg_, h_, *rest))
        return (1.0 - tau) * h_ + tau * jswish(layer.apply(pl_, h_, *rest))

    _, vjp = jax.vjp(pair, J(h), np_tree(pg), np_tree(pl))
    dh, dpg, dpl = vjp(J(g))

    def ordered(p):  # the flax tree in GNNLayer.weights() order
        p = p["params"]
        f = p["FactorizedEdgeDense_0"]
        out = [f[k] for k in ("w_hi", "w_hj", "w_du", "w_dx", "w_var",
                              "bias")]
        for m in ("TorchDense_0", "TorchDense_1", "TorchDense_2"):
            out += [p[m]["kernel"], p[m]["bias"]]
        return out

    want = [dh] + ordered(dpg) + ordered(dpl)
    args, gt = _torch_args(arrays, mg, ml, torch.float64)
    ph, pgr, plr = mp_pair.fused_gated_pair_bwd_plain(*_detached(args), gt)
    for got in ([ph] + list(pgr) + list(plr), _autograd(args, gt)):
        for k, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                       atol=1e-10, err_msg=str(k))


def test_no_grad_skips_the_function():
    """Without grad the pair returns a plain tensor (no saved inputs)."""
    arrays, _, _, (mg, ml) = _pair_case(24, 1, 32, 10, 1, 2, 30,
                                        torch.float64)
    args, _ = _torch_args(arrays, mg, ml, torch.float64)
    with torch.no_grad():
        out = mp_pair.fused_gated_pair(*args)
    assert out.grad_fn is None


def test_bwd_kernel_rejects_cpu_tensors():
    """The backward kernel's entry point never falls back to the plain
    version."""
    arrays, _, _, (mg, ml) = _pair_case(24, 1, 32, 10, 1, 2, 40,
                                        torch.float32)
    args, g = _torch_args(arrays, mg, ml, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        mp_pair.fused_gated_pair_bwd_kernel(*args, g)
