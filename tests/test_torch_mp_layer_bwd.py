"""PyTorch port, the single layer's backward (ops/mp_layer.py:
``fused_mp_layer_bwd_plain`` and the autograd Function ``FusedMPLayer``)
and the gated pair's stash-and-fallback route (ops/mp_pair.py), against
the JAX package on the same numpy inputs, weights and cotangent.

* the layer against ``jax.grad`` through ``fused_mp_layer`` in interpret
  mode, which runs ``_bwd_kernel``: float32, rtol 5e-4 and atol 5e-5 as
  tests/test_mp_pallas.py:49-74;
* the layer against ``jax.grad`` of the XLA path in float64: 1e-8;
* the pair's fallback, forced by monkeypatching ``pair_bwd_fused_fits``,
  against the JAX fallback, forced as tests/test_mp_pallas.py:248-292
  forces it (float32, 1e-5), and against the port's fused route (float64,
  1e-10, only summation order differs). In float32 the layers' b4
  gradients are analytically zero (InstanceNorm removes them) and both
  sides hold roundoff of about 1e-5 there, which differs between them: b4
  is held to 1e-3 times its layer's w4 gradient, as
  chip_smoke.scale_aware does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.ops import mp_pallas
from msmp_pde_torch.ops import mp_layer, mp_pair

from _torch_helpers import np_tree, tt
from test_torch_mp_layer import DTW_2D, SWITCHES, V_2D, layer_case
from test_torch_mp_pair_bwd import _detached, _pair_case, _torch_args


def _ordered(p):
    """A flax layer tree in GNNLayer.weights() order."""
    p = p["params"]
    f = p["FactorizedEdgeDense_0"]
    out = [f[k] for k in ("w_hi", "w_hj", "w_du", "w_dx", "w_var", "bias")]
    for m in ("TorchDense_0", "TorchDense_1", "TorchDense_2"):
        out += [p[m]["kernel"], p[m]["bias"]]
    return out


def _jax_grads(layer, p, arrays, g, ega):
    """[dh, 12 weight gradients] of sum(out * g) through the JAX layer."""
    h, u, px, v, idx, mask = arrays
    rest = (u, px, v, jnp.asarray(idx), mask)

    def loss(p_, h_):
        return jnp.sum(layer.apply(p_, h_, *rest, ega=ega) * g)

    dp, dh = jax.grad(loss, argnums=(0, 1))(p, h)
    return [dh] + _ordered(dp)


def _port_grads(m, arrays, g, dtype):
    """[dh, 12 weight gradients] through ``FusedMPLayer`` and, the same,
    through ``fused_mp_layer_bwd_plain``."""
    h, u, px, v, idx, mask = arrays
    T = lambda a: tt(a, dtype)
    h = T(h).requires_grad_()
    args = (T(u), T(px)[..., None], T(v), torch.as_tensor(idx), T(mask))
    W = m.weights()
    out = mp_layer.fused_mp_layer(h, *args, W, m.final_act, m.residual)
    assert type(out.grad_fn).__name__ == "FusedMPLayerBackward"
    auto = torch.autograd.grad(out, [h, *W], T(g))
    dh, dws = mp_layer.fused_mp_layer_bwd_plain(
        h.detach(), *args, tuple(w.detach() for w in W), T(g), m.final_act,
        m.residual)
    return list(auto), [dh, *dws]


@pytest.mark.parametrize("graph,final_act,residual",
                         [("radius", *s) for s in SWITCHES]
                         + [("knn", True, True), ("knn_cheb", True, True),
                            ("knn_rpu", True, True)])
def test_layer_grads_match_pallas_interpret_f32(graph, final_act, residual):
    arrays, layer, p, m = layer_case(graph, final_act, residual, 10,
                                     torch.float32)
    g = np.random.default_rng(11).normal(size=arrays[0].shape)
    F = lambda a: jnp.asarray(a, jnp.float32)
    h, u, px, v, idx, mask = arrays
    ega = (mp_pallas.edge_matrices(jnp.asarray(idx), F(mask)), True,
           "float32")
    want = _jax_grads(layer, p, (F(h), F(u), F(px), F(v), idx, F(mask)),
                      F(g), ega)
    for got in _port_grads(m, arrays, g, torch.float32):
        for k, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy().reshape(np.shape(b)), b,
                                       rtol=5e-4, atol=5e-5, err_msg=str(k))


@pytest.mark.parametrize("graph", ["radius", "knn", "knn_cheb", "knn_rpu"])
@pytest.mark.parametrize("final_act,residual", SWITCHES)
def test_layer_grads_match_xla_f64(graph, final_act, residual):
    arrays, layer, p, m = layer_case(graph, final_act, residual, 20,
                                     torch.float64)
    g = np.random.default_rng(21).normal(size=arrays[0].shape)
    J = lambda a: jnp.asarray(a, jnp.float64)
    h, u, px, v, idx, mask = arrays
    want = _jax_grads(layer, np_tree(p), (J(h), J(u), J(px), J(v), idx,
                                          J(mask)), J(g), None)
    for got in _port_grads(m, arrays, g, torch.float64):
        for k, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                       atol=1e-8, err_msg=str(k))


@pytest.mark.parametrize("final_act,residual", SWITCHES)
def test_layer_d50_v3_grads_match_pallas_interpret_f32(final_act, residual):
    """The 2-D models' widths (D = 50, V = 3) through the JAX backward
    kernel in interpret mode."""
    arrays, layer, p, m = layer_case("radius", final_act, residual, 12,
                                     torch.float32, DTW_2D, V_2D)
    g = np.random.default_rng(13).normal(size=arrays[0].shape)
    F = lambda a: jnp.asarray(a, jnp.float32)
    h, u, px, v, idx, mask = arrays
    ega = (mp_pallas.edge_matrices(jnp.asarray(idx), F(mask)), True,
           "float32")
    want = _jax_grads(layer, p, (F(h), F(u), F(px), F(v), idx, F(mask)),
                      F(g), ega)
    for got in _port_grads(m, arrays, g, torch.float32):
        for k, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy().reshape(np.shape(b)), b,
                                       rtol=5e-4, atol=5e-5, err_msg=str(k))


@pytest.mark.parametrize("final_act,residual", SWITCHES)
def test_layer_d50_v3_grads_match_xla_f64(final_act, residual):
    arrays, layer, p, m = layer_case("radius", final_act, residual, 22,
                                     torch.float64, DTW_2D, V_2D)
    g = np.random.default_rng(23).normal(size=arrays[0].shape)
    J = lambda a: jnp.asarray(a, jnp.float64)
    h, u, px, v, idx, mask = arrays
    want = _jax_grads(layer, np_tree(p), (J(h), J(u), J(px), J(v), idx,
                                          J(mask)), J(g), None)
    for got in _port_grads(m, arrays, g, torch.float64):
        for k, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                       atol=1e-8, err_msg=str(k))


def _port_pair_grads(args, g, monkeypatch, fused):
    """dh and the 24 weight gradients through ``FusedGatedPair``, on the
    fused route or the fallback; checks which route ran."""
    calls = []
    plain_bwd = mp_layer.fused_mp_layer_bwd_plain

    def spy(*a, **k):
        calls.append(1)
        return plain_bwd(*a, **k)

    monkeypatch.setattr(mp_layer, "fused_mp_layer_bwd_plain", spy)
    monkeypatch.setattr(mp_pair, "pair_bwd_fused_fits",
                        lambda *a, **k: fused)
    h, u, px, v, idx, mask, Wg, Wl = args
    h = h.clone().requires_grad_()
    out = mp_pair.fused_gated_pair(h, u, px, v, idx, mask, Wg, Wl)
    grads = torch.autograd.grad(out, [h, *Wg, *Wl], g)
    monkeypatch.undo()
    assert len(calls) == (0 if fused else 2)  # one layer backward a layer
    return [a.numpy() for a in grads]


def test_pair_fallback_matches_jax_fallback(monkeypatch):
    arrays, _, _, (mg, ml) = _pair_case(24, 2, 32, 10, 2, 2, 30,
                                        torch.float32)
    h, u, px, v, idx, mask, g = arrays
    F = lambda a: jnp.asarray(a, jnp.float32)
    Wg = tuple(F(w.detach().numpy()) for w in mg.weights())
    Wl = tuple(F(w.detach().numpy()) for w in ml.weights())
    ega = mp_pallas.edge_matrices(jnp.asarray(idx), F(mask))
    mp_pallas.make_fused_pair.cache_clear()
    monkeypatch.setattr(mp_pallas, "_pair_bwd_bb", lambda *a, **k: 0)
    try:
        _, vjp = jax.vjp(
            lambda h_, wg, wl: mp_pallas.fused_gated_pair(
                h_, F(u), F(px)[..., None], F(v), ega, wg, wl,
                interpret=True),
            F(h), Wg, Wl)
        dh, dwg, dwl = vjp(F(g))
    finally:
        monkeypatch.undo()
        mp_pallas.make_fused_pair.cache_clear()
    want = [dh, *dwg, *dwl]
    args, gt = _torch_args(arrays, mg, ml, torch.float32)
    got = _port_pair_grads(args, gt, monkeypatch, fused=False)
    for k, (a, b) in enumerate(zip(got, want)):
        atol = 1e-5
        if k % 12 == 0 and k:  # outputs 12 and 24 are b4, 11 and 23 w4
            atol = 1e-3 * np.abs(want[k - 1]).max()
        np.testing.assert_allclose(a.reshape(np.shape(b)), b, rtol=1e-5,
                                   atol=atol, err_msg=str(k))


def test_pair_fallback_matches_fused_route(monkeypatch):
    arrays, _, _, (mg, ml) = _pair_case(24, 3, 32, 10, 2, 2, 40,
                                        torch.float64)
    args, gt = _torch_args(arrays, mg, ml, torch.float64)
    fallback = _port_pair_grads(args, gt, monkeypatch, fused=False)
    fused = _port_pair_grads(args, gt, monkeypatch, fused=True)
    for k, (a, b) in enumerate(zip(fallback, fused)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10,
                                   err_msg=str(k))


def test_stash_leaves_the_output_as_it_was():
    """The stash variant returns the same output, bitwise, and the two
    layers' normalized outputs."""
    arrays, _, _, (mg, ml) = _pair_case(24, 2, 32, 10, 2, 2, 50,
                                        torch.float32)
    args, _ = _torch_args(arrays, mg, ml, torch.float32)
    args = _detached(args)
    out, gn, ln = mp_pair.fused_gated_pair_plain(*args, stash=True)
    assert torch.equal(out, mp_pair.fused_gated_pair_plain(*args))
    assert torch.equal(gn, mp_layer.fused_mp_layer_plain(*args[:6], args[6]))
    assert torch.equal(ln, mp_layer.fused_mp_layer_plain(*args[:6], args[7]))


def test_fused_route_fits_on_cpu():
    assert mp_pair.pair_bwd_fused_fits(1000, 100, 128, 25, 1, 6, "cpu")


def test_bwd_kernel_rejects_cpu_tensors():
    """The backward kernel's entry point never falls back to the plain
    version."""
    arrays, _, _, m = layer_case("radius", True, True, 60, torch.float32)
    h, u, px, v, idx, mask = (tt(a, torch.float32) for a in arrays)
    with pytest.raises(ValueError, match="CUDA"):
        mp_layer.fused_mp_layer_bwd_kernel(
            h, u, px[..., None], v, idx.long(), mask, m.weights(), h, True,
            True)
