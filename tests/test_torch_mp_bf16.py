"""PyTorch port, the bf16 precision modes of the message-passing layers
(``mp_precision`` = ``bfloat16`` / ``bfloat16s``, ops/mp_layer.py and
ops/mp_pair.py) against the JAX package's Pallas route, which the modes
act on: ``_forward_math`` / ``_layer_bwd_math`` and their stages with
``mm=bfloat16``, and ``fused_mp_layer`` / ``fused_gated_pair`` /
``MPSolver(mp_impl="pallas"|"pallas_pair")`` run interpreted. The JAX
``mp_impl="auto"`` route on the CPU is XLA and ignores the flag, so it is
never the reference here. float32 inputs made with numpy from a seed, nx
24 (40 for RPU's graph), hidden 32, on a radius graph with truncated
boundary masks and on RPU's k-NN graph with nodes of in-degree 0.

* One test per rounding site, each feeding both sides the same float32
  operand: E s_i + G s_j, A m2, A^T dagg, E^T dm0 and G^T dm0, u^T (ds_i -
  ds_j), the dense products and weight gradients after a swish, and the
  bias gradients from the unrounded cotangents; 1e-6 of the site's scale
  (only the float32 summation order differs). Each also checks that the
  site rounds: the JAX stage in float32 lies farther than that. A teeth
  case turns the rounding of 1/deg off and the A m2 site must fail.
* The plain layer and the gated pair (fused backward and the forced
  fallback), forward and backward, in both modes, against the interpreted
  kernels: each output's distance from JAX's bf16 result (Frobenius) over
  the distance between JAX's bf16 and float32 results, which must pass
  1e-6: the forwards and the layer's backward within 0.1, the pair's
  backward 0.5 (the bounds below). A layer's b4 gradient is analytically
  zero without a final activation (InstanceNorm removes it): it is held to
  its layer's w4 distance, as chip_smoke.grad_scales does.
* MSMP-PDE and MP-PDE at 2 layers (hidden 96, nx 40, B 2): the forward
  within 0.3; a step's gradients over all parameters as far from the
  port's float32 step as JAX's bf16 step lies from JAX's (0.9-1.1) and
  within 1.6 of that distance from JAX's bf16 step.
* ``mp_remat``: the port's step under torch.utils.checkpoint equals its
  plain path's (float64, 1e-6; every layer recomputed once) and the JAX
  ``mp_remat`` step (float64, 1e-8); an unknown mode raises.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.data.graph import build_neighbors_radius
from msmp_pde_tpu.models.gnn import MPSolver as JSolver
from msmp_pde_tpu.ops import mp_pallas
from msmp_pde_torch.models.common import swish
from msmp_pde_torch.models.gnn import MPSolver
from msmp_pde_torch.models.registry import get_model
from msmp_pde_torch.ops import mp_layer, mp_pair
from msmp_pde_torch.training.setup import build_trainer
from msmp_pde_torch.utils.convert import params_from_flax

from _torch_helpers import np_tree, tt
from test_torch_model import _case
from test_torch_mp_layer import B, DTW, H, NX, RPU_NX, V, layer_case, \
    rpu_graph
from test_torch_mp_layer_bwd import _ordered
from test_torch_mp_pair_bwd import _detached, _pair_case, _torch_args
from test_torch_train import ENCODER_GATE, TOL, _leaf, _trainers

BF16 = jnp.dtype(jnp.bfloat16)
MODES = ("bfloat16", "bfloat16s")
GRAPHS = ("radius", "knn_rpu")
F = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
T = lambda a: tt(a, torch.float32)  # noqa: E731
per_elem = mp_pallas._per_elem


def _graph(graph):
    """(idx, mask float32, E, G, A) of a site test's graph."""
    if graph == "knn_rpu":
        idx, mask = rpu_graph(RPU_NX)
    else:
        idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, NX), 2)
    idx, mask = np.asarray(idx), np.asarray(mask, np.float32)
    return (idx, mask, *mp_pallas.edge_matrices(jnp.asarray(idx), F(mask)))


def _rows(x):
    return np.asarray(x, np.float64).reshape(-1, np.shape(x)[-1])


def _site(got, want, want32, mask=None):
    """got within 1e-6 of max|want| of JAX's bf16 stage, which lies farther
    than 1e-4 of it from ``want32`` (the site rounds: its float32 stage, or
    a wrong rounding); ``mask`` picks the rows compared."""
    got, want, want32 = _rows(got), _rows(want), _rows(want32)
    if mask is not None:
        got, want, want32 = got[mask], want[mask], want32[mask]
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= 1e-6 * scale, (err, scale)
    assert np.abs(want - want32).max() > 1e-4 * scale


@pytest.mark.parametrize("graph", GRAPHS)
def test_site_edge_inputs(graph):
    """m0 = bf16(s_i[i]) + bf16(s_j[idx[i, k]]), E s_i + G s_j
    (mp_pallas.py:119). Only the valid edges: the TPU's G row of a masked
    slot is zero (m0 = s_i there) while the port gathers idx; that edge's
    message never reaches an output (its A entry and its dz2 are 0)."""
    idx, mask, E, G, A = _graph(graph)
    nx = idx.shape[0]
    s_i, s_j = np.random.default_rng(1).normal(size=(2, B, nx, H))

    def jax_site(mm):
        return (per_elem(E, F(s_i).reshape(-1, H), nx, B, mm)
                + per_elem(G, F(s_j).reshape(-1, H), nx, B, mm))

    got = mp_layer._edge_in(T(s_i), T(s_j), torch.as_tensor(idx),
                            mp_layer._bf16)
    valid = np.broadcast_to(mask[None], (B,) + mask.shape).reshape(-1) > 0
    _site(got, jax_site(BF16), jax_site(None), valid)


def _check_aggregate(graph):
    idx, mask, E, G, A = _graph(graph)
    nx, K = idx.shape
    z2 = np.random.default_rng(2).normal(size=(B, nx, K, H))
    m2 = mp_pallas._swish(F(z2).reshape(-1, H))
    got = mp_layer._aggregate(T(z2), T(mask), 1)
    _site(got, per_elem(A, m2, nx * K, B, BF16),
          per_elem(A, m2, nx * K, B, None))


@pytest.mark.parametrize("graph", GRAPHS)
def test_site_aggregate(graph):
    """agg = sum_k bf16(mask / deg) bf16(swish(z2)), A m2 (mp_pallas.py:
    124): JAX's 0.2% scale of bf16(1/3) and bf16(1/6) included."""
    _check_aggregate(graph)


def test_teeth_unrounded_inverse_degree(monkeypatch):
    """With 1/deg left unrounded the A m2 site must fail: the site tests
    see a site's rounding."""
    keep = mp_layer._a_entries
    monkeypatch.setattr(mp_layer, "_a_entries",
                        lambda mask, r: keep(mask, lambda x: x))
    with pytest.raises(AssertionError):
        _check_aggregate("knn_rpu")


@pytest.mark.parametrize("graph", GRAPHS)
def test_site_aggregate_bwd(graph):
    """dz2 = bf16(dagg) bf16(mask / deg) swish'(z2), (A^T dagg) swish'(z2)
    (mp_pallas.py:207-208)."""
    idx, mask, E, G, A = _graph(graph)
    nx, K = idx.shape
    rng = np.random.default_rng(3)
    dagg, z2 = rng.normal(size=(B, nx, H)), rng.normal(size=(B, nx, K, H))

    def jax_site(mm):
        return (per_elem(A.T, F(dagg).reshape(-1, H), nx, B, mm)
                * mp_pallas._dswish(F(z2).reshape(-1, H)))

    got = mp_layer._aggregate_bwd(T(dagg), T(mask), T(z2), 1)
    _site(got, jax_site(BF16), jax_site(None))


@pytest.mark.parametrize("graph", GRAPHS)
def test_site_gather_bwd(graph):
    """ds_i = sum_k bf16(dm0), ds_j = sum over the inverse list of
    mask bf16(dm0): E^T dm0 and G^T dm0 (mp_pallas.py:213-214); RPU's
    nodes of in-degree 0 get 0."""
    idx, mask, E, G, A = _graph(graph)
    nx, K = idx.shape
    dm0 = np.random.default_rng(4).normal(size=(B, nx, K, H))
    x = F(dm0).reshape(-1, H)
    ds_i, ds_j = mp_layer._gather_bwd(T(dm0), torch.as_tensor(idx),
                                      T(mask), mp_layer._bf16)
    for got, M in ((ds_i, E), (ds_j, G)):
        _site(got, per_elem(M.T, x, nx * K, B, BF16),
              per_elem(M.T, x, nx * K, B, None))


def test_site_mix_grads():
    """[dw_du; dw_dx] = [u px]^T bf16(ds_i - ds_j) (mp_pallas.py:218-220):
    the difference first, then the rounding, which bf16(ds_i) - bf16(ds_j)
    misses."""
    rng = np.random.default_rng(5)
    u, ds_i, ds_j = (rng.normal(size=(B, NX, n)) for n in (DTW, H, H))
    px = rng.uniform(size=(B, NX, 1))
    got = mp_layer._mix_grads(T(u), T(px), T(ds_i), T(ds_j), mp_layer._bf16)
    r = lambda a: F(a).reshape(-1, np.shape(a)[-1])  # noqa: E731
    dmix = r(ds_i) - r(ds_j)
    for g, x in zip(got, (u, px)):
        want = mp_pallas._dot_t(r(x), dmix, BF16)
        _site(g, want, mp_pallas._dot_t(r(x), dmix))
        split = mp_pallas._dot_t(r(x), r(ds_i).astype(BF16).astype(
            jnp.float32) - r(ds_j).astype(BF16).astype(jnp.float32), BF16)
        assert (np.abs(_rows(g) - _rows(split)).max()
                > 1e-5 * np.abs(_rows(want)).max())


def test_site_dense_products():
    """A product's A operand rounds after its swish: z2 = bf16(swish(m0))
    bf16(w2) + b2 and dw2 = bf16(swish(m0))^T bf16(dz2) (the tile's put
    after post, csrc/mp_phases.cuh)."""
    rng = np.random.default_rng(6)
    m0, dz2 = rng.normal(size=(2, B, NX, 3, H))
    w2 = rng.normal(size=(H, H)) / np.sqrt(H)
    m1 = mp_pallas._swish(F(m0).reshape(-1, H))
    g2 = F(dz2).reshape(-1, H)
    got = mp_layer._mm(swish(T(m0)), T(w2), mp_layer._bf16)
    _site(got, mp_pallas._dot(m1, F(w2), BF16), mp_pallas._dot(m1, F(w2)))
    got = mp_layer._outer(swish(T(m0)), T(dz2), mp_layer._bf16)
    _site(got, mp_pallas._dot_t(m1, g2, BF16), mp_pallas._dot_t(m1, g2))


@pytest.mark.parametrize("final_act", [True, False])
def test_site_bias_grads(final_act):
    """db4 and db3 sum the unrounded dz4 and dz3 (jnp.sum in
    mp_pallas.py:197-200), dw4 = bf16(swish(z3))^T bf16(dz4): the layer
    backward from the same intermediates and cotangent as JAX's
    ``_layer_bwd_math``. (The gradients downstream of a product read its
    float32 result, whose summation order differs, before they round.)"""
    arrays, _, p, _ = layer_case("radius", final_act, final_act, 7,
                                 torch.float32)
    h, u, px, v, idx, mask = arrays
    E, G, A = mp_pallas.edge_matrices(jnp.asarray(idx), F(mask))
    W = tuple(F(w) for w in _ordered(p))
    Wt = tuple(T(w) for w in W)
    jin = (F(h).reshape(-1, H), F(u).reshape(-1, DTW),
           F(px).reshape(-1, 1), F(v).reshape(-1, V))
    dxo = np.random.default_rng(8).normal(size=(B * NX, H))
    want, saved = {}, {}
    for mm in (BF16, None):
        _, saved[mm] = mp_pallas._forward_math(*jin, E, G, A, W, final_act,
                                               final_act, B, NX, mm)
        want[mm] = mp_pallas._layer_bwd_math(
            F(dxo), *jin, E, G, A, W, saved[mm], final_act, final_act, B,
            NX, mm)[1]
    # the port reads JAX's bf16 intermediates
    s_i, s_j, m0, m1, z2, m2, agg, z3, a3, z4 = saved[BF16]
    K = idx.shape[1]
    ours = (T(m0).reshape(B, NX, K, H), T(m1).reshape(B, NX, K, H),
            T(z2).reshape(B, NX, K, H),
            torch.cat([T(h), T(agg).reshape(B, NX, H), T(v)], -1),
            *(T(x).reshape(B, NX, H) for x in (z3, a3, z4)))
    _, got = mp_layer._layer_backward(
        T(dxo).reshape(B, NX, H), T(h), T(u), T(px)[..., None], T(v),
        torch.as_tensor(idx), T(mask), Wt, ours, final_act, final_act, 1)
    _site(got[10], want[BF16][10], want[None][10])  # dw4
    # db4 and db3 against JAX's, and against the sums of the rounded
    # cotangents, which they are not
    dz4 = F(dxo) * mp_pallas._dswish(z4) if final_act else F(dxo)
    dz3 = mp_pallas._dot(dz4, W[10].T, BF16) * mp_pallas._dswish(z3)
    for k, dz in ((11, dz4), (9, dz3)):
        rounded = jnp.sum(dz.astype(BF16).astype(jnp.float32), axis=0)
        _site(got[k], want[BF16][k], rounded)


# ---- the layer and the pair against the interpreted kernels ---------------
# A result is held by its ratio ||port - JAX bf16|| / ||JAX bf16 - JAX
# float32|| (Frobenius norms; the distance must pass 1e-6). Both sides sum
# in float32 in different orders, so a value within a few float32 ulps of a
# bf16 rounding boundary can round the other way: a flip of one bf16 ulp of
# one operand, where the bf16 distance is half an ulp of every operand. The
# flips are rare in a forward and local (one graph of the batch), but a
# backward rounds ~30,000 values here and a flip reaches a whole layer's
# weight gradients, and in a model each flip moves later values by a bf16
# ulp's fraction and so flips more: a one-ulp change of the JAX MPSolver's
# float32 window moves its own bf16 step gradients by 0.30-0.36 of the bf16
# distance. The Frobenius norm averages the flips, where the max norm
# reads the largest one. The bounds are the 0.1 of the forwards and the
# layer's backward, or twice the largest ratio of three seeds (10-12 for
# the layer and the pair, 0-2 for the models; CHANGES.md). The
# rounding sites themselves are held at 1e-6 above, where both sides round
# the same operands.
FWD_RATIO = 0.1        # the layer's and the pair's forward (seeds: 0.0125)
LAYER_BWD_RATIO = 0.1  # the layer's backward (seeds: 0.0006)
PAIR_BWD_RATIO = 0.5   # the pair's backward (seeds: 0.236)
MODEL_FWD_RATIO = 0.3  # the model's forward (seeds: 0.149)
# A step's gradients, over all parameters (each over its scale): their
# distance from JAX's bf16 step (seeds: 0.795) is not held below JAX's own
# flips, so an float32 step would pass it; their distance from the port's
# float32 step over JAX's bf16-to-float32 distance (seeds: 0.981-1.050)
# is the check that the operands round.
MODEL_STEP_RATIO = 1.6
SELF_RATIO = (0.9, 1.1)


def _fro(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()
                                - np.asarray(b, np.float64).ravel()))


def _ratios(got, want, want32, b4=()):
    """For each got[k], ||got - JAX bf16|| over the distance between JAX's
    bf16 and float32 results, which must pass 1e-6; the indices ``b4`` (a
    LayerLin's analytically zero b4 gradient) take the max of their own
    distance and that of the w4 gradient one before them."""
    dist = [_fro(w, w32) for w, w32 in zip(want, want32)]
    out = []
    for k, (a, w) in enumerate(zip(got, want)):
        d = max(dist[k], dist[k - 1]) if k in b4 else dist[k]
        assert d > 1e-6, (k, d)
        out.append(_fro(a, w) / d)
    return out


def _held(ratios, bound):
    worst = int(np.argmax(ratios))
    assert ratios[worst] <= bound, (worst, ratios[worst], bound)


LAYER_CASES = [("radius", True), ("radius", False), ("knn_rpu", True)]


@functools.lru_cache(maxsize=None)
def _jax_layer(graph, switch, mode, seed):
    """(out, dh, 12 gradients) of JAX's interpreted layer in ``mode``."""
    arrays, _, p, _ = layer_case(graph, switch, switch, seed, torch.float32)
    h, u, px, v, idx, mask = arrays
    ega = mp_pallas.edge_matrices(jnp.asarray(idx), F(mask))
    g = np.random.default_rng(seed + 1).normal(size=h.shape)
    out, vjp = jax.vjp(
        lambda h_, W: mp_pallas.fused_mp_layer(
            h_, F(u), F(px)[..., None], F(v), ega, W, final_act=switch,
            residual=switch, interpret=True, mm_dtype=mode),
        F(h), tuple(F(w) for w in _ordered(p)))
    dh, dw = vjp(F(g))
    return [out, dh, *dw]


def layer_ratios(graph, switch, mode, seed):
    """(forward ratio, backward ratios) of the plain layer in ``mode``,
    through ``FusedMPLayer`` (which must equal the plain backward)."""
    arrays, _, _, m = layer_case(graph, switch, switch, seed, torch.float32)
    h, u, px, v, idx, mask = arrays
    g = T(np.random.default_rng(seed + 1).normal(size=h.shape))
    args = (T(u), T(px)[..., None], T(v), torch.as_tensor(idx), T(mask))
    W = m.weights()
    hd = T(h).requires_grad_()
    out = mp_layer.fused_mp_layer(hd, *args, W, switch, switch, mode)
    assert type(out.grad_fn).__name__ == "FusedMPLayerBackward"
    auto = torch.autograd.grad(out, [hd, *W], g)
    dh, dws = mp_layer.fused_mp_layer_bwd_plain(
        T(h), *args, tuple(w.detach() for w in W), g, switch, switch, mode)
    for a, b in zip(auto, [dh, *dws]):  # the Function threads the mode
        assert torch.equal(a, b)
    r = _ratios([out.detach(), dh, *dws], _jax_layer(graph, switch, mode, seed),
                _jax_layer(graph, switch, "float32", seed),
                () if switch else (13,))
    return r[0], r[1:]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("graph,switch", LAYER_CASES)
def test_layer_matches_pallas_interpret(graph, switch, mode):
    fwd, bwd = layer_ratios(graph, switch, mode, 10)
    _held([fwd], FWD_RATIO)
    _held(bwd, LAYER_BWD_RATIO)


PAIR_CASES = [(24, 3, 32, 10, 2, 2), (40, 2, 32, 50, 3, "knn_rpu")]


@functools.lru_cache(maxsize=None)
def _jax_pair(case, mode, fallback, seed):
    """(out, dh, 24 gradients) of JAX's interpreted pair in ``mode``, its
    fused backward or (``fallback``) the stash-and-fallback route, forced
    as tests/test_mp_pallas.py:248-292 forces it."""
    arrays, _, _, (mg, ml) = _pair_case(*case, seed, torch.float32)
    h, u, px, v, idx, mask, g = arrays
    Wg, Wl = (tuple(F(w.detach().numpy()) for w in m.weights())
              for m in (mg, ml))
    ega = mp_pallas.edge_matrices(jnp.asarray(idx), F(mask))
    keep = mp_pallas._pair_bwd_bb
    mp_pallas.make_fused_pair.cache_clear()
    if fallback:
        mp_pallas._pair_bwd_bb = lambda *a, **k: 0
    try:
        out, vjp = jax.vjp(
            lambda h_, wg, wl: mp_pallas.fused_gated_pair(
                h_, F(u), F(px)[..., None], F(v), ega, wg, wl,
                interpret=True, mm_dtype=mode), F(h), Wg, Wl)
        dh, dwg, dwl = vjp(F(g))
    finally:
        mp_pallas._pair_bwd_bb = keep
        mp_pallas.make_fused_pair.cache_clear()
    return [out, dh, *dwg, *dwl]


def pair_ratios(case, mode, fallback, seed):
    """(forward ratio, backward ratios) of the plain pair in ``mode``
    through ``FusedGatedPair``: its fused backward, or the fallback forced
    with ``pair_bwd_fused_fits`` False (as tests/test_torch_mp_layer_bwd.py
    forces it), whose combine backward takes the caller's float32 h in the
    storage mode, as JAX's does."""
    arrays, _, _, (mg, ml) = _pair_case(*case, seed, torch.float32)
    args, g = _torch_args(arrays, mg, ml, torch.float32)
    keep = mp_pair.pair_bwd_fused_fits
    if fallback:
        mp_pair.pair_bwd_fused_fits = lambda *a: False
    try:
        h = args[0].clone().requires_grad_()
        ws = list(args[6]) + list(args[7])
        out = mp_pair.fused_gated_pair(h, *args[1:], mode)
        auto = torch.autograd.grad(out, [h] + ws, g)
    finally:
        mp_pair.pair_bwd_fused_fits = keep
    plain = _detached(args)
    if fallback:
        o, gn, ln = mp_pair.fused_gated_pair_plain(*plain, True, mode)
        assert torch.equal(o, out.detach())
        dh, dwg, dwl = mp_pair.fallback_bwd(*plain, gn, ln, g, mode)
    else:
        dh, dwg, dwl = mp_pair.fused_gated_pair_bwd_plain(*plain, g, mode)
    for a, b in zip(auto, [dh, *dwg, *dwl]):
        assert torch.equal(a, b)
    r = _ratios([out.detach(), dh, *dwg, *dwl],
                _jax_pair(case, mode, fallback, seed),
                _jax_pair(case, "float32", fallback, seed), (13, 25))
    return r[0], r[1:]


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", PAIR_CASES)
def test_pair_matches_pallas_interpret(case, mode, fallback):
    fwd, bwd = pair_ratios(case, mode, fallback, 10)
    _held([fwd], FWD_RATIO)
    _held(bwd, PAIR_BWD_RATIO)


# ---- the models --------------------------------------------------------------
MH, MLAYERS = 96, 2  # tw=25 needs hidden >= 88
L_, TMAX_, DT_ = 16.0, 4.0, 4.0 / 249


def _model_case(name, seed):
    inputs = _case(1, seed)
    window, pos_x, t, var_vec, idx, mask = inputs
    encoder, gate = ENCODER_GATE[name]
    j = JSolver(tw=25, hidden=MH, layers=MLAYERS, encoder=encoder, gate=gate,
                L=L_, tmax=TMAX_, dt=DT_, mp_impl="xla", lem_impl="xla")
    p = np_tree(j.init(jax.random.PRNGKey(seed), F(window), F(pos_x), F(t),
                       F(var_vec), jnp.asarray(idx), F(mask)), np.float32)
    y = np.random.default_rng(seed + 1).normal(size=window.shape)
    return inputs, p, y


@functools.lru_cache(maxsize=None)
def _jax_model(name, mode, seed):
    """(out, {param name: loss gradient}) of the JAX MPSolver on the
    Pallas route (``pallas`` ungated, ``pallas_pair`` gated) in ``mode``,
    the loss sqrt(sum((out - y)^2)) of a train step."""
    (window, pos_x, t, var_vec, idx, mask), p, y = _model_case(name, seed)
    encoder, gate = ENCODER_GATE[name]
    j = JSolver(tw=25, hidden=MH, layers=MLAYERS, encoder=encoder, gate=gate,
                L=L_, tmax=TMAX_, dt=DT_, lem_impl="xla",
                mp_impl="pallas" if gate == "none" else "pallas_pair",
                mp_precision=mode)
    ins = (F(window), F(pos_x), F(t), F(var_vec), jnp.asarray(idx), F(mask))

    def loss(p_):
        out = j.apply(p_, *ins)[0]
        return jnp.sqrt(jnp.sum((out - F(y)) ** 2)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(F, p))
    return np.asarray(out), grads


def _port_model(name, mode, seed):
    """(out, {param name: loss gradient}) of the port's model in ``mode``
    on CPU tensors (the plain versions), no kernel launched."""
    (window, pos_x, t, var_vec, idx, mask), p, y = _model_case(name, seed)
    m, _ = get_model(name, tw=25, n_eq_vars=0, L=L_, tmax=TMAX_, dt=DT_,
                     n_layers=MLAYERS, hidden=MH, mp_precision=mode)
    m.load_state_dict(params_from_flax(p), strict=True)
    before = (mp_layer.launches, mp_pair.launches)
    out, _ = m(T(window), T(pos_x), T(t), T(var_vec), torch.as_tensor(idx),
               T(mask))
    assert (mp_layer.launches, mp_pair.launches) == before
    loss = torch.sqrt(((out - T(y)) ** 2).sum())
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, list(m.parameters()))
    return out.detach().numpy(), {n: g.numpy() for n, g in zip(names, grads)}


def _step_distance(a, b, ref):
    """The distance of two steps' gradients {name: array} over all
    parameters, each over its scale in ``ref`` (b4, a LayerLin's roundoff
    around zero, over its w4's)."""
    total = 0.0
    for n, g in a.items():
        scale = np.abs(np.asarray(ref[n])).max()
        if n.endswith("TorchDense_2.bias"):
            w4 = np.asarray(ref[n[:-len("bias")] + "kernel"])
            scale = max(scale, np.abs(w4).max())
        total += (_fro(g, b[n]) / scale) ** 2
    return np.sqrt(total)


def model_ratios(name, mode, seed):
    """(forward ratio, the step's distance from JAX's bf16 step, the
    port's bf16-to-float32 step distance, each over JAX's bf16-to-float32
    distance)."""
    out, grads = _port_model(name, mode, seed)
    _, grads32 = _port_model(name, "float32", seed)
    want, want32 = (_jax_model(name, m, seed) for m in (mode, "float32"))
    leaves = lambda tree: {n: _leaf(tree, n) for n in grads}  # noqa: E731
    jb, jf = leaves(want[1]), leaves(want32[1])
    d = _step_distance(jb, jf, jb)
    assert d > 1e-6
    fwd = _ratios([out], [want[0]], [want32[0]])[0]
    return (fwd, _step_distance(grads, jb, jb) / d,
            _step_distance(grads, grads32, jb) / d)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["MSMP-PDE", "MP-PDE"])
def test_model_matches_pallas_interpret(name, mode):
    """The forward, and a step's gradients: as far from the port's float32
    step as JAX's bf16 step lies from its float32 step (the operands
    round), and not farther from JAX's bf16 step than MODEL_STEP_RATIO of
    that distance."""
    fwd, step, own = model_ratios(name, mode, 0)
    _held([fwd], MODEL_FWD_RATIO)
    _held([step], MODEL_STEP_RATIO)
    assert SELF_RATIO[0] <= own <= SELF_RATIO[1], own


# ---- mp_remat and the flag's checks ----------------------------------------
def _step_grads(trainer, u, ib, st):
    loss = trainer.step_loss(tt(u), {}, torch.as_tensor(ib),
                             torch.as_tensor(st), 0)
    return loss, torch.autograd.grad(loss, list(trainer.model.parameters()))


@pytest.mark.parametrize("name", ["MSMP-PDE", "MP-PDE"])
def test_remat_grads_equal_plain_path(name, monkeypatch):
    """``mp_remat`` differentiates the layers' torch ops under
    torch.utils.checkpoint: the step's gradients are the plain path's
    (FusedMPLayer / FusedGatedPair with the hand-written backward), and
    every layer runs twice, the second time in the backward."""
    _, _, trainer = _trainers(25, 100, name)
    rng = np.random.default_rng(40)
    u = rng.normal(size=(4, 100, trainer.spec.nx))
    ib, st = rng.permutation(4)[:2], rng.integers(25, 76, size=2)
    loss, want = _step_grads(trainer, u, ib, st)
    calls = []
    plain = mp_layer.fused_mp_layer_plain
    monkeypatch.setattr(mp_layer, "fused_mp_layer_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    trainer.model.mp_remat = True
    loss_r, got = _step_grads(trainer, u, ib, st)
    n_layers = MLAYERS * (1 if ENCODER_GATE[name][1] == "none" else 2)
    assert len(calls) == 2 * n_layers
    np.testing.assert_allclose(loss_r.item(), loss.item(), rtol=1e-12)
    # a b4 gradient (TorchDense_2.bias) is roundoff around zero without a
    # final activation: its scale is its layer's w4 gradient's
    grads = dict(zip((n for n, _ in trainer.model.named_parameters()),
                     zip(got, want)))
    for n, (a, b) in grads.items():
        scale = b.abs().max().item()
        if n.endswith("TorchDense_2.bias"):
            w4 = grads[n[:-len("bias")] + "kernel"][1]
            scale = max(scale, w4.abs().max().item())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=n)


def test_remat_step_matches_jax_remat():
    """One MSMP-PDE step at unrolled 0 with ``mp_remat`` against the JAX
    ``Trainer.train_step_fn`` with ``MPSolver(mp_remat=True)`` (its layers
    under nn.remat): the loss and every gradient, float64, 1e-8."""
    jtr, params, trainer = _trainers(25, 100, "MSMP-PDE")
    jtr = dataclasses.replace(jtr, model=jtr.model.clone(mp_remat=True))
    trainer.model.mp_remat = True
    rng = np.random.default_rng(41)
    u = rng.normal(size=(4, 100, trainer.spec.nx))
    ib, st = rng.permutation(4)[:2], rng.integers(25, 76, size=2)
    tx = jtr.make_optimizer(1e-3, 0.4, [1, 2], 1)
    opt_state = tx.init(params)
    _, opt_state, jloss = jtr.train_step_fn(tx, 0)(
        params, opt_state, jnp.asarray(u), {}, jnp.asarray(ib),
        jnp.asarray(st))
    loss, grads = _step_grads(trainer, u, ib, st)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for (n, _), g in zip(trainer.model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), _leaf(opt_state[0].mu, n) / 0.1,
                                   err_msg=n, **TOL)


def test_unknown_precision_raises():
    """An unknown mode raises as _parse_mm does, from build_trainer, the
    registry and the ops; mp_remat takes float32 only."""
    with pytest.raises(ValueError, match="mp_precision"):
        build_trainer("E1", "MSMP-PDE", mp_precision="bogus", device="cpu",
                      n_graph_layers=1)
    with pytest.raises(ValueError, match="mp_precision"):
        get_model("FNO", tw=25, n_eq_vars=0, L=16.0, tmax=4.0, dt=0.1,
                  mp_precision="float16")
    with pytest.raises(ValueError, match="mp_precision"):
        mp_layer.mode_of("bf16")
    with pytest.raises(ValueError, match="mp_remat"):
        MPSolver(25, n_vars=1, mp_precision="bfloat16", mp_remat=True)
    for mode in ("float32",) + MODES:
        tr = build_trainer("E1", "MSMP-PDE", mp_precision=mode,
                           device="cpu", n_graph_layers=1)
        assert tr.model.mp_precision == mode


@pytest.mark.parametrize("name,mode", [("MSMP-PDE", "bfloat16s"),
                                       ("MP-PDE", "bfloat16")])
def test_chip_smoke_reference_is_the_plain_path(name, mode):
    """chip_smoke.reference_forward, the card's yardstick, in a bf16 mode:
    its forward and a loss's gradients (through ``plain_functions``, the
    plain versions' hand-written backward) are the model's own on CPU
    tensors."""
    from chip_smoke import reference_apply

    (window, pos_x, t, var_vec, idx, mask), p, y = _model_case(name, 3)
    m, _ = get_model(name, tw=25, n_eq_vars=0, L=L_, tmax=TMAX_, dt=DT_,
                     n_layers=MLAYERS, hidden=MH, mp_precision=mode)
    m.load_state_dict(params_from_flax(p), strict=True)
    ins = (T(window), T(pos_x), T(t), T(var_vec), torch.as_tensor(idx),
           T(mask))
    params = list(m.parameters())
    outs = [m(*ins)[0], reference_apply(m, ins[0], ins[1], ins[3], ins[4],
                                        ins[5])[0]]
    grads = [torch.autograd.grad(((o - T(y)) ** 2).sum(), params)
             for o in outs]
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
