"""PyTorch port, the fused gated pair (ops/mp_pair.py) and the layer module
(models/gnn.py::GNNLayer) against the JAX package on the same numpy inputs
and weights, on a stencil graph whose boundary nodes have truncated masks
on the wave equation's k-NN graph (K = 3, unequal in-degrees) and on
RPU's (nodes of in-degree 0).

* against the XLA path (gate layer, main layer, combine; gnn.py:375-385)
  in float64: 1e-10, only summation order differs;
* against ``fused_gated_pair(..., interpret=True)``: its products
  accumulate in float32 (mp_pallas.py:90) and ``edge_matrices`` is float32,
  so the port runs in float32 and the bound is 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.data.graph import build_neighbors_knn, build_neighbors_radius
from msmp_pde_tpu.equations.we import cheb_grid_ascending
from msmp_pde_tpu.models.common import swish as jswish
from msmp_pde_tpu.models.gnn import GNNLayer as JLayer
from msmp_pde_tpu.ops.mp_pallas import edge_matrices, fused_gated_pair
from msmp_pde_torch.models.gnn import GNNLayer
from msmp_pde_torch.ops import mp_pair

from _torch_helpers import np_tree, tt
from test_torch_mp_layer import rpu_graph


def _inputs(nx, B, H, dtw, V, n, seed):
    """n: the radius stencil's neighbours a side, or "knn<K>" for the wave
    equation's K-nearest-neighbour graph on its Chebyshev grid."""
    rng = np.random.default_rng(seed)
    if n == "knn_rpu":
        idx, mask = rpu_graph(nx)
    elif isinstance(n, str):
        x = cheb_grid_ascending(-8.0, 8.0, nx).astype(np.float32)
        idx, mask = build_neighbors_knn(x.astype(np.float64), int(n[3:]))
        deg = np.bincount(idx.ravel(), minlength=nx)
        assert deg.min() < idx.shape[1] < deg.max()  # unequal in-degrees
    else:
        idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, nx), n)
        assert mask.min() == 0.0  # boundary truncation is exercised
    h = rng.normal(size=(B, nx, H))
    u = rng.normal(size=(B, nx, dtw))
    px = rng.uniform(size=(B, nx))
    v = rng.normal(size=(B, nx, V))
    return h, u, px, v, idx, mask


def _jax_layer_params(h, u, px, v, idx, mask, seed):
    f = lambda a: jnp.asarray(a, jnp.float32)
    layer = JLayer(hidden=h.shape[-1], final_act=False, residual=False)
    return layer, layer.init(jax.random.PRNGKey(seed), f(h), f(u), f(px),
                             f(v), jnp.asarray(idx), f(mask))


def _port_layer(p, H, dtw, V, dtype):
    m = GNNLayer(H, dtw, V, torch.Generator())
    m.load_state_dict({
        ".".join((mod, name)): torch.as_tensor(a)
        for mod, leaves in np_tree(p["params"]).items()
        for name, a in leaves.items()})
    return m.to(dtype)


# the third case has the 2-D models' window and variables: D = 2 tw = 50,
# V = 3 (t, a, b); the fourth WE3's: the k-NN graph (K = 3) of a Chebyshev
# grid, tw = 25, V = 3 (t, bc_left, bc_right); the fifth RPU's: its k-NN
# graph on the LCG grid, with nodes of in-degree 0, D = 50, V = 3
CASES = [(24, 3, 32, 10, 2, 2), (40, 2, 96, 25, 1, 3), (24, 2, 32, 50, 3, 3),
         (24, 2, 32, 25, 3, "knn3"), (40, 2, 32, 50, 3, "knn_rpu")]


@pytest.mark.parametrize("nx,B,H,dtw,V,n", CASES)
def test_layer_matches_xla_f64(nx, B, H, dtw, V, n):
    h, u, px, v, idx, mask = _inputs(nx, B, H, dtw, V, n, 0)
    layer, p = _jax_layer_params(h, u, px, v, idx, mask, 0)
    want = layer.apply(np_tree(p), *map(jnp.asarray, (h, u, px, v)),
                       jnp.asarray(idx), jnp.asarray(mask, jnp.float64))
    m = _port_layer(p, H, dtw, V, torch.float64)
    got = m(tt(h), tt(u), tt(px), tt(v), torch.as_tensor(idx), tt(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("nx,B,H,dtw,V,n", CASES)
def test_pair_matches_xla_f64(nx, B, H, dtw, V, n):
    h, u, px, v, idx, mask = _inputs(nx, B, H, dtw, V, n, 1)
    layer, pg = _jax_layer_params(h, u, px, v, idx, mask, 1)
    _, pl = _jax_layer_params(h, u, px, v, idx, mask, 2)
    J = lambda a: jnp.asarray(a, jnp.float64)
    jargs = (J(h), J(u), J(px), J(v), jnp.asarray(idx), J(mask))
    tau = jax.nn.sigmoid(layer.apply(np_tree(pg), *jargs))
    ln = layer.apply(np_tree(pl), *jargs)
    want = (1.0 - tau) * J(h) + tau * jswish(ln)

    mg = _port_layer(pg, H, dtw, V, torch.float64)
    ml = _port_layer(pl, H, dtw, V, torch.float64)
    with torch.no_grad():
        got = mp_pair.fused_gated_pair(
            tt(h), tt(u), tt(px)[..., None], tt(v), torch.as_tensor(idx),
            tt(mask), mg.weights(), ml.weights())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("nx,B,H,dtw,V,n", CASES)
def test_pair_matches_pallas_interpret_f32(nx, B, H, dtw, V, n):
    h, u, px, v, idx, mask = _inputs(nx, B, H, dtw, V, n, 3)
    layer, pg = _jax_layer_params(h, u, px, v, idx, mask, 3)
    _, pl = _jax_layer_params(h, u, px, v, idx, mask, 4)
    mg = _port_layer(pg, H, dtw, V, torch.float32)
    ml = _port_layer(pl, H, dtw, V, torch.float32)
    Wg = tuple(w.detach().numpy() for w in mg.weights())
    Wl = tuple(w.detach().numpy() for w in ml.weights())
    F = lambda a: jnp.asarray(a, jnp.float32)
    want = fused_gated_pair(
        F(h), F(u), F(px)[..., None], F(v),
        edge_matrices(jnp.asarray(idx), F(mask)),
        tuple(map(F, Wg)), tuple(map(F, Wl)), interpret=True)
    T = lambda a: tt(a, torch.float32)
    before = mp_pair.launches
    with torch.no_grad():
        got = mp_pair.fused_gated_pair(
            T(h), T(u), T(px)[..., None], T(v), torch.as_tensor(idx),
            T(mask), mg.weights(), ml.weights())
    assert mp_pair.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_kernel_rejects_cpu_tensors():
    """The kernel entry point never falls back to the plain version."""
    h, u, px, v, idx, mask = _inputs(24, 1, 32, 10, 1, 2, 5)
    m = GNNLayer(32, 10, 1, torch.Generator())
    T = lambda a: tt(a, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        mp_pair.fused_gated_pair_kernel(
            T(h), T(u), T(px)[..., None], T(v), torch.as_tensor(idx),
            T(mask), m.weights(), m.weights())

