"""PyTorch port, the single message-passing layer's forward
(ops/mp_layer.py through models/gnn.py::GNNLayer) against the JAX
``GNNLayer`` on the same numpy inputs and weights, for both switch pairs
(GNN_Layer: final swish and residual; GNN_LayerLin: neither), on a stencil
graph with truncated boundary masks, on a kNN graph, as
tests/test_mp_pallas.py:35-46 does for the JAX kernel, on the wave
equation's K = 3 kNN graph of a Chebyshev grid (unequal in-degrees), and
on RPU's K = 3 kNN graph of its LCG grid at nx 40 (nodes of in-degree 0).

* against ``ega`` in interpret mode, which runs ``_fwd_kernel``: its
  products accumulate in float32 and ``edge_matrices`` is float32, so the
  port runs in float32 and the bound is 2e-5;
* against the XLA path in float64: 1e-10, only summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.data.graph import (
    build_neighbors_knn,
    build_neighbors_radius,
    cylindrical_coords,
)
from msmp_pde_tpu.datagen.ics import pseudo_random_grid
from msmp_pde_tpu.equations.we import cheb_grid_ascending
from msmp_pde_tpu.models.gnn import GNNLayer as JLayer
from msmp_pde_tpu.ops.mp_pallas import edge_matrices
from msmp_pde_torch.models.gnn import GNNLayer
from msmp_pde_torch.ops import mp_layer

from _torch_helpers import np_tree, tt

NX, B, H, DTW, V = 24, 3, 32, 10, 2
RPU_NX = 40  # RPU's graph has nodes of in-degree 0 from nx 30 up
SWITCHES = [(True, True), (False, False)]
# the 2-D models' window and variables: D = 2 tw = 50, V = 3 (t, a, b)
DTW_2D, V_2D = 50, 3


def rpu_graph(nx):
    """RPU's k-NN graph (K = 3) on the cylindrical coordinates of its LCG
    grid, float32-rounded as the dataset holds it; at least one node has
    in-degree 0 (an empty inverse list)."""
    x = pseudo_random_grid(0.0, 16.0, nx).astype(np.float32)
    idx, mask = build_neighbors_knn(cylindrical_coords(x.astype(np.float64)),
                                    3)
    deg = np.bincount(np.asarray(idx).ravel(), minlength=nx)
    assert deg.min() == 0 and deg.max() > 3
    return idx, mask


def layer_case(graph, final_act, residual, seed, dtype, DTW=DTW, V=V):
    """(numpy inputs h, u, px, v, idx, mask; the JAX layer; its flax params
    drawn in float32; the port's GNNLayer with the same weights), the
    window DTW wide with V variables."""
    rng = np.random.default_rng(seed)
    nx = RPU_NX if graph == "knn_rpu" else NX
    x = np.linspace(0.0, 16.0, nx)
    if graph == "radius":
        idx, mask = build_neighbors_radius(x, 2)
        assert mask.min() == 0.0  # boundary truncation is exercised
    elif graph == "knn_cheb":  # the wave equation's graph, K = 3
        xc = cheb_grid_ascending(-8.0, 8.0, NX).astype(np.float32)
        idx, mask = build_neighbors_knn(xc.astype(np.float64), 3)
    elif graph == "knn_rpu":  # RPU's graph: nodes of in-degree 0
        idx, mask = rpu_graph(nx)
    else:
        idx, mask = build_neighbors_knn(cylindrical_coords(x), 3)
    idx, mask = np.asarray(idx), np.asarray(mask)
    h = rng.normal(size=(B, nx, H))
    u = rng.normal(size=(B, nx, DTW))
    px = rng.uniform(size=(B, nx))
    v = rng.normal(size=(B, nx, V))
    layer = JLayer(hidden=H, final_act=final_act, residual=residual)
    f = lambda a: jnp.asarray(a, jnp.float32)
    p = layer.init(jax.random.PRNGKey(seed), f(h), f(u), f(px), f(v),
                   jnp.asarray(idx), f(mask))
    m = GNNLayer(H, DTW, V, torch.Generator(), final_act, residual)
    m.load_state_dict({
        ".".join((mod, name)): torch.as_tensor(a)
        for mod, leaves in np_tree(p["params"]).items()
        for name, a in leaves.items()})
    return (h, u, px, v, idx, mask), layer, p, m.to(dtype)


def _port(m, arrays, dtype):
    h, u, px, v, idx, mask = arrays
    T = lambda a: tt(a, dtype)
    before = mp_layer.launches
    with torch.no_grad():
        got = m(T(h), T(u), T(px), T(v), torch.as_tensor(idx), T(mask))
    assert mp_layer.launches == before  # CPU tensors take the plain version
    return got.numpy()


@pytest.mark.parametrize("graph", ["radius", "knn", "knn_cheb", "knn_rpu"])
@pytest.mark.parametrize("final_act,residual", SWITCHES)
def test_layer_matches_pallas_interpret_f32(graph, final_act, residual):
    arrays, layer, p, m = layer_case(graph, final_act, residual, 1,
                                     torch.float32)
    h, u, px, v, idx, mask = arrays
    F = lambda a: jnp.asarray(a, jnp.float32)
    ega = (edge_matrices(jnp.asarray(idx), F(mask)), True, "float32")
    want = layer.apply(p, F(h), F(u), F(px), F(v), jnp.asarray(idx),
                       F(mask), ega=ega)
    np.testing.assert_allclose(_port(m, arrays, torch.float32), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("graph", ["radius", "knn", "knn_cheb", "knn_rpu"])
@pytest.mark.parametrize("final_act,residual", SWITCHES)
def test_layer_matches_xla_f64(graph, final_act, residual):
    arrays, layer, p, m = layer_case(graph, final_act, residual, 2,
                                     torch.float64)
    h, u, px, v, idx, mask = arrays
    want = layer.apply(np_tree(p), *map(jnp.asarray, (h, u, px, v, idx,
                                                      mask)))
    np.testing.assert_allclose(_port(m, arrays, torch.float64), want,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("final_act,residual", SWITCHES)
def test_layer_d50_v3_matches_pallas_interpret_f32(final_act, residual):
    """The 2-D models' widths through the JAX kernel in interpret mode."""
    arrays, layer, p, m = layer_case("radius", final_act, residual, 5,
                                     torch.float32, DTW_2D, V_2D)
    h, u, px, v, idx, mask = arrays
    F = lambda a: jnp.asarray(a, jnp.float32)
    ega = (edge_matrices(jnp.asarray(idx), F(mask)), True, "float32")
    want = layer.apply(p, F(h), F(u), F(px), F(v), jnp.asarray(idx),
                       F(mask), ega=ega)
    np.testing.assert_allclose(_port(m, arrays, torch.float32), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("final_act,residual", SWITCHES)
def test_layer_d50_v3_matches_xla_f64(final_act, residual):
    arrays, layer, p, m = layer_case("radius", final_act, residual, 6,
                                     torch.float64, DTW_2D, V_2D)
    want = layer.apply(np_tree(p), *map(jnp.asarray, arrays))
    np.testing.assert_allclose(_port(m, arrays, torch.float64), want,
                               rtol=1e-10, atol=1e-10)


def test_kernel_rejects_cpu_tensors():
    """The kernel entry point never falls back to the plain version."""
    arrays, _, _, m = layer_case("radius", True, True, 3, torch.float32)
    h, u, px, v, idx, mask = (tt(a, torch.float32) for a in arrays)
    with pytest.raises(ValueError, match="CUDA"):
        mp_layer.fused_mp_layer_kernel(h, u, px[..., None], v, idx.long(),
                                       mask, m.weights(), True, True)


def test_no_grad_skips_the_function():
    """Without grad the layer returns a plain tensor (no saved inputs);
    with grad it goes through ``FusedMPLayer``."""
    arrays, _, _, m = layer_case("radius", True, True, 4, torch.float64)
    h, u, px, v, idx, mask = (tt(a) for a in arrays)
    args = (h, u, px, v, idx.long(), mask)
    with torch.no_grad():
        assert m(*args).grad_fn is None
    assert type(m(*args).grad_fn).__name__ == "FusedMPLayerBackward"


@pytest.mark.parametrize("kernel", ["fused_mp_layer_kernel",
                                    "fused_mp_layer_bwd_kernel"])
def test_kernels_take_gnn_layer_or_layerlin(kernel):
    """The kernels are built for both switches or neither; a mixed pair is
    refused before anything is launched."""
    arrays, _, _, m = layer_case("radius", True, True, 5, torch.float32)
    h, u, px, v, idx, mask = (tt(a, torch.float32) for a in arrays)
    args = (h, u, px[..., None], v, idx.long(), mask, m.weights())
    if kernel == "fused_mp_layer_bwd_kernel":
        args += (h,)
    with pytest.raises(ValueError, match="must be equal"):
        getattr(mp_layer, kernel)(*args, True, False)
