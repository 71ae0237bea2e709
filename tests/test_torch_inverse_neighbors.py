"""PyTorch port, the inverse neighbour list (ops/mp_layer.py::
inverse_neighbors) that the backward kernels gather ds_j through.

* every valid edge appears exactly once, under its target, in increasing
  edge order; masked slots appear in no node's list;
* the gather-sum of dm0 through (rev_ptr, rev_e) equals the index_add_
  scatter of ``_layer_backward`` (ops/mp_layer.py) exactly in float64: the
  same terms, added in the same increasing edge order.
"""
import numpy as np
import pytest
import torch

from msmp_pde_torch.data.graph import build_neighbors_radius
from msmp_pde_torch.ops.mp_layer import inverse_neighbors


def _graph(kind):
    if kind == "e1_radius":  # E1: nx = 100, 3 neighbours a side
        return build_neighbors_radius(np.linspace(0.0, 16.0, 100), 3)
    if kind == "radius_37":
        return build_neighbors_radius(np.linspace(0.0, 16.0, 37), 2)
    rng = np.random.default_rng(7)  # random targets, a third masked
    idx = rng.integers(0, 23, size=(23, 5)).astype(np.int32)
    mask = (rng.random((23, 5)) > 1 / 3).astype(np.float32)
    return idx, mask


@pytest.mark.parametrize("kind", ["e1_radius", "radius_37", "random_masked"])
def test_inverse_list_matches_the_scatter(kind):
    idx_np, mask_np = _graph(kind)
    nx, K = idx_np.shape
    idx, mask = torch.as_tensor(idx_np), torch.as_tensor(mask_np)
    rev_ptr, rev_e = inverse_neighbors(idx, mask)
    assert rev_ptr.dtype == rev_e.dtype == torch.int32
    assert rev_ptr.shape == (nx + 1,) and rev_e.shape == (nx * K,)
    ptr, rev = rev_ptr.numpy(), rev_e.numpy()
    assert ptr[0] == 0 and (np.diff(ptr) >= 0).all()
    valid = np.flatnonzero(mask_np.reshape(-1) != 0)
    assert ptr[-1] == len(valid)
    seen = []
    for n in range(nx):
        edges = rev[ptr[n]:ptr[n + 1]]
        assert (np.diff(edges) > 0).all(), n  # increasing edge order
        assert (idx_np.reshape(-1)[edges] == n).all(), n
        seen += edges.tolist()
    assert sorted(seen) == valid.tolist()  # each valid edge exactly once
    assert sorted(rev.tolist()) == list(range(nx * K))  # a permutation

    B, H = 3, 8
    dm0 = torch.as_tensor(
        np.random.default_rng(1).normal(size=(B, nx, K, H)))
    want = torch.zeros(B, nx, H, dtype=torch.float64).index_add_(
        1, idx.reshape(-1).long(),
        (dm0 * mask.double()[None, :, :, None]).reshape(B, nx * K, H))
    flat = dm0.reshape(B, nx * K, H)
    m = mask.reshape(-1).double()
    got = torch.zeros_like(want)
    for n in range(nx):
        for e in rev[ptr[n]:ptr[n + 1]]:
            got[:, n] += flat[:, e] * m[e]
    assert torch.equal(got, want)
