"""Static graph construction and window ops (counterpart of
msmp_pde_tpu/data/graph.py).

Every (task, resolution) has one static neighbour structure: a dense
per-node list ``idx`` [nx, K] with ``mask`` [nx, K], built once on the host
and kept on the device for every request.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def build_neighbors_radius(x: np.ndarray, n_neighbors: int):
    """Dense neighbour list matching radius_graph(r = n*dx + 1e-4) on a
    uniform grid: j != i with |x_i - x_j| <= r, boundary nodes lose their
    out-of-range neighbours (not periodic). Returns (idx [nx, K] int32,
    mask [nx, K] float32), K = 2n; invalid slots point at node 0."""
    x = np.asarray(x, np.float64)
    nx = len(x)
    r = n_neighbors * (x[1] - x[0]) + 1e-4
    K = 2 * n_neighbors
    idx = np.zeros((nx, K), np.int32)
    mask = np.zeros((nx, K), np.float32)
    for i in range(nx):
        js = np.where((np.abs(x - x[i]) <= r) & (np.arange(nx) != i))[0]
        idx[i, : len(js)] = js
        mask[i, : len(js)] = 1.0
    return idx, mask


def build_neighbors_knn(points: np.ndarray, k: int):
    """Dense k-nearest-neighbour list (knn_graph's): node i's k nearest
    other nodes by squared distance, ties broken by ``np.argsort``'s order
    as the JAX package's numpy path breaks them. points: [nx] coordinates
    or [nx, d] embedded ones. Returns (idx [nx, k] int32, mask [nx, k]
    float32, all ones). The graph is not symmetric: a node's in-degree
    (how many lists hold it) ranges from 0 up past k."""
    pts = np.asarray(points, np.float64)
    if pts.ndim == 1:
        pts = pts[:, None]
    nx = pts.shape[0]
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k].astype(np.int32)
    return idx, np.ones((nx, k), np.float32)


def add_random_edges(idx: np.ndarray, mask: np.ndarray, p: float,
                     rng: np.random.Generator):
    """Erdos-Renyi in-edges: for each node i in order, ``rng.random(nx) <
    p`` draws candidates j, kept where j != i and j is not already one of
    i's valid neighbours. The lists grow by the most extra edges any node
    got, the new slots of the other nodes masked off (pointing at node
    0). Returns (idx, mask), unchanged where no edge was added."""
    nx_nodes = idx.shape[0]
    extra = [[] for _ in range(nx_nodes)]
    for i in range(nx_nodes):
        for j in np.where(rng.random(nx_nodes) < p)[0]:
            if j != i and j not in idx[i][mask[i] > 0]:
                extra[i].append(j)
    k_extra = max((len(e) for e in extra), default=0)
    if k_extra == 0:
        return idx, mask
    K = idx.shape[1] + k_extra
    idx2 = np.zeros((nx_nodes, K), np.int32)
    mask2 = np.zeros((nx_nodes, K), np.float32)
    idx2[:, : idx.shape[1]] = idx
    mask2[:, : idx.shape[1]] = mask
    for i, e in enumerate(extra):
        idx2[i, idx.shape[1]: idx.shape[1] + len(e)] = e
        mask2[i, idx.shape[1]: idx.shape[1] + len(e)] = 1.0
    return idx2, mask2


def cylindrical_coords(x: np.ndarray) -> np.ndarray:
    """The periodic embedding of an unstructured grid, [nx, 2]: (cos, sin)
    of theta = 2 pi x / (max x - 1e-3)."""
    theta = 2 * np.pi * x / (x.max() - 1e-3)
    return np.stack([np.cos(theta), np.sin(theta)], axis=1)


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static per-task graph structure and metadata, tensors on the
    device."""

    idx: torch.Tensor  # [nx, K] int64 neighbour indices
    mask: torch.Tensor  # [nx, K] validity
    x: torch.Tensor  # [nx] raw coordinates
    tw: int
    n_components: int
    t_grid: torch.Tensor  # [nt] output time grid
    L: float
    tmax: float
    dt: float

    @property
    def nx(self) -> int:
        return self.x.shape[0]


def build_graph_spec(pde, grid, n_neighbors: int, time_window: int,
                     device, random_edge_prob: float = 0.0,
                     rng: Optional[np.random.Generator] = None) -> GraphSpec:
    """The static graph of a (task, resolution): the k-NN graph of the
    Chebyshev grid for WE and of the unstructured AD grid (RPU, its
    ``cylindrical_coords``), k = ``n_neighbors``; the radius stencil for
    the uniform families (CE, KF, KS, and AD on its uniform grid). The
    k-NN lists are built from ``grid.x`` as float64, as the JAX package
    reads it: a dataset's x is float32, so the lists are those of the
    float32-rounded grid. ``random_edge_prob`` > 0 adds Erdos-Renyi edges
    (``add_random_edges``, from ``rng``, by default ``default_rng(0)``)."""
    family = f"{pde}"
    x = np.asarray(grid.x)
    if family == "WE":
        idx, mask = build_neighbors_knn(x.astype(np.float64), n_neighbors)
    elif getattr(pde, "unstructured_grid", False):
        idx, mask = build_neighbors_knn(
            cylindrical_coords(x.astype(np.float64)), n_neighbors)
    else:
        idx, mask = build_neighbors_radius(x, n_neighbors)
    if random_edge_prob > 0.0:
        idx, mask = add_random_edges(idx, mask, random_edge_prob,
                                     rng or np.random.default_rng(0))
    t_grid = np.linspace(grid.tmin, grid.tmax, grid.nt).astype(x.dtype)
    dev = torch.device(device)
    return GraphSpec(
        idx=torch.as_tensor(idx, dtype=torch.int64, device=dev),
        mask=torch.as_tensor(mask, device=dev),
        x=torch.as_tensor(x, device=dev),
        tw=time_window,
        n_components=grid.n_components,
        t_grid=torch.as_tensor(t_grid, device=dev),
        L=float(getattr(pde, "L", 16.0)),
        tmax=float(grid.tmax),
        dt=float(grid.dt),
    )


def slice_windows(u, steps, tw: int):
    """Batched temporal-bundling slice: u [B, nt, nx] or [B, nt, d, nx],
    steps [B] window end points -> (data [B, nx, d*tw] from [step-tw,
    step), labels [B, nx, d*tw] from [step, step+tw)). One gather for the
    batch, so the steps may stay on the device; a start clamps into
    [0, nt - tw], as ``jax.lax.dynamic_slice`` does."""
    B, nt = u.shape[:2]
    steps = torch.as_tensor(steps, device=u.device).long()
    ar = torch.arange(tw, device=u.device)

    def gather(ends):
        start = torch.clamp(ends - tw, 0, nt - tw)
        win = u[torch.arange(B, device=u.device)[:, None],
                start[:, None] + ar]  # [B, tw, (d,) nx]
        if u.ndim == 3:
            return win.transpose(1, 2)
        return win.permute(0, 3, 2, 1).reshape(B, u.shape[-1], -1)

    return gather(steps), gather(steps + tw)


def advance_windows(window, pred, n_components: int, tw: int):
    """Pushforward window advance: append the prediction, drop the oldest
    tw steps (per component)."""
    if n_components == 1:
        return torch.cat([window, pred], dim=-1)[..., tw:]
    B, nx, _ = window.shape
    w = window.reshape(B, nx, n_components, tw)
    p = pred.reshape(B, nx, n_components, tw)
    return torch.cat([w, p], dim=-1)[..., tw:].reshape(B, nx, -1)
