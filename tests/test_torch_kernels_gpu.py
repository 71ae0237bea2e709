"""PyTorch port, the CUDA kernels against their plain versions on the card,
at the serving path's full-width shapes. Skipped without a card. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerances in float32: the LEM scan 1e-5 (FMA order only); the pair 1e-4
(FMA order, then InstanceNorm divides by a per-feature spread); the model
5e-4 (six pairs and the LEM compound the pair's rounding).
"""
import numpy as np
import pytest
import torch

from msmp_pde_torch.data.graph import build_neighbors_radius
from msmp_pde_torch.models.gnn import GNNLayer
from msmp_pde_torch.ops import lem_scan, mp_pair
from msmp_pde_torch.serving.engine import build_serving_trainer

from _torch_helpers import cuda_device  # noqa: F401
from chip_smoke import reference_forward

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rand(rng, dev, *shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32,
                        device=dev)


@pytest.mark.parametrize("N,H", [(100, 128), (400, 128), (1600, 128),
                                 (37, 128), (37, 96)])
def test_lem_kernel_matches_plain(cuda_device, N, H):
    rng = np.random.default_rng(N)
    T = 25
    r = lambda *s, scale=1.0: _rand(rng, cuda_device, *s, scale=scale)
    args = (r(T, N, 3 * H), r(T, N, H), r(N, H, scale=.5), r(N, H, scale=.5),
            r(H, 3 * H, scale=H ** -.5), r(H, H, scale=H ** -.5))
    before = lem_scan.launches
    yk, zk = lem_scan.lem_scan(*args)
    assert lem_scan.launches == before + 1
    yp, zp = lem_scan.lem_scan_plain(*args)
    torch.testing.assert_close(yk, yp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(zk, zp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,nx,H,V,n", [(1, 100, 128, 1, 3),
                                         (4, 100, 128, 1, 3),
                                         (16, 100, 128, 1, 3),
                                         (2, 40, 96, 3, 2)])
def test_pair_kernel_matches_plain(cuda_device, B, nx, H, V, n):
    """The last case has a width that no 64-column tile divides."""
    rng = np.random.default_rng(B)
    D = 25
    idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, nx), n)
    g = torch.Generator().manual_seed(B)
    mg = GNNLayer(H, D, V, g).to(cuda_device)
    ml = GNNLayer(H, D, V, g).to(cuda_device)
    r = lambda *s: _rand(rng, cuda_device, *s)
    args = (r(B, nx, H), r(B, nx, D), r(B, nx, 1), r(B, nx, V),
            torch.as_tensor(idx, device=cuda_device),
            torch.as_tensor(mask, device=cuda_device),
            mg.weights(), ml.weights())
    with torch.no_grad():
        before = mp_pair.launches
        got = mp_pair.fused_gated_pair(*args)
        assert mp_pair.launches == before + 1
        want = mp_pair.fused_gated_pair_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_model_kernel_path_matches_plain_path(cuda_device):
    trainer = build_serving_trainer("E1", "MSMP-PDE", device=cuda_device)
    rng = np.random.default_rng(0)
    window = _rand(rng, cuda_device, 4, 100, 25)
    steps = torch.full((4,), 25, device=cuda_device)
    spec = trainer.spec
    with torch.no_grad():
        got, _ = trainer.forward(window, steps, {})
        want = reference_forward(
            trainer.model, window, spec.x.expand(4, spec.nx),
            trainer.graph_vars(spec.t_grid[steps], {}), spec.idx, spec.mask)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
