"""PyTorch port, the CUDA kernels against their plain versions on the card,
at the serving path's full-width shapes. Skipped without a card. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerances in float32: the LEM scan 1e-5 (FMA order only); the pair 1e-4
(FMA order, then InstanceNorm divides by a per-feature spread); the model
5e-4 (six pairs and the LEM compound the pair's rounding). Backward: the LEM
scan's per-row outputs rtol 5e-4, atol 1e-5, its weight gradients (sums over
T*N rows) atol 1e-5 * max|ref|; the pair's gradients and a training step's
parameter gradients the scale-aware max|diff| <= max(1e-3 max|ref|, 2e-4),
where b4's gradient, analytically zero and roundoff on both sides, takes
its layer's w4 gradient's scale (chip_smoke.scale_aware); a step's loss
relative 1e-4. The single-layer kernels take the pair's tolerances: the
forward 1e-4, the backward the scale-aware bound. Every kernel, forward and
backward, is bitwise repeatable.
"""
import numpy as np
import pytest
import torch

from msmp_pde_torch.data.graph import build_neighbors_radius
from msmp_pde_torch.models.gnn import GNNLayer
from msmp_pde_torch.ops import lem_scan, mp_layer, mp_pair
from msmp_pde_torch.serving.engine import build_serving_trainer
from msmp_pde_torch.training.setup import build_trainer

from _torch_helpers import cuda_device  # noqa: F401
from chip_smoke import (
    grad_scales,
    reference_forward,
    reference_step_loss,
    scale_aware,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rand(rng, dev, *shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32,
                        device=dev)


@pytest.mark.parametrize("N,H", [(100, 128), (400, 128), (1600, 128),
                                 (37, 128), (37, 96), (100, 96), (400, 96),
                                 (1600, 96)])
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
                                         (48, 100, 128, 1, 3),
                                         (2, 40, 96, 3, 2),
                                         (3, 37, 96, 2, 2)])
def test_pair_kernel_matches_plain(cuda_device, B, nx, H, V, n):
    """Bitwise repeatable; the last cases have a width that no 64-column
    tile divides and node counts no 32-row tile divides."""
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
        again = mp_pair.fused_gated_pair(*args)
        assert mp_pair.launches == before + 2
        want = mp_pair.fused_gated_pair_plain(*args)
    assert torch.equal(got, again)
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


@pytest.mark.parametrize("N,H", [(100, 128), (400, 128), (1600, 128),
                                 (37, 128), (37, 96), (100, 96), (400, 96),
                                 (1600, 96)])
def test_lem_stash_and_bwd_match_plain(cuda_device, N, H):
    rng = np.random.default_rng(100 + N)
    T = 25
    r = lambda *s, scale=1.0: _rand(rng, cuda_device, *s, scale=scale)
    args = (r(T, N, 3 * H), r(T, N, H), r(N, H, scale=.5), r(N, H, scale=.5),
            r(H, 3 * H, scale=H ** -.5), r(H, H, scale=H ** -.5))
    before = (lem_scan.launches, lem_scan.stash_launches)
    got = lem_scan.lem_scan_kernel(*args, stash=True)
    assert (lem_scan.launches, lem_scan.stash_launches) == (
        before[0] + 1, before[1] + 1)
    want = lem_scan.lem_scan_plain(*args, stash=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    cot = (r(N, H), r(N, H))
    before = lem_scan.bwd_launches
    got = lem_scan.lem_scan_bwd_kernel(*args, *want[2:], *cot)
    assert lem_scan.bwd_launches == before + 1
    want = lem_scan.lem_scan_bwd_plain(*args, *want[2:], *cot)
    for k, (a, b) in enumerate(zip(got, want)):
        atol = 1e-5 * (b.abs().max().item() if k >= 4 else 1.0)
        torch.testing.assert_close(a, b, rtol=5e-4, atol=atol)


@pytest.mark.parametrize("N,H", [(37, 96), (100, 128), (1600, 128)])
def test_lem_kernels_bitwise_repeatable(cuda_device, N, H):
    """Two launches of each LEM kernel give bitwise equal outputs (no
    atomics; the cluster sums its partials in rank order), and the stash
    variant's yT, zT are bitwise the no-stash variant's."""
    rng = np.random.default_rng(200 + N)
    T = 25
    r = lambda *s, scale=1.0: _rand(rng, cuda_device, *s, scale=scale)
    args = (r(T, N, 3 * H), r(T, N, H), r(N, H, scale=.5), r(N, H, scale=.5),
            r(H, 3 * H, scale=H ** -.5), r(H, H, scale=H ** -.5))
    fwd = [lem_scan.lem_scan_kernel(*args) for _ in range(2)]
    stash = [lem_scan.lem_scan_kernel(*args, stash=True) for _ in range(2)]
    cot = (r(N, H), r(N, H))
    bwd = [lem_scan.lem_scan_bwd_kernel(*args, *stash[0][2:], *cot)
           for _ in range(2)]
    for one, two in (fwd, stash, bwd):
        for a, b in zip(one, two):
            assert torch.equal(a, b)
    for a, b in zip(fwd[0], stash[0][:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,nx,H,V,n", [(1, 100, 128, 1, 3),
                                         (4, 100, 128, 1, 3),
                                         (16, 100, 128, 1, 3),
                                         (48, 100, 128, 1, 3),
                                         (2, 40, 96, 3, 2),
                                         (3, 37, 96, 2, 2)])
def test_pair_bwd_kernel_matches_plain(cuda_device, B, nx, H, V, n):
    """Bitwise repeatable; batch 48 calls the fused kernel directly (the
    model takes the fallback there); the last cases have a width that no
    64-column tile divides and node counts no 32-row tile divides."""
    rng = np.random.default_rng(200 + B)
    D = 25
    idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, nx), n)
    g = torch.Generator().manual_seed(B)
    W = [tuple(w.detach() for w in GNNLayer(H, D, V, g).to(cuda_device)
               .weights()) for _ in "gl"]
    r = lambda *s: _rand(rng, cuda_device, *s)
    args = (r(B, nx, H), r(B, nx, D), r(B, nx, 1), r(B, nx, V),
            torch.as_tensor(idx, device=cuda_device),
            torch.as_tensor(mask, device=cuda_device), *W, r(B, nx, H))
    before = mp_pair.bwd_launches
    flat = lambda res: [res[0], *res[1], *res[2]]
    got = flat(mp_pair.fused_gated_pair_bwd_kernel(*args))
    again = flat(mp_pair.fused_gated_pair_bwd_kernel(*args))
    assert mp_pair.bwd_launches == before + 2
    want = flat(mp_pair.fused_gated_pair_bwd_plain(*args))
    for k, (a, b, c) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b), k
        # outputs 12 and 24 are the layers' b4, 11 and 23 their w4
        scale = want[k - 1].abs().max().item() if k % 12 == 0 else None
        assert scale_aware(a, c, scale)[0], (k, scale_aware(a, c, scale))


def _train_batch(trainer, B, unrolled, seed):
    rng = np.random.default_rng(seed)
    dev = trainer.device
    u_all = torch.tensor(rng.normal(size=(B, 250, 100)), dtype=torch.float32,
                         device=dev)
    steps = torch.as_tensor(
        rng.integers(25, 250 - 25 * (unrolled + 1) + 1, B), device=dev)
    return u_all, torch.arange(B, device=dev), steps


def test_every_parameter_gets_a_gradient(cuda_device):
    """The kernels' outputs carry a grad_fn: one backward on the kernel
    path reaches every parameter of MPSolver."""
    trainer = build_trainer("E1", "MSMP-PDE", device=cuda_device)
    u_all, idx, steps = _train_batch(trainer, 4, 0, 0)
    before = (lem_scan.bwd_launches, mp_pair.bwd_launches)
    trainer.step_loss(u_all, {}, idx, steps, 0).backward()
    assert (lem_scan.bwd_launches, mp_pair.bwd_launches) == (
        before[0] + 1, before[1] + 6)
    for name, p in trainer.model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name


@pytest.mark.parametrize("unrolled", [0, 1])
def test_train_step_kernel_path_matches_plain_path(cuda_device, unrolled):
    trainer = build_trainer("E1", "MSMP-PDE", device=cuda_device)
    params = list(trainer.model.parameters())
    batch = _train_batch(trainer, 4, unrolled, 1 + unrolled)
    loss_k = trainer.step_loss(*batch[:1], {}, *batch[1:], unrolled)
    grads_k = torch.autograd.grad(loss_k, params)
    loss_p = reference_step_loss(trainer, batch[0], *batch[1:], unrolled)
    grads_p = torch.autograd.grad(loss_p, params)
    assert abs(loss_k.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
    names = [n for n, _ in trainer.model.named_parameters()]
    scales = grad_scales(zip(names, grads_p))
    for name, a, b in zip(names, grads_k, grads_p):
        ok, err = scale_aware(a, b, scales[name])
        assert ok, (name, err, scales[name])


LAYER_CASES = [(B, 100, 128, 1, 3, fa) for B in (1, 4, 16, 48)
               for fa in (True, False)]
LAYER_CASES += [(2, 40, 96, 3, 2, fa) for fa in (True, False)]
LAYER_CASES += [(3, 37, 96, 2, 2, fa) for fa in (True, False)]


def _layer_args(dev, B, nx, H, V, n, switch, seed):
    rng = np.random.default_rng(seed)
    D = 25
    idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, nx), n)
    g = torch.Generator().manual_seed(seed)
    W = tuple(w.detach() for w in GNNLayer(H, D, V, g, switch, switch)
              .to(dev).weights())
    r = lambda *s: _rand(rng, dev, *s)
    return (r(B, nx, H), r(B, nx, D), r(B, nx, 1), r(B, nx, V),
            torch.as_tensor(idx, device=dev),
            torch.as_tensor(mask, device=dev), W)


@pytest.mark.parametrize("B,nx,H,V,n,switch", LAYER_CASES)
def test_layer_kernels_match_plain(cuda_device, B, nx, H, V, n, switch):
    """final_act = residual = switch; the last cases have a width that no
    64-column tile divides."""
    args = _layer_args(cuda_device, B, nx, H, V, n, switch, 300 + B)
    before = (mp_layer.launches, mp_layer.bwd_launches)
    got = mp_layer.fused_mp_layer_kernel(*args, switch, switch)
    assert torch.equal(got, mp_layer.fused_mp_layer_kernel(*args, switch,
                                                           switch))
    want = mp_layer.fused_mp_layer_plain(*args, switch, switch)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    g = _rand(np.random.default_rng(B), cuda_device, *got.shape)
    flat = lambda res: [res[0], *res[1]]
    k1 = flat(mp_layer.fused_mp_layer_bwd_kernel(*args, g, switch, switch))
    k2 = flat(mp_layer.fused_mp_layer_bwd_kernel(*args, g, switch, switch))
    p = flat(mp_layer.fused_mp_layer_bwd_plain(*args, g, switch, switch))
    assert (mp_layer.launches, mp_layer.bwd_launches) == (
        before[0] + 2, before[1] + 2)
    for k, (a, b, c) in enumerate(zip(k1, k2, p)):
        assert torch.equal(a, b), k
        # without final_act, b4's gradient (output 12) is roundoff only
        scale = p[11].abs().max().item() if k == 12 and not switch else None
        assert scale_aware(a, c, scale)[0], (k, scale_aware(a, c, scale))


@pytest.mark.parametrize("name,final_act", [("mp_pair_bwd", False),
                                            ("mp_layer_bwd", True),
                                            ("mp_layer_bwd", False)])
def test_bwd_cooperative_grid_fills_every_sm(cuda_device, name, final_act):
    """The backwards launch as many blocks as fit on every SM at once."""
    n = mp_layer.grid_blocks(name, final_act)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert n >= sms and n % sms == 0, (n, sms)


@pytest.mark.parametrize("name,variant", [("mp_pair_fwd", False),
                                          ("mp_pair_fwd", True),
                                          ("mp_layer_fwd", True),
                                          ("mp_layer_fwd", False)])
def test_fwd_cooperative_grid_fills_every_sm(cuda_device, name, variant):
    """The forwards (the pair's with and without the stash, the layer's
    GNN_Layer and GNN_LayerLin) launch as many blocks as fit on every SM at
    once, whatever the batch."""
    n = mp_layer.grid_blocks(name, variant)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert n >= sms and n % sms == 0, (n, sms)


@pytest.mark.parametrize("B", [1, 4, 16, 48])
def test_pair_stash_matches_no_stash(cuda_device, B):
    args = _layer_args(cuda_device, B, 100, 128, 1, 3, False, 400 + B)
    Wl = _layer_args(cuda_device, B, 100, 128, 1, 3, False, 500 + B)[-1]
    args = args + (Wl,)
    before = (mp_pair.launches, mp_pair.stash_launches)
    out, gn, ln = mp_pair.fused_gated_pair_kernel(*args, stash=True)
    assert torch.equal(out, mp_pair.fused_gated_pair_kernel(*args))
    assert (mp_pair.launches, mp_pair.stash_launches) == (
        before[0] + 2, before[1] + 1)
    torch.testing.assert_close(
        gn, mp_layer.fused_mp_layer_plain(*args[:6], args[6]), rtol=1e-4,
        atol=1e-4)
    torch.testing.assert_close(
        ln, mp_layer.fused_mp_layer_plain(*args[:6], args[7]), rtol=1e-4,
        atol=1e-4)


def test_pair_fallback_route_at_batch_48(cuda_device, monkeypatch):
    """Batch 48 takes the fused backward (its workspace fits); the fallback,
    forced as the CPU tests force it, runs one stash forward, two
    single-layer backwards and no fused backward, and its gradients hold
    against the fused plain backward."""
    args = _layer_args(cuda_device, 48, 100, 128, 1, 3, False, 600)
    Wl = _layer_args(cuda_device, 48, 100, 128, 1, 3, False, 601)[-1]
    h, u, px, v, idx, mask, Wg = args
    K = idx.shape[1]
    for B in (16, 48):
        assert mp_pair.pair_bwd_fused_fits(B, 100, 128, 25, 1, K, cuda_device)
    monkeypatch.setattr(mp_pair, "pair_bwd_fused_fits", lambda *a, **k: False)
    g = _rand(np.random.default_rng(48), cuda_device, *h.shape)
    hg = h.clone().requires_grad_()
    ws = [w.clone().requires_grad_() for w in Wg + Wl]
    before = (mp_pair.launches, mp_pair.stash_launches, mp_pair.bwd_launches,
              mp_layer.bwd_launches)
    out = mp_pair.fused_gated_pair(hg, u, px, v, idx, mask, ws[:12], ws[12:])
    got = torch.autograd.grad(out, [hg] + ws, g)
    after = (mp_pair.launches, mp_pair.stash_launches, mp_pair.bwd_launches,
             mp_layer.bwd_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 2)
    dh, dwg, dwl = mp_pair.fused_gated_pair_bwd_plain(*args, Wl, g)
    want = [dh, *dwg, *dwl]
    for k, (a, b) in enumerate(zip(got, want)):
        scale = want[k - 1].abs().max().item() if k % 12 == 0 and k else None
        assert scale_aware(a, b, scale)[0], (k, scale_aware(a, b, scale))


@pytest.mark.parametrize("name", ["MP-PDE", "LEM"])
def test_ungated_model_kernel_path_matches_plain_path(cuda_device, name):
    trainer = build_serving_trainer("E1", name, device=cuda_device)
    rng = np.random.default_rng(1)
    window = _rand(rng, cuda_device, 4, 100, 25)
    steps = torch.full((4,), 25, device=cuda_device)
    spec = trainer.spec
    before = mp_layer.launches
    with torch.no_grad():
        got, _ = trainer.forward(window, steps, {})
        want = reference_forward(
            trainer.model, window, spec.x.expand(4, spec.nx),
            trainer.graph_vars(spec.t_grid[steps], {}), spec.idx, spec.mask)
    assert mp_layer.launches == before + 6
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


def test_mp_pde_every_parameter_gets_a_gradient(cuda_device):
    trainer = build_trainer("E1", "MP-PDE", device=cuda_device)
    u_all, idx, steps = _train_batch(trainer, 4, 0, 5)
    before = (mp_layer.launches, mp_layer.bwd_launches)
    trainer.step_loss(u_all, {}, idx, steps, 0).backward()
    assert (mp_layer.launches, mp_layer.bwd_launches) == (
        before[0] + 6, before[1] + 6)
    for name, p in trainer.model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
