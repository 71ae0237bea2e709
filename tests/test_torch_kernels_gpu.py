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
backward, is bitwise repeatable. The 2-D models' cases (the ``_d50``
tests) feed the message-passing kernels a window of D = 2 tw = 50 and
V = 3 variables (t, a, b) and hold them to the same tolerances. The wave
equation's cases (the ``_knn`` tests) run them on its k-NN graph, K = 3 on
the Chebyshev grid of 100, where in-degrees range from 2 to 5 (the
backward gathers ds_j through the inverse list), at D = 25 with V = 1 (t:
WE1, WE2, KS) and V = 3 (t and WE3's bc_left, bc_right; KF's r, D), and
the same tolerances; and the models' forward and step on WE3's grid. RPU's
cases (the ``_knn_rpu`` tests, selected by ``-k knn`` too) run them on its
k-NN graph, K = 3 on the cylindrical coordinates of the LCG grid of 100,
where in-degrees range from 0 to 6 (nodes that send no message: their
inverse lists are empty), at the 2-D models' D = 50, V = 3; and
MSMP-PDE2D's and MP-PDE2D's forward and step on RPU's grid.
"""
import numpy as np
import pytest
import torch

from msmp_pde_torch.data.graph import (
    build_neighbors_knn,
    build_neighbors_radius,
    cylindrical_coords,
)
from msmp_pde_torch.datagen.ics import pseudo_random_grid
from msmp_pde_torch.equations.we import cheb_grid_ascending
from msmp_pde_torch.models.gnn import GNNLayer
from msmp_pde_torch.ops import lem_scan, mp_layer, mp_pair
from msmp_pde_torch.serving.engine import build_serving_trainer
from msmp_pde_torch.training.setup import build_trainer

from _torch_helpers import cuda_device  # noqa: F401
from chip_smoke import (
    MODELS_2D,
    VARIANTS,
    expected_launches,
    grad_scales,
    kernel_push,
    launch_counts,
    plain_forward,
    reference_forward,
    reference_step_loss,
    reset_counts,
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


LEM_CASES = [(100, 128), (400, 128), (1600, 128), (37, 128), (37, 96),
             (100, 96), (400, 96), (1600, 96),
             # MSGMP-PDE's width: the hidden-164 route
             (100, 164), (400, 164), (1600, 164), (37, 164)]


@pytest.mark.parametrize("N,H", LEM_CASES)
def test_lem_kernel_matches_plain(cuda_device, N, H):
    """From a random non-zero (y0, z0)."""
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
                                         (3, 37, 96, 2, 2),
                                         (1, 100, 164, 1, 3),
                                         (16, 100, 164, 1, 3),
                                         (3, 37, 164, 2, 2)])
def test_pair_kernel_matches_plain(cuda_device, B, nx, H, V, n):
    """Bitwise repeatable; the later cases have a width that no 64-column
    tile divides (96; MSGMP-PDE's 164, 36 columns in the last tile) and
    node counts no 32-row tile divides."""
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


@pytest.mark.parametrize("N,H", LEM_CASES)
def test_lem_stash_and_bwd_match_plain(cuda_device, N, H):
    """From a random non-zero (y0, z0): dy0 and dz0 are held with the
    other outputs."""
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


@pytest.mark.parametrize("N,H", [(37, 96), (100, 128), (1600, 128),
                                 (37, 164), (1600, 164)])
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
                                         (3, 37, 96, 2, 2),
                                         (1, 100, 164, 1, 3),
                                         (16, 100, 164, 1, 3),
                                         (3, 37, 164, 2, 2)])
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


def _knn_graph(nx=100):
    """The wave equation's graph: K = 3 nearest neighbours on the
    Chebyshev grid (float32 coordinates, as the dataset holds them)."""
    x = cheb_grid_ascending(-8.0, 8.0, nx).astype(np.float32)
    return build_neighbors_knn(x.astype(np.float64), 3)


def _rpu_graph(nx=100):
    """RPU's graph: K = 3 nearest neighbours on the cylindrical coordinates
    of the LCG grid (float32 coordinates, as the dataset holds them)."""
    x = pseudo_random_grid(0.0, 16.0, nx).astype(np.float32)
    return build_neighbors_knn(cylindrical_coords(x.astype(np.float64)), 3)


def _layer_args(dev, B, nx, H, V, n, switch, seed, D=25):
    """n: the radius stencil's neighbours a side, or "knn" for
    ``_knn_graph``, "rpu" for ``_rpu_graph``."""
    rng = np.random.default_rng(seed)
    graphs = {"knn": _knn_graph, "rpu": _rpu_graph}
    idx, mask = (graphs[n](nx) if n in graphs else
                 build_neighbors_radius(np.linspace(0.0, 16.0, nx), n))
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


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_kernel_path_matches_plain_path(cuda_device, name):
    """The five models of the slice at full width: one forward (and
    SaveMSMP-PDE's new state) against the plain path at 5e-4, with the
    expected launches (the twin towers 2 LEM scans and 12 pairs, the LSTM
    models no LEM scan)."""
    trainer = build_serving_trainer("E1", name, device=cuda_device)
    rng = np.random.default_rng(1)
    window = _rand(rng, cuda_device, 4, 100, 25)
    steps = torch.full((4,), 50, device=cuda_device)
    with torch.no_grad():
        reset_counts()
        got, state = trainer.forward(window, steps, {})
        counts = launch_counts()
        want, want_state = plain_forward(trainer)(window, steps, {})
    assert counts == expected_launches(trainer.model, 1)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
    assert (state is None) == (want_state is None)
    for a, b in zip(state or (), want_state or ()):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("name", ["MSGMP-PDE", "SaveMSMP-PDE"])
def test_variant_train_step_matches_plain_path(cuda_device, name):
    """One step at unrolled 1 (SaveMSMP-PDE's state threaded through the
    pushforward): the loss and every gradient, kernel path vs plain path,
    the plain step from the kernel path's pushed window and state
    (chip_smoke.check_train_step: the pushforward amplifies float32's
    rounding alike on both paths)."""
    trainer = build_trainer("E1", name, device=cuda_device)
    params = list(trainer.model.parameters())
    batch = _train_batch(trainer, 4, 1, 5)
    loss_k = trainer.step_loss(*batch[:1], {}, *batch[1:], 1)
    grads_k = torch.autograd.grad(loss_k, params)
    loss_p = trainer.step_loss(*batch[:1], {}, *batch[1:], 1,
                               forward=kernel_push(trainer))
    grads_p = torch.autograd.grad(loss_p, params)
    assert abs(loss_k.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
    names = [n for n, _ in trainer.model.named_parameters()]
    scales = grad_scales(zip(names, grads_p))
    for pname, a, b in zip(names, grads_k, grads_p):
        ok, err = scale_aware(a, b, scales[pname])
        assert ok, (pname, err, scales[pname])


# the 2-D models' shapes: D = 2 tw = 50, V = 3, on RP's grid (nx 100)
D2, V2 = 50, 3
PAIR_D50_CASES = [(1, 128), (16, 128), (48, 128), (1, 164), (16, 164),
                  (48, 164)]


@pytest.mark.parametrize("B,H", PAIR_D50_CASES)
def test_pair_kernels_d50_match_plain(cuda_device, B, H):
    """The pair's forward and fused backward at D = 50, V = 3, each
    bitwise repeatable."""
    args = _layer_args(cuda_device, B, 100, H, V2, 3, False, 700 + B, D2)
    Wl = _layer_args(cuda_device, B, 100, H, V2, 3, False, 710 + B, D2)[-1]
    args = args + (Wl,)
    with torch.no_grad():
        got = mp_pair.fused_gated_pair_kernel(*args)
        assert torch.equal(got, mp_pair.fused_gated_pair_kernel(*args))
        want = mp_pair.fused_gated_pair_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    g = _rand(np.random.default_rng(B), cuda_device, *got.shape)
    flat = lambda res: [res[0], *res[1], *res[2]]
    k1 = flat(mp_pair.fused_gated_pair_bwd_kernel(*args, g))
    k2 = flat(mp_pair.fused_gated_pair_bwd_kernel(*args, g))
    p = flat(mp_pair.fused_gated_pair_bwd_plain(*args, g))
    for k, (a, b, c) in enumerate(zip(k1, k2, p)):
        assert torch.equal(a, b), k
        scale = p[k - 1].abs().max().item() if k % 12 == 0 and k else None
        assert scale_aware(a, c, scale)[0], (k, scale_aware(a, c, scale))


def test_pair_stash_d50_at_batch_48(cuda_device):
    """The stash variant at D = 50: out bitwise the variant's without it,
    gn and ln against the plain layers."""
    args = _layer_args(cuda_device, 48, 100, 128, V2, 3, False, 720, D2)
    Wl = _layer_args(cuda_device, 48, 100, 128, V2, 3, False, 721, D2)[-1]
    args = args + (Wl,)
    out, gn, ln = mp_pair.fused_gated_pair_kernel(*args, stash=True)
    assert torch.equal(out, mp_pair.fused_gated_pair_kernel(*args))
    for got, W in ((gn, args[6]), (ln, args[7])):
        torch.testing.assert_close(
            got, mp_layer.fused_mp_layer_plain(*args[:6], W), rtol=1e-4,
            atol=1e-4)


@pytest.mark.parametrize("B", [1, 16, 48])
@pytest.mark.parametrize("switch", [True, False])
def test_layer_kernels_d50_match_plain(cuda_device, B, switch):
    """Both switch settings at D = 50, V = 3: GNN_Layer (MP-PDE2D, LEM2D,
    LSTM2D) and GNN_LayerLin (MSG2-PDE2D's gate and layer)."""
    args = _layer_args(cuda_device, B, 100, 128, V2, 3, switch, 800 + B, D2)
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
    for k, (a, b, c) in enumerate(zip(k1, k2, p)):
        assert torch.equal(a, b), k
        scale = p[11].abs().max().item() if k == 12 and not switch else None
        assert scale_aware(a, c, scale)[0], (k, scale_aware(a, c, scale))


def _rp_vars(rng, dev, B):
    return {"a": torch.tensor(rng.uniform(0.1, 1.0, B), dtype=torch.float32,
                              device=dev),
            "b": torch.tensor(rng.uniform(1.0, 10.0, B), dtype=torch.float32,
                              device=dev)}


@pytest.mark.parametrize("name", MODELS_2D)
def test_2d_model_kernel_path_matches_plain_path(cuda_device, name):
    """The ten 2-D models at full width on RP's grid: one forward against
    the plain path at 5e-4, with the expected launches (MSG2-PDE2D 12
    single layers, GLEMGated2D none)."""
    trainer = build_serving_trainer("RP", name, device=cuda_device)
    rng = np.random.default_rng(2)
    window = _rand(rng, cuda_device, 4, 100, 50)
    steps = torch.full((4,), 50, device=cuda_device)
    var = _rp_vars(rng, cuda_device, 4)
    with torch.no_grad():
        reset_counts()
        got, state = trainer.forward(window, steps, var)
        counts = launch_counts()
        want, want_state = plain_forward(trainer)(window, steps, var)
    assert counts == expected_launches(trainer.model, 1)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
    for a, b in zip(state or (), want_state or ()):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("name", ["MSMP-PDE2D", "MSG2-PDE2D", "MP-PDE2D"])
def test_2d_train_step_matches_plain_path(cuda_device, name):
    """One step at unrolled 1 on [B, nt, 2, nx] trajectories with a and b,
    the plain step from the kernel path's pushed window: the loss and
    every gradient."""
    trainer = build_trainer("RP", name, device=cuda_device)
    params = list(trainer.model.parameters())
    rng = np.random.default_rng(6)
    u_all = torch.tensor(rng.normal(size=(4, 250, 2, 100)),
                         dtype=torch.float32, device=cuda_device)
    var = _rp_vars(rng, cuda_device, 4)
    idx = torch.arange(4, device=cuda_device)
    steps = torch.as_tensor(rng.integers(25, 201, 4), device=cuda_device)
    loss_k = trainer.step_loss(u_all, var, idx, steps, 1)
    grads_k = torch.autograd.grad(loss_k, params)
    loss_p = trainer.step_loss(u_all, var, idx, steps, 1,
                               forward=kernel_push(trainer))
    grads_p = torch.autograd.grad(loss_p, params)
    assert abs(loss_k.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
    names = [n for n, _ in trainer.model.named_parameters()]
    scales = grad_scales(zip(names, grads_p))
    for pname, a, b in zip(names, grads_k, grads_p):
        ok, err = scale_aware(a, b, scales[pname])
        assert ok, (pname, err, scales[pname])


# the wave equation's shapes: K = 3 k-NN on the Chebyshev grid of 100,
# D = 25, V = 1 (t) or 3 (t and two equation variables)
KNN_PAIR_CASES = [(B, 128, V) for B in (1, 16, 48) for V in (1, 3)]
KNN_PAIR_CASES += [(16, 164, 3)]


def test_knn_graph_has_unequal_in_degrees():
    idx, mask = _knn_graph()
    deg = np.bincount(idx.ravel(), minlength=100)
    assert idx.shape == (100, 3) and (mask == 1).all()
    assert deg.min() == 2 and deg.max() == 5


@pytest.mark.parametrize("B,H,V", KNN_PAIR_CASES)
def test_pair_kernels_knn_match_plain(cuda_device, B, H, V):
    """The pair's forward and fused backward on the k-NN graph, each
    bitwise repeatable."""
    args = _layer_args(cuda_device, B, 100, H, V, "knn", False, 900 + B)
    Wl = _layer_args(cuda_device, B, 100, H, V, "knn", False, 910 + B)[-1]
    args = args + (Wl,)
    with torch.no_grad():
        got = mp_pair.fused_gated_pair_kernel(*args)
        assert torch.equal(got, mp_pair.fused_gated_pair_kernel(*args))
        want = mp_pair.fused_gated_pair_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    g = _rand(np.random.default_rng(B), cuda_device, *got.shape)
    flat = lambda res: [res[0], *res[1], *res[2]]
    k1 = flat(mp_pair.fused_gated_pair_bwd_kernel(*args, g))
    k2 = flat(mp_pair.fused_gated_pair_bwd_kernel(*args, g))
    p = flat(mp_pair.fused_gated_pair_bwd_plain(*args, g))
    for k, (a, b, c) in enumerate(zip(k1, k2, p)):
        assert torch.equal(a, b), k
        scale = p[k - 1].abs().max().item() if k % 12 == 0 and k else None
        assert scale_aware(a, c, scale)[0], (k, scale_aware(a, c, scale))


def test_pair_stash_knn_at_batch_48(cuda_device):
    """The stash variant on the k-NN graph: out bitwise the variant's
    without it, gn and ln against the plain layers."""
    args = _layer_args(cuda_device, 48, 100, 128, 3, "knn", False, 920)
    Wl = _layer_args(cuda_device, 48, 100, 128, 3, "knn", False, 921)[-1]
    args = args + (Wl,)
    out, gn, ln = mp_pair.fused_gated_pair_kernel(*args, stash=True)
    assert torch.equal(out, mp_pair.fused_gated_pair_kernel(*args))
    for got, W in ((gn, args[6]), (ln, args[7])):
        torch.testing.assert_close(
            got, mp_layer.fused_mp_layer_plain(*args[:6], W), rtol=1e-4,
            atol=1e-4)


@pytest.mark.parametrize("B", [1, 16, 48])
@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("switch", [True, False])
def test_layer_kernels_knn_match_plain(cuda_device, B, V, switch):
    """Both switch settings on the k-NN graph, forward and backward."""
    args = _layer_args(cuda_device, B, 100, 128, V, "knn", switch, 930 + B)
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
    for k, (a, b, c) in enumerate(zip(k1, k2, p)):
        assert torch.equal(a, b), k
        scale = p[11].abs().max().item() if k == 12 and not switch else None
        assert scale_aware(a, c, scale)[0], (k, scale_aware(a, c, scale))


def _we3_trainer(name, dev):
    """``name`` at full width on WE3's grid: the Chebyshev grid of 200
    down-projected to 100 as the dataset reads it, its k-NN graph."""
    from msmp_pde_torch.data.dataset import _mean_downproject
    from msmp_pde_torch.training.setup import GridInfo

    x = _mean_downproject(cheb_grid_ascending(-8.0, 8.0, 200)[None], 2)[0]
    grid = GridInfo(x=x.astype(np.float32), nt=250, dt=100.0 / 249,
                    tmin=0.0, tmax=100.0, n_components=1)
    return build_trainer("WE3", name, device=dev, grid=grid)


def _we3_vars(rng, dev, B):
    return {k: torch.tensor(rng.integers(0, 2, B), dtype=torch.float32,
                            device=dev) for k in ("bc_left", "bc_right")}


@pytest.mark.parametrize("name", ["MSMP-PDE", "MP-PDE"])
def test_we3_model_kernel_path_matches_plain_path(cuda_device, name):
    """One forward on WE3's k-NN graph (K = 3, V = 3) against the plain
    path at 5e-4, with the expected launches; and one step at unrolled 1,
    the plain step from the kernel path's pushed window: the loss and
    every gradient."""
    trainer = _we3_trainer(name, cuda_device)
    assert trainer.spec.idx.shape == (100, 3)
    rng = np.random.default_rng(7)
    window = _rand(rng, cuda_device, 4, 100, 25)
    steps = torch.full((4,), 25, device=cuda_device)
    var = _we3_vars(rng, cuda_device, 4)
    with torch.no_grad():
        reset_counts()
        got, _ = trainer.forward(window, steps, var)
        counts = launch_counts()
        want, _ = plain_forward(trainer)(window, steps, var)
    assert counts == expected_launches(trainer.model, 1)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
    params = list(trainer.model.parameters())
    u_all = torch.tensor(rng.normal(size=(4, 250, 100)), dtype=torch.float32,
                         device=cuda_device)
    var = _we3_vars(rng, cuda_device, 4)
    idx = torch.arange(4, device=cuda_device)
    steps = torch.as_tensor(rng.integers(25, 201, 4), device=cuda_device)
    loss_k = trainer.step_loss(u_all, var, idx, steps, 1)
    grads_k = torch.autograd.grad(loss_k, params)
    loss_p = trainer.step_loss(u_all, var, idx, steps, 1,
                               forward=kernel_push(trainer))
    grads_p = torch.autograd.grad(loss_p, params)
    assert abs(loss_k.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
    names = [n for n, _ in trainer.model.named_parameters()]
    scales = grad_scales(zip(names, grads_p))
    for pname, a, b in zip(names, grads_k, grads_p):
        ok, err = scale_aware(a, b, scales[pname])
        assert ok, (pname, err, scales[pname])


# RPU's shapes: K = 3 k-NN on the LCG grid of 100 (in-degrees 0 to 6), the
# 2-D models' D = 50, V = 3
KNN_RPU_PAIR_CASES = [(1, 128), (16, 128), (48, 128), (16, 164)]


def test_knn_rpu_graph_has_nodes_of_in_degree_zero():
    idx, mask = _rpu_graph()
    deg = np.bincount(idx.ravel(), minlength=100)
    assert idx.shape == (100, 3) and (mask == 1).all()
    assert deg.min() == 0 and deg.max() == 6


@pytest.mark.parametrize("B,H", KNN_RPU_PAIR_CASES)
def test_pair_kernels_knn_rpu_match_plain(cuda_device, B, H):
    """The pair's forward and fused backward on RPU's graph, each bitwise
    repeatable."""
    args = _layer_args(cuda_device, B, 100, H, 3, "rpu", False, 940 + B,
                       D=50)
    Wl = _layer_args(cuda_device, B, 100, H, 3, "rpu", False, 950 + B,
                     D=50)[-1]
    args = args + (Wl,)
    with torch.no_grad():
        got = mp_pair.fused_gated_pair_kernel(*args)
        assert torch.equal(got, mp_pair.fused_gated_pair_kernel(*args))
        want = mp_pair.fused_gated_pair_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    g = _rand(np.random.default_rng(B), cuda_device, *got.shape)
    flat = lambda res: [res[0], *res[1], *res[2]]
    k1 = flat(mp_pair.fused_gated_pair_bwd_kernel(*args, g))
    k2 = flat(mp_pair.fused_gated_pair_bwd_kernel(*args, g))
    p = flat(mp_pair.fused_gated_pair_bwd_plain(*args, g))
    for k, (a, b, c) in enumerate(zip(k1, k2, p)):
        assert torch.equal(a, b), k
        scale = p[k - 1].abs().max().item() if k % 12 == 0 and k else None
        assert scale_aware(a, c, scale)[0], (k, scale_aware(a, c, scale))


def test_pair_stash_knn_rpu_at_batch_48(cuda_device):
    """The stash variant on RPU's graph: out bitwise the variant's without
    it, gn and ln against the plain layers."""
    args = _layer_args(cuda_device, 48, 100, 128, 3, "rpu", False, 960,
                       D=50)
    Wl = _layer_args(cuda_device, 48, 100, 128, 3, "rpu", False, 961,
                     D=50)[-1]
    args = args + (Wl,)
    out, gn, ln = mp_pair.fused_gated_pair_kernel(*args, stash=True)
    assert torch.equal(out, mp_pair.fused_gated_pair_kernel(*args))
    for got, W in ((gn, args[6]), (ln, args[7])):
        torch.testing.assert_close(
            got, mp_layer.fused_mp_layer_plain(*args[:6], W), rtol=1e-4,
            atol=1e-4)


@pytest.mark.parametrize("B", [1, 16, 48])
@pytest.mark.parametrize("switch", [True, False])
def test_layer_kernels_knn_rpu_match_plain(cuda_device, B, switch):
    """Both switch settings on RPU's graph, forward and backward."""
    args = _layer_args(cuda_device, B, 100, 128, 3, "rpu", switch, 970 + B,
                       D=50)
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
    for k, (a, b, c) in enumerate(zip(k1, k2, p)):
        assert torch.equal(a, b), k
        scale = p[11].abs().max().item() if k == 12 and not switch else None
        assert scale_aware(a, c, scale)[0], (k, scale_aware(a, c, scale))


@pytest.mark.parametrize("name", ["MSMP-PDE2D", "MP-PDE2D"])
def test_rpu_model_kernel_path_matches_plain_path_knn_rpu(cuda_device, name):
    """One forward on RPU's grid (the LCG grid of 100, its k-NN graph, V =
    3) against the plain path at 5e-4, with the expected launches; and one
    step at unrolled 1, the plain step from the kernel path's pushed
    window: the loss and every gradient."""
    from msmp_pde_torch.training.setup import GridInfo

    x = pseudo_random_grid(0.0, 16.0, 100).astype(np.float32)
    grid = GridInfo(x=x, nt=250, dt=4.0 / 249, tmin=0.0, tmax=4.0,
                    n_components=2)
    trainer = build_trainer("RPU", name, device=cuda_device, grid=grid)
    np.testing.assert_array_equal(trainer.spec.idx.cpu().numpy(),
                                  _rpu_graph()[0])
    rng = np.random.default_rng(8)
    var = lambda n: {k: torch.tensor(rng.uniform(lo, hi, n),
                                     dtype=torch.float32, device=cuda_device)
                     for k, lo, hi in (("a", 0.1, 1.0), ("b", 1.0, 10.0))}
    window = _rand(rng, cuda_device, 4, 100, 50)
    steps = torch.full((4,), 25, device=cuda_device)
    v4 = var(4)
    with torch.no_grad():
        reset_counts()
        got, _ = trainer.forward(window, steps, v4)
        counts = launch_counts()
        want, _ = plain_forward(trainer)(window, steps, v4)
    assert counts == expected_launches(trainer.model, 1)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
    params = list(trainer.model.parameters())
    u_all = torch.tensor(rng.normal(size=(4, 250, 2, 100)),
                         dtype=torch.float32, device=cuda_device)
    v4 = var(4)
    idx = torch.arange(4, device=cuda_device)
    steps = torch.as_tensor(rng.integers(25, 201, 4), device=cuda_device)
    loss_k = trainer.step_loss(u_all, v4, idx, steps, 1)
    grads_k = torch.autograd.grad(loss_k, params)
    loss_p = trainer.step_loss(u_all, v4, idx, steps, 1,
                               forward=kernel_push(trainer))
    grads_p = torch.autograd.grad(loss_p, params)
    assert abs(loss_k.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
    names = [n for n, _ in trainer.model.named_parameters()]
    scales = grad_scales(zip(names, grads_p))
    for pname, a, b in zip(names, grads_k, grads_p):
        ok, err = scale_aware(a, b, scales[pname])
        assert ok, (pname, err, scales[pname])


# ---- the bf16 precision modes (chip_smoke.py phase 27) --------------------
# E1's shapes at batches 1, 16 and 48, hidden 164, D = 50 with V = 3 on the
# radius graph and on RPU's k-NN graph (nodes of in-degree 0). A kernel in
# bfloat16 or bfloat16s is held as chip_smoke.bf16_kernel_held holds it
# (phase 27): a forward's outputs against the plain version in the same
# mode, a backward's against the spread of three sound plain versions, and
# every rounding site on the kernel's own operands from its workspace; two
# runs bitwise equal. Each fault planted in the plain site functions fails
# its site on the kernel's run.
BF16_CASES = [(B, 128, 25, 1, 3) for B in (1, 16, 48)] + [
    (16, 164, 25, 1, 3), (16, 128, 50, 3, 3), (16, 128, 50, 3, "rpu")]
BF16_MODES = ["bfloat16", "bfloat16s"]


def _bf16_args(dev, B, H, D, V, n, seed):
    """(h, u, px, v, idx, mask, Wg, Wl, W1, g) on the graph ``n``."""
    rng = np.random.default_rng(seed)
    graphs = {"knn": _knn_graph, "rpu": _rpu_graph}
    idx, mask = (graphs[n](100) if n in graphs else
                 build_neighbors_radius(np.linspace(0.0, 16.0, 100), n))
    W = [tuple(w.detach() for w in GNNLayer(
        H, D, V, torch.Generator().manual_seed(seed + i), i == 2,
        i == 2).to(dev).weights()) for i in range(3)]
    r = lambda *s, **k: _rand(rng, dev, *s, **k)
    return (r(B, 100, H), r(B, 100, D), r(B, 100, 1), r(B, 100, V, scale=.5),
            torch.as_tensor(idx, device=dev),
            torch.as_tensor(mask, device=dev), *W, r(B, 100, H))


@pytest.mark.parametrize("mode", BF16_MODES)
@pytest.mark.parametrize("name", ["mp_pair_fwd", "mp_pair_bwd",
                                  "mp_layer_fwd", "mp_layer_bwd"])
@pytest.mark.parametrize("B,H,D,V,n", BF16_CASES)
def test_bf16_kernels_match_plain(cuda_device, B, H, D, V, n, name, mode):
    from chip_smoke import bf16_kernel_held, bf16_kernel_run, flat, mp_calls

    *base, wg, wl, w1, g = _bf16_args(cuda_device, B, H, D, V, n, 90 + B)
    ws = (wg, wl) if name.startswith("mp_pair") else (w1,)
    args = (*base, *ws) + ((g,) if name.endswith("_bwd") else ())
    out, layers = bf16_kernel_run(name, args, mode)
    with torch.no_grad():
        again = flat(mp_calls(name, mode)[0](*args))
    assert all(torch.equal(a, b) for a, b in zip(flat(out), again))
    ok, r, site_r, site, _, held = bf16_kernel_held(name, args, mode, out,
                                                    layers)
    assert ok, (held, r, site, site_r)


def test_bf16_planted_faults_fail_their_sites(cuda_device):
    from chip_smoke import bf16_fault_check

    *base, wg, wl, w1, g = _bf16_args(cuda_device, 16, 128, 25, 1, 3, 96)
    bf16_fault_check({"mp_pair_fwd": (*base, wg, wl),
                      "mp_pair_bwd": (*base, wg, wl, g),
                      "mp_layer_fwd": (*base, w1),
                      "mp_layer_bwd": (*base, w1, g)})


@pytest.mark.parametrize("mode", BF16_MODES)
def test_bf16_pair_stash_at_batch_48(cuda_device, mode):
    """The stash variant's out is bitwise the variant's without it; its
    gn and ln are held as the forward is."""
    from chip_smoke import BF16_FWD_RATIO, bf16_ratios, mp_calls

    *base, wg, wl, _, _ = _bf16_args(cuda_device, 48, 128, 25, 1, 3, 95)
    args = (*base, wg, wl)
    kern, plain = mp_calls("mp_pair_fwd_stash", mode)
    with torch.no_grad():
        out, gn, ln = kern(*args)
        assert torch.equal(out, mp_calls("mp_pair_fwd", mode)[0](*args))
        r = bf16_ratios([out, gn, ln], plain(*args),
                        mp_calls("mp_pair_fwd_stash")[1](*args))
    assert max(r) <= BF16_FWD_RATIO, r


@pytest.mark.parametrize("mode", BF16_MODES)
def test_bf16_cooperative_grids_fill_every_sm(cuda_device, mode):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in ("mp_pair_fwd", "mp_pair_bwd", "mp_layer_fwd",
                 "mp_layer_bwd"):
        n = mp_layer.grid_blocks(name, name.startswith("mp_layer"), mode)
        assert n >= sms and n % sms == 0, (name, n)
