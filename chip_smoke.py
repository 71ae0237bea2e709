#!/usr/bin/env python3
"""Smoke and measurement run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. build every CUDA kernel (serving and training) from
     msmp_pde_torch/csrc, printing ptxas's registers and spills and the
     LEM kernels' shared memory a CTA;
  2. LEM-scan kernel vs its plain PyTorch version, N in {100, 400, 1600, 37}
     at hidden 128 and 96; two runs give bitwise equal outputs;
  3. fused gated-pair kernel vs its plain version, B in {1, 4, 16, 48} at
     the model's weights and one width no 64-column tile divides; two runs
     give bitwise equal outputs;
  4. the full-width MSMP-PDE forward (E1: nx=100, tw=25, hidden 128, six
     gated pairs) with weights made from a numpy seed in the flax layout
     and carried across by params_from_flax: kernel path vs
     reference_forward, the same forward through the plain versions;
  5. the main path: the port's HTTP server on localhost answers rollout
     requests (B = 1, 3, 16, 20, and one trajectory) at n_windows=8, each
     checked against RolloutEngine.rollout and against the expected kernel
     launch counts;
  6. timings (CUDA events, medians) of each kernel beside its plain
     version (replayed from a CUDA graph, and eager) and its bound, the
     pair's forward at buckets 1 and 16, the model's forward at buckets 1
     and 16 beside the host's time to enqueue it, and request latency per
     bucket;
  7. the LEM-scan stash variant and backward kernel vs their plain
     versions, N in {100, 400, 1600, 37} at hidden 128 and 96; two runs of
     each give bitwise equal outputs, and the stash variant's yT, zT are
     bitwise the other variant's;
  8. the fused-pair backward kernel vs its plain version, B in {1, 4, 16,
     48} with the model's weights and one width no 64-column tile divides;
     two runs give bitwise equal gradients;
  9. one training step at batch 16, kernel path vs plain path (the loss
     and every parameter's gradient, unrolled 0 and 1);
 10. the training main path: one train_epoch (epoch 1, unrolling 1, batch
     16, lr 1e-4) over 16 smooth in-memory trajectories of E1's shape
     [16, 250, 100], i.e. 250 optimizer steps, each with the expected
     kernel launches, finite losses, and a falling loss;
 11. timings of the three training kernels beside their plain versions and
     bounds, the LEM forward's own card time (torch.profiler) at buckets 1,
     4 and 16 and the LEM backward's by launch, and one train step at
     unrolled 0 and 1 (CUDA events and the host's enqueue time);
 12. the single-layer kernels (forward and backward) vs their plain
     versions, B in {1, 4, 16, 48} at MP-PDE's weights and one width no
     64-column tile divides, for both (final_act, residual) in {(T, T),
     (F, F)}; two runs of each give bitwise equal outputs and gradients;
 13. the pair's stash variant (out bitwise equal to the variant without
     it, gn and ln against the plain layers) and its fallback backward at
     batch 48, forced there (the fused backward takes every batch whose
     workspace fits a quarter of the card): launches and gradients; then
     one MSMP-PDE train step at batch 48 on the forced fallback, its main
     path, with its launches;
 14. the full-width MP-PDE and LEM forwards (six GNN_Layers) vs
     reference_forward; the served MP-PDE answers the requests of phase 5;
 15. one training step at batch 16 of MP-PDE and of LEM, kernel path vs
     plain path (unrolled 0 and 1); one MP-PDE train_epoch of 250 steps
     with per-step launch counts and a falling loss;
 16. timings of the single-layer kernels at batch 16 (the forward at batch
     1 too), of the stash and of both pair-backward routes at batches 16
     and 48, the four message-passing kernels' cooperative grids, and
     MP-PDE's forward, train step and rollouts.

Comparisons run in full float32 (TF32 off for matmuls and cuDNN convs).
Exits non-zero, printing no result, without CUDA or outside a checkout.
The last line is {"ok": true, "device": {...}}.
"""
import contextlib
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks: HBM bytes/s, float32 FLOP/s outside the tensor
# cores, dense TF32 FLOP/s on them
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
N_WINDOWS = 8
BUCKETS = (1, 4, 16)
ROLLOUT_SAMPLES = 100  # per bucket: p90 has 10 samples beyond it
TOL_LEM = 1e-5    # FMA order only
TOL_PAIR = 1e-4   # FMA order, then InstanceNorm's divide by the spread
TOL_MODEL = 5e-4  # six pairs and the LEM compound the pair's rounding
# LEM backward: per-row outputs as tests/test_lem_pallas.py:151. The weight
# gradients are sums over T*N rows, whose float32 rounding grows with the
# sum and not with each element: their atol is 1e-5 * max|ref|.
LEM_BWD_RTOL, LEM_BWD_ATOL = 5e-4, 1e-5
TRAIN_BATCH = 16
TRAIN_LOSS_RTOL = 1e-4


def scale_aware(got, want, scale=None):
    """max|got - want| <= max(1e-3 scale, 2e-4), scale = max|want| by
    default: the bound for weight gradients. A layer's b4 gradient is
    analytically zero (InstanceNorm removes it) and holds only roundoff on
    both sides; pass the scale of the same layer's w4 gradient, which is
    formed from the same cotangent. Returns (ok, max abs error)."""
    e = (got - want).abs().max().item()
    if scale is None:
        scale = want.abs().max().item()
    return e <= max(1e-3 * scale, 2e-4), e


def grad_scales(named):
    """{name: scale for scale_aware} over (name, reference gradient)
    pairs: b4 (``TorchDense_2.bias``) takes the larger of its own and its
    layer's w4 gradient's, since without a final activation its own is
    roundoff."""
    named = dict(named)
    top = lambda g: g.abs().max().item()
    w4 = lambda n: top(named[n[:-len("bias")] + "kernel"])
    return {n: (max(top(g), w4(n)) if n.endswith("TorchDense_2.bias")
                else top(g)) for n, g in named.items()}


COUNTERS = ("lem_fwd", "lem_fwd_stash", "lem_bwd", "mp_pair_fwd",
            "mp_pair_fwd_stash", "mp_pair_bwd", "mp_layer_fwd",
            "mp_layer_bwd")


def launch_counts():
    """{kernel: launches since the last reset}; the stash variants are
    counted in their kernel's total too."""
    from msmp_pde_torch.ops import lem_scan, mp_layer, mp_pair

    return dict(zip(COUNTERS, (
        lem_scan.launches, lem_scan.stash_launches, lem_scan.bwd_launches,
        mp_pair.launches, mp_pair.stash_launches, mp_pair.bwd_launches,
        mp_layer.launches, mp_layer.bwd_launches)))


def reset_counts():
    from msmp_pde_torch.ops import lem_scan, mp_layer, mp_pair

    lem_scan.launches = lem_scan.stash_launches = lem_scan.bwd_launches = 0
    mp_pair.launches = mp_pair.stash_launches = mp_pair.bwd_launches = 0
    mp_layer.launches = mp_layer.bwd_launches = 0


def diff_counts(now, before):
    return {k: now[k] - before[k] for k in COUNTERS}


def expected_launches(model, forwards, grad_steps=0):
    """The launches of ``forwards`` model forwards, of which ``grad_steps``
    with grad and a backward (on the fused pair route)."""
    want = dict.fromkeys(COUNTERS, 0)
    if model.encoder == "lem":
        want.update(lem_fwd=forwards, lem_fwd_stash=grad_steps,
                    lem_bwd=grad_steps)
    kind = "mp_pair" if model.gated else "mp_layer"
    want[f"{kind}_fwd"] = model.layers * forwards
    want[f"{kind}_bwd"] = model.layers * grad_steps
    return want


def nonzero(counts):
    return ", ".join(f"{k} {v}" for k, v in counts.items() if v)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def timed(fn, reps=20, rounds=5):
    """Median over ``rounds`` of the mean time of ``reps`` calls, in ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def host_ms(fn, reps=5):
    """Mean host time of a call of ``fn`` from an idle card, without
    waiting for the card: the time to enqueue its work, in ms. Where it
    passes the card's time, ``timed`` measures it and not the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / reps * 1e3


def timed_graph(fn, reps=20, rounds=11):
    """``timed`` of ``fn`` captured once in a CUDA graph and replayed: the
    device time of a chain of small launches, free of the host's launch
    rate."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timed(graph.replay, reps=reps, rounds=rounds)


def bound(nbytes, flops, tc_flops=0):
    """The least time in ms for a kernel that moves ``nbytes`` and does
    ``flops`` float32 operations on the CUDA cores and ``tc_flops`` in
    3xTF32 on the tensor cores (three TF32 products for each), and which
    of the two bounds it."""
    t_mem = nbytes / HBM_BYTES_S
    t_ops = flops / F32_FLOP_S + 3 * tc_flops / TF32_FLOP_S
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def flax_tree(model, seed):
    """Random weights for every leaf of ``model``, as a nested numpy dict
    under flax paths, each U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with the
    fan-in of the flax initializer."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    H = model.hidden
    tree = {}
    for key, val in sd.items():
        parts = key.split(".")
        mod, leaf = parts[-2], parts[-1]
        if parts[0] == "embedding_lem":
            fan = H
        elif mod == "FactorizedEdgeDense_0":
            f = ".".join(parts[:-1])
            fan = (2 * H + sd[f + ".w_du"].shape[0] + 1
                   + sd[f + ".w_var"].shape[0])
        elif mod.startswith("TorchConv1d"):
            k = sd[".".join(parts[:-1] + ["kernel"])]
            fan = k.shape[1] * k.shape[2]
        else:
            fan = sd[".".join(parts[:-1] + ["kernel"])].shape[0]
        b = 1.0 / math.sqrt(fan)
        node = tree.setdefault("params", {})
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = rng.uniform(-b, b, size=tuple(val.shape)).astype(
            np.float32)
    return tree


def reference_forward(model, window, pos_x, var_vec, idx, mask):
    """MPSolver.forward written out through the plain versions of the
    kernels (``lem_scan_plain``, ``fused_mp_layer_plain``,
    ``fused_gated_pair_plain``) on the model's own parameters, for either
    encoder (mlp, lem) and either processor (ungated layers, gated pairs):
    the on-card reference of the kernel path."""
    import torch

    from msmp_pde_torch.models.common import swish
    from msmp_pde_torch.ops.lem_scan import lem_scan_plain
    from msmp_pde_torch.ops.mp_layer import fused_mp_layer_plain
    from msmp_pde_torch.ops.mp_pair import fused_gated_pair_plain

    B, nx, tw = window.shape
    V, H = var_vec.shape[-1], model.hidden
    px_n = pos_x / model.L
    variables = var_vec[:, None, :].expand(B, nx, V)
    if model.encoder == "mlp":
        node_in = torch.cat([window, px_n[..., None], variables], -1)
        h = swish(model.embed_2(swish(model.embed_1(node_in))))
    else:
        seq = torch.stack([
            torch.cat([px_n[..., None], window[..., k:k + 1], variables], -1)
            for k in range(tw)]).reshape(tw, B * nx, 2 + V)
        lem = model.embedding_lem
        W, Wz, I = lem.weights, lem.weights_lin_z, 2 + V
        gx = seq @ W[:, :I].T + lem.bias
        zx = seq @ Wz[:, :I].T + lem.bias_lin_z
        zeros = window.new_zeros((B * nx, H))
        y, _ = lem_scan_plain(gx, zx, zeros, zeros, W[:, I:].T, Wz[:, I:].T,
                              dt=float(lem.dt))
        h = swish(model.lemout_2(swish(model.lemout_1(y.reshape(B, nx, H)))))
    for i in range(model.layers):
        layer = getattr(model, f"gnn_{i}")
        if model.gated:
            h = fused_gated_pair_plain(
                h, window, px_n[..., None], variables, idx, mask,
                getattr(model, f"gate_{i}").weights(), layer.weights())
        else:
            h = fused_mp_layer_plain(h, window, px_n[..., None], variables,
                                     idx, mask, layer.weights(), True, True)
    return model._decode(h, window)


def reference_step_loss(trainer, u_all, idx_batch, steps, unrolled):
    """``Trainer.step_loss`` with every forward through
    ``reference_forward``: autograd then differentiates the plain versions,
    the on-card reference of the kernel path's training step."""
    model, spec = trainer.model, trainer.spec

    def forward(window, steps, variables, lem_state=None):
        var_vec = trainer.graph_vars(spec.t_grid[steps], variables)
        return reference_forward(
            model, window, spec.x.expand(window.shape[0], spec.nx), var_vec,
            spec.idx, spec.mask), None

    return trainer.step_loss(u_all, {}, idx_batch, steps, unrolled,
                             forward=forward)


def smooth_trajectories(n, t_grid, x, L, seed):
    """[n, nt, nx] float32: four Fourier modes a trajectory, amplitudes
    ~1/k, phases drifting with t, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t, xs = t_grid[None, :, None, None], x[None, None, :, None]
    k = np.arange(1, 5)[None, None, None, :]
    amp = rng.uniform(0.5, 1.0, (n, 1, 1, 4)) / k
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 1, 4))
    speed = rng.uniform(-1.0, 1.0, (n, 1, 1, 4))
    u = amp * np.sin(2 * np.pi * k * xs / L + phase + speed * k * t)
    return u.sum(-1).astype(np.float32)


# (hidden, rows) of phases 2 and 7: buckets 1, 4, 16 of nx 100 and a ragged
# tile, at the model's width and one more
LEM_CASES = [(H, N) for H in (128, 96) for N in (100, 400, 1600, 37)]


def check_lem_training_kernels(rand, T):
    """Phase 7: returns (stash max error, backward max error)."""
    import torch

    from msmp_pde_torch.ops import lem_scan
    from msmp_pde_torch.tools.lem_times import lem_args

    e_stash = e_bwd = 0.0
    names = ("dgx", "dzx", "dy0", "dz0", "dwy", "dwzz")
    for H, N in LEM_CASES:
        args = lem_args(rand, T, N, H)
        k = lem_scan.lem_scan_kernel(*args, stash=True)
        k2 = lem_scan.lem_scan_kernel(*args, stash=True)
        plain_k = lem_scan.lem_scan_kernel(*args)
        p = lem_scan.lem_scan_plain(*args, stash=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k, k2)),
              f"lem_fwd_stash N={N} H={H}: two runs differ")
        check(all(torch.equal(a, b) for a, b in zip(k[:2], plain_k)),
              f"lem_fwd_stash N={N} H={H}: yT, zT differ from lem_fwd's")
        e = max((a - b).abs().max().item() for a, b in zip(k, p))
        e_stash = max(e_stash, e)
        print(f"lem_fwd_stash N={N} H={H}: max |kernel - plain| = {e:.3e}; "
              "two runs bitwise equal, yT and zT bitwise lem_fwd's")
        check(e <= TOL_LEM, f"lem_fwd_stash N={N} H={H} differs by {e:.3e}")
        cot = (rand(N, H), rand(N, H))
        gk = lem_scan.lem_scan_bwd_kernel(*args, *p[2:], *cot)
        gk2 = lem_scan.lem_scan_bwd_kernel(*args, *p[2:], *cot)
        gp = lem_scan.lem_scan_bwd_plain(*args, *p[2:], *cot)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(gk, gk2)),
              f"lem_bwd N={N} H={H}: two runs differ")
        worst = 0.0
        for name, a, b in zip(names, gk, gp):
            atol = LEM_BWD_ATOL
            if name.startswith("dw"):
                atol *= b.abs().max().item()
            e = (a - b).abs().max().item()
            worst = max(worst, e)
            check(bool(torch.allclose(a, b, rtol=LEM_BWD_RTOL, atol=atol)),
                  f"lem_bwd N={N} H={H} {name}: max |diff| {e:.3e}, atol "
                  f"{atol}")
        e_bwd = max(e_bwd, worst)
        print(f"lem_bwd N={N} H={H}: all six outputs within rtol "
              f"{LEM_BWD_RTOL} (max |kernel - plain| {worst:.3e}); two runs "
              "bitwise equal")
    return e_stash, e_bwd


def lem_card_times(rand, T, H):
    """Phase 11: the LEM kernels' own card time from torch.profiler, ms a
    call: lem_fwd at buckets 1, 4 and 16 (N = 100, 400, 1600), and
    lem_bwd's launches one by one at 16."""
    from msmp_pde_torch.ops import lem_scan
    from msmp_pde_torch.tools.lem_times import kernels_us, lem_args, short

    for N in (100, 400, 1600):
        args = lem_args(rand, T, N, H)
        ks = kernels_us(lambda: lem_scan.lem_scan_kernel(*args))
        ev = timed(lambda: lem_scan.lem_scan_kernel(*args))
        own = (" + ".join(f"{short(k)} {us / 1e3:.4f}" for k, us in ks)
               if ks else "not measured")
        print(f"lem_fwd @N={N}: card {own} ms; CUDA events {ev:.4f} ms")
    _, _, ys, zs = lem_scan.lem_scan_plain(*args, stash=True)
    bargs = (*args, ys, zs, rand(N, H), rand(N, H))
    ks = kernels_us(lambda: lem_scan.lem_scan_bwd_kernel(*bargs))
    own = (" + ".join(f"{short(k)} {us / 1e3:.4f}" for k, us in ks)
           if ks else "not measured")
    print(f"lem_bwd @N={N}: card by launch {own} ms")


def check_pair_bwd(rand, model, spec, T, H, V):
    """Phase 8: returns (max error, {B: args}) with the bucket-16 args for
    the timings."""
    import numpy as np
    import torch

    from msmp_pde_torch.data.graph import build_neighbors_radius
    from msmp_pde_torch.models.gnn import GNNLayer
    from msmp_pde_torch.ops import mp_pair

    dev = spec.x.device
    nx = spec.nx
    detach = lambda W: tuple(w.detach() for w in W)
    Wg, Wl = detach(model.gate_0.weights()), detach(model.gnn_0.weights())
    cases = [(B, nx, H, V, spec.idx, spec.mask, Wg, Wl)
             for B in (1, 4, 16, 48)]
    # a width that no 64-column tile divides, three variables, radius 2
    idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, 40), 2)
    g = torch.Generator().manual_seed(2)
    odd = [detach(GNNLayer(96, T, 3, g).to(dev).weights()) for _ in "gl"]
    cases.append((2, 40, 96, 3, torch.as_tensor(idx, device=dev),
                  torch.as_tensor(mask, device=dev), *odd))
    err, args16 = 0.0, None
    for B, n, h, v, idx, mask, wg, wl in cases:
        args = (rand(B, n, h), rand(B, n, T),
                torch.linspace(0, 1, n, device=dev).expand(B, n)[..., None],
                rand(B, n, v, scale=.5), idx, mask, wg, wl, rand(B, n, h))
        k1 = mp_pair.fused_gated_pair_bwd_kernel(*args)
        k2 = mp_pair.fused_gated_pair_bwd_kernel(*args)
        p = mp_pair.fused_gated_pair_bwd_plain(*args)
        torch.cuda.synchronize()
        flat = lambda r: [r[0], *r[1], *r[2]]
        check(all(torch.equal(a, b) for a, b in zip(flat(k1), flat(k2))),
              f"mp_pair_bwd B={B} H={h}: two runs differ")
        ref = flat(p)
        for i, (a, b) in enumerate(zip(flat(k1), ref)):
            # outputs 12 and 24 are the layers' b4, 11 and 23 their w4
            scale = ref[i - 1].abs().max().item() if i % 12 == 0 else None
            ok, e = scale_aware(a, b, scale)
            err = max(err, e)
            check(ok, f"mp_pair_bwd B={B} H={h} output {i}: {e:.3e}")
        print(f"mp_pair_bwd B={B} nx={n} H={h}: dh and 24 grads within the "
              f"scale-aware bound (max |kernel - plain| {err:.3e}); two runs "
              "bitwise equal")
        if B == 16:
            args16 = args
    return err, args16


def check_train_step(trainer, u_all, rng, name="MSMP-PDE"):
    """Phases 9 and 15: one step's loss and gradients, kernel path vs plain
    path."""
    import torch

    params = list(trainer.model.parameters())
    names = [n for n, _ in trainer.model.named_parameters()]
    dev = trainer.device
    for unrolled in (0, 1):
        idx = torch.as_tensor(rng.permutation(len(u_all))[:TRAIN_BATCH],
                              device=dev)
        steps = torch.as_tensor(
            rng.integers(25, 250 - 25 * (unrolled + 1) + 1, TRAIN_BATCH),
            device=dev)
        loss_k = trainer.step_loss(u_all, {}, idx, steps, unrolled)
        grads_k = torch.autograd.grad(loss_k, params)  # every one is used
        loss_p = reference_step_loss(trainer, u_all, idx, steps, unrolled)
        grads_p = torch.autograd.grad(loss_p, params)
        torch.cuda.synchronize()
        rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        check(rel <= TRAIN_LOSS_RTOL,
              f"{name} train step unrolled={unrolled}: loss {loss_k.item()}"
              f" vs {loss_p.item()}")
        worst = 0.0
        scales = grad_scales(zip(names, grads_p))
        for pname, a, b in zip(names, grads_k, grads_p):
            check(bool(torch.isfinite(a).all()), f"{pname}: grad not finite")
            ok, e = scale_aware(a, b, scales[pname])
            worst = max(worst, e)
            check(ok, f"{name} train step unrolled={unrolled}: {pname} grad "
                  f"differs by {e:.3e}")
        print(f"{name} train step B={TRAIN_BATCH} unrolled={unrolled}: loss "
              f"{loss_k.item():.6f} (plain {loss_p.item():.6f}, rel "
              f"{rel:.2e}); {len(params)} grads within the scale-aware "
              f"bound (max |diff| {worst:.3e})")


def train_main_path(trainer, u_all, name="MSMP-PDE"):
    """Phases 10 and 15: one train_epoch; returns the launch counts of the
    run and its time."""
    import numpy as np

    from msmp_pde_torch.training.loop import train_epoch

    nt = u_all.shape[1]
    tx = trainer.make_optimizer(1e-4, 0.4, [1, 5, 10, 15], nt)
    reset_counts()
    per_step, last = [], [launch_counts()]

    def on_step(flag):
        now = launch_counts()
        per_step.append((flag, diff_counts(now, last[0])))
        last[0] = now

    t0 = time.perf_counter()
    mean, losses = train_epoch(trainer, tx, u_all, {}, epoch=1,
                               batch_size=TRAIN_BATCH, t_res=nt,
                               unrolling=1, rng=np.random.default_rng(0),
                               print_interval=50, on_step=on_step)
    took = time.perf_counter() - t0
    totals = launch_counts()
    losses = losses.reshape(-1)
    print(f"{name} train_epoch: {len(losses)} steps in {took:.3f} s, mean "
          f"loss / batch {mean:.6f}")
    print("pass losses: " + " ".join(f"{v:.4g}" for v in losses))
    check(len(per_step) == len(losses) == nt, "train_epoch step count")
    for i, (f, d) in enumerate(per_step):
        want = expected_launches(trainer.model, f + 1, 1)
        check(d == want, f"{name} step {i} (unrolled {f}): launches "
              f"{nonzero(d)}, expected {nonzero(want)}")
    check(bool(np.isfinite(losses).all()), "a training loss is not finite")
    flags = np.array([f for f, _ in per_step])
    print(f"mean loss, first 50 steps {losses[:50].mean():.4f}, last 50 "
          f"{losses[-50:].mean():.4f}")
    # a step after one pushforward window has a larger loss: compare the
    # first and last 50 steps at each depth
    for f in (0, 1):
        first = losses[:50][flags[:50] == f].mean()
        final = losses[-50:][flags[-50:] == f].mean()
        print(f"  unrolled {f}: first 50 {first:.4f}, last 50 {final:.4f}")
        check(final < first, f"{name}: the loss at unrolled {f} did not "
              "fall")
    flags = flags.tolist()
    print(f"{name} main path launches: {nonzero(totals)}; steps at unrolled "
          f"0/1: {flags.count(0)}/{flags.count(1)}")
    return totals, took


def serve_path(engine, name):
    """Phases 5 and 14, the serving main path: the port's HTTP server on
    localhost answers rollout requests (B = 1, 3, 16, 20, and one
    trajectory) at n_windows=8, each checked against RolloutEngine.rollout
    and against the expected kernel launches. Returns the launch counts of
    the run."""
    from http.server import ThreadingHTTPServer

    import numpy as np

    from msmp_pde_torch.serving import serve

    nx, T = engine.trainer.spec.nx, engine.trainer.tw
    meta = {"backend": "cuda", "experiment": "E1", "model": name,
            "buckets": list(BUCKETS)}
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve.make_handler(engine, meta))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    served = []
    reset_counts()
    try:
        for B, traj in ((1, False), (3, False), (16, False), (20, False),
                        (4, True)):
            w = np.random.default_rng(B).normal(size=(B, nx, T)).astype(
                np.float32)
            before = launch_counts()
            t0 = time.perf_counter()
            got = serve.request_rollout("127.0.0.1", port, w,
                                        n_windows=N_WINDOWS,
                                        as_trajectory=traj)
            lat = time.perf_counter() - t0
            served.append((B, traj, w, got, lat,
                           diff_counts(launch_counts(), before)))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join()
    totals = launch_counts()
    print(f"{name} main path launches: {nonzero(totals)}")
    for B, traj, w, got, lat, d in served:
        forwards = N_WINDOWS * -(-B // BUCKETS[-1])  # windows x chunks
        want = expected_launches(engine.trainer.model, forwards)
        check(d == want, f"{name} B={B}: launches {nonzero(d)}, expected "
              f"{nonzero(want)}")
        shape = ((B, N_WINDOWS * T, 1, nx) if traj
                 else (B, N_WINDOWS, nx, T))
        check(got.shape == shape, f"{name} B={B}: response {got.shape}")
        check(bool(np.isfinite(got).all()), f"{name} B={B}: not finite")
        kw = dict(n_windows=N_WINDOWS)
        direct = (engine.trajectory(w, **kw) if traj
                  else engine.rollout(w, **kw))
        check(np.array_equal(got, direct),
              f"{name} B={B}: served result differs from engine.rollout")
        print(f"{name} served B={B}{' trajectory' if traj else ''}: "
              f"{got.shape}, {lat * 1e3:.3f} ms, launches {nonzero(d)}")
    return totals


def check_model_forward(trainer, window, steps, name):
    """Phases 4 and 14: the whole model, kernel path vs plain path."""
    import torch

    spec = trainer.spec
    B, nx, T = window.shape
    with torch.no_grad():
        out_k, _ = trainer.forward(window, steps, {})
        out_p = reference_forward(
            trainer.model, window, spec.x.expand(B, nx),
            trainer.graph_vars(spec.t_grid[steps], {}), spec.idx, spec.mask)
    torch.cuda.synchronize()
    check(out_k.shape == (B, nx, T), f"{name} output {tuple(out_k.shape)}")
    check(bool(torch.isfinite(out_k).all()), f"{name} output not finite")
    e = (out_k - out_p).abs().max().item()
    print(f"{name} forward B={B}: max |kernel path - plain path| = {e:.3e}"
          f" (output max |.| {out_p.abs().max().item():.3e})")
    check(e <= TOL_MODEL, f"{name} differs by {e:.3e} > {TOL_MODEL}")


def check_layer_kernels(rand, W, spec, T, H, V):
    """Phase 12: the single-layer kernels vs their plain versions, B in
    {1, 4, 16, 48} at the model's weights and one width no 64-column tile
    divides, for both switch pairs; two backward runs are bitwise equal.
    Returns (forward max error, backward max error)."""
    import numpy as np
    import torch

    from msmp_pde_torch.data.graph import build_neighbors_radius
    from msmp_pde_torch.models.gnn import GNNLayer
    from msmp_pde_torch.ops import mp_layer

    dev = spec.x.device
    W = tuple(w.detach() for w in W)
    cases = [(B, spec.nx, H, V, spec.idx, spec.mask, W)
             for B in BUCKETS + (48,)]
    idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, 40), 2)
    odd = GNNLayer(96, T, 3, torch.Generator().manual_seed(3)).to(dev)
    cases.append((2, 40, 96, 3, torch.as_tensor(idx, device=dev),
                  torch.as_tensor(mask, device=dev),
                  tuple(w.detach() for w in odd.weights())))
    e_fwd = e_bwd = 0.0
    for B, n, h, v, idx, mask, w in cases:
        for sw in (True, False):
            args = (rand(B, n, h), rand(B, n, T),
                    torch.linspace(0, 1, n, device=dev).expand(B, n)[..., None],
                    rand(B, n, v, scale=.5), idx, mask, w)
            k = mp_layer.fused_mp_layer_kernel(*args, sw, sw)
            k_again = mp_layer.fused_mp_layer_kernel(*args, sw, sw)
            p = mp_layer.fused_mp_layer_plain(*args, sw, sw)
            g = rand(B, n, h)
            k1 = mp_layer.fused_mp_layer_bwd_kernel(*args, g, sw, sw)
            k2 = mp_layer.fused_mp_layer_bwd_kernel(*args, g, sw, sw)
            ref = mp_layer.fused_mp_layer_bwd_plain(*args, g, sw, sw)
            torch.cuda.synchronize()
            ef = (k - p).abs().max().item()
            e_fwd = max(e_fwd, ef)
            tag = f"B={B} H={h} final_act=residual={sw}"
            check(torch.equal(k, k_again), f"mp_layer_fwd {tag}: two runs "
                  "differ")
            check(ef <= TOL_PAIR, f"mp_layer_fwd {tag} differs by {ef:.3e}")
            flat = lambda r: [r[0], *r[1]]
            k1, k2, ref = flat(k1), flat(k2), flat(ref)
            check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
                  f"mp_layer_bwd {tag}: two runs differ")
            top = lambda t: t.abs().max().item()
            eb = 0.0
            for i, (a, b) in enumerate(zip(k1, ref)):
                # output 12 is b4, 11 w4 (b4 is roundoff without final_act)
                scale = max(top(b), top(ref[11])) if i == 12 else None
                ok, e = scale_aware(a, b, scale)
                eb = max(eb, e)
                check(ok, f"mp_layer_bwd {tag} output {i}: {e:.3e}")
            e_bwd = max(e_bwd, eb)
            print(f"mp_layer {tag}: forward max |kernel - plain| {ef:.3e}; "
                  f"backward dh and 12 grads within the scale-aware bound "
                  f"(max {eb:.3e}); two runs of each bitwise equal")
    return e_fwd, e_bwd


def check_pair_fallback(rand, model, spec, T, H, V):
    """Phase 13: the pair's stash variant (out bitwise equal to the variant
    without it, gn and ln against the plain layers) at B in {1, 4, 16, 48};
    the fallback route forced at batch 48 (launches, and dh and the 24
    gradients against the fused backward's plain version). Returns (stash
    max error, fallback max error, the batch-48 operands (args, gn, ln,
    g))."""
    import torch

    from msmp_pde_torch.ops import mp_layer, mp_pair

    nx, K = spec.idx.shape
    Wg = tuple(w.detach() for w in model.gate_0.weights())
    Wl = tuple(w.detach() for w in model.gnn_0.weights())
    fits = lambda B: mp_pair.pair_bwd_fused_fits(B, nx, H, T, V, K,
                                                 spec.x.device)
    top, over = 1, 2  # the largest batch that fits, the least that does not
    while fits(over):
        top, over = over, 2 * over
    while over - top > 1:
        mid = (top + over) // 2
        top, over = (mid, over) if fits(mid) else (top, mid)
    print(f"fused pair backward up to batch {top} (its workspace in a "
          f"quarter of {torch.cuda.get_device_properties(0).total_memory} "
          "bytes); the fallback takes larger batches, and is forced here")
    check(all(fits(B) for B in (1, 16, 48)) and not fits(top + 1),
          "pair_bwd_fused_fits switch")
    e_stash = 0.0
    for B in BUCKETS + (48,):
        args = (rand(B, nx, H), rand(B, nx, T),
                spec.x.expand(B, nx)[..., None] / spec.L,
                rand(B, nx, V, scale=.5), spec.idx, spec.mask, Wg, Wl)
        out, gn, ln = mp_pair.fused_gated_pair_kernel(*args, stash=True)
        plain = mp_pair.fused_gated_pair_kernel(*args)
        pgn = mp_layer.fused_mp_layer_plain(*args[:6], Wg)
        pln = mp_layer.fused_mp_layer_plain(*args[:6], Wl)
        torch.cuda.synchronize()
        check(torch.equal(out, plain), f"mp_pair_fwd_stash B={B}: out differs"
              " from the variant without the stash")
        e = max((gn - pgn).abs().max().item(), (ln - pln).abs().max().item())
        e_stash = max(e_stash, e)
        check(e <= TOL_PAIR, f"mp_pair_fwd_stash B={B}: gn/ln differ by "
              f"{e:.3e}")
        print(f"mp_pair_fwd_stash B={B}: out bitwise equal to no-stash; "
              f"gn, ln max |kernel - plain| {e:.3e}")
    g = rand(48, nx, H)
    h = args[0].clone().requires_grad_()
    ws = [w.clone().requires_grad_() for w in Wg + Wl]
    reset_counts()
    with forced_fallback():
        out = mp_pair.fused_gated_pair(h, *args[1:6], ws[:12], ws[12:])
    got = torch.autograd.grad(out, [h] + ws, g)
    counts = launch_counts()
    want_counts = dict.fromkeys(COUNTERS, 0)
    want_counts.update(mp_pair_fwd=1, mp_pair_fwd_stash=1, mp_layer_bwd=2)
    check(counts == want_counts, f"fallback at batch 48: launches "
          f"{nonzero(counts)}, expected {nonzero(want_counts)}")
    dh, dwg, dwl = mp_pair.fused_gated_pair_bwd_plain(*args, g)
    ref = [dh, *dwg, *dwl]
    e_fb = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        # outputs 12 and 24 are the layers' b4, 11 and 23 their w4
        scale = ref[i - 1].abs().max().item() if i % 12 == 0 and i else None
        ok, e = scale_aware(a, b, scale)
        e_fb = max(e_fb, e)
        check(ok, f"fallback at batch 48 output {i}: {e:.3e}")
    print(f"pair fallback at batch 48: launches {nonzero(counts)}; dh and 24 "
          f"grads within the scale-aware bound (max |diff| {e_fb:.3e})")
    return e_stash, e_fb, (args, gn, ln, g)


@contextlib.contextmanager
def forced_fallback():
    """The gated pair takes its fallback backward at every shape while the
    block runs (the route is chosen in the forward)."""
    from msmp_pde_torch.ops import mp_pair

    rule = mp_pair.pair_bwd_fused_fits
    mp_pair.pair_bwd_fused_fits = lambda *a, **k: False
    try:
        yield
    finally:
        mp_pair.pair_bwd_fused_fits = rule


def fallback_step(trainer, u_all):
    """Phase 13, the fallback's main path: one MSMP-PDE optimizer step at
    batch 48 through ``train_step_fn`` with the fallback forced, every pair
    on the stash forward and two single-layer backwards. Returns the launch
    counts of the run."""
    import numpy as np
    import torch

    dev = trainer.device
    B = len(u_all)
    step = trainer.train_step_fn(
        trainer.make_optimizer(1e-4, 0.4, [1], 250), 0)
    st = torch.as_tensor(np.random.default_rng(48).integers(25, 226, B),
                         device=dev)
    reset_counts()
    with forced_fallback():
        loss = step(u_all, {}, torch.arange(B, device=dev), st)
    counts = launch_counts()
    L = trainer.model.layers
    want = expected_launches(trainer.model, 1, 1)
    want.update(mp_pair_fwd_stash=L, mp_pair_bwd=0, mp_layer_bwd=2 * L)
    check(counts == want, f"MSMP-PDE step at batch {B}: launches "
          f"{nonzero(counts)}, expected {nonzero(want)}")
    check(bool(torch.isfinite(loss)), "batch-48 loss not finite")
    print(f"MSMP-PDE train step at batch {B}: loss {loss.item():.4f}, "
          f"launches {nonzero(counts)}")
    return counts


def time_rollouts(engine, name):
    """Phases 6 and 16: closed-loop rollout latency per bucket."""
    import numpy as np

    nx, T = engine.trainer.spec.nx, engine.trainer.tw
    for B in BUCKETS:
        w = np.random.default_rng(B).normal(size=(B, nx, T)).astype(
            np.float32)
        lats = []
        for _ in range(ROLLOUT_SAMPLES):
            t0 = time.perf_counter()
            engine.rollout(w, n_windows=N_WINDOWS)
            lats.append((time.perf_counter() - t0) * 1e3)
        p50, p90 = np.percentile(lats, [50, 90])
        print(f"{name} rollout bucket {B} x {N_WINDOWS} windows, closed "
              f"loop, {ROLLOUT_SAMPLES} requests: p50 {p50:.3f} ms, p90 "
              f"{p90:.3f} ms, {B * N_WINDOWS / p50 * 1e3:.1f} "
              "sample-windows/s at p50")


def time_forwards(trainer, window, steps, name, per_kernel):
    """Phases 6 and 16: one model forward at buckets 1 and 16, CUDA events
    beside the host's enqueue time; ``per_kernel``: {bucket: text on the
    kernels' share}."""
    import torch

    for B in (1, 16):
        w, st = window[:B], steps[:B]
        with torch.no_grad():
            ms = timed(lambda: trainer.forward(w, st, {}), reps=5)
            hms = host_ms(lambda: trainer.forward(w, st, {}))
        print(f"{name} forward @bucket {B}: {ms:.4f} ms (CUDA events; host "
              f"enqueue {hms:.4f} ms; {per_kernel[B]})")


def time_train_steps(trainer, u_all, name):
    """Phases 11 and 16: one optimizer step at batch 16, unrolled 0 and 1,
    CUDA events beside the host's enqueue time."""
    import torch

    dev = trainer.device
    tx = trainer.make_optimizer(1e-4, 0.4, [1, 5, 10, 15], 250)
    idx_b = torch.arange(TRAIN_BATCH, device=dev)
    st = torch.full((TRAIN_BATCH,), 100, dtype=torch.int64, device=dev)
    for f in (0, 1):
        step = trainer.train_step_fn(tx, f)
        ms = timed(lambda: step(u_all, {}, idx_b, st), reps=5)
        hms = host_ms(lambda: step(u_all, {}, idx_b, st), reps=3)
        print(f"{name} train step @batch {TRAIN_BATCH} unrolled={f}: "
              f"{ms:.4f} ms, {TRAIN_BATCH / ms * 1e3:.1f} samples/s (host "
              f"enqueue {hms:.4f} ms)")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "msmp_pde_torch" / "csrc").is_dir():
        fail(f"no msmp_pde_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from msmp_pde_torch.data.graph import build_neighbors_radius
    from msmp_pde_torch.models.gnn import GNNLayer
    from msmp_pde_torch.ops import _build, lem_scan, mp_layer, mp_pair
    from msmp_pde_torch.serving.engine import (
        RolloutEngine,
        build_serving_trainer,
    )
    from msmp_pde_torch.tools.lem_times import lem_args
    from msmp_pde_torch.training.setup import build_trainer
    from msmp_pde_torch.utils.convert import params_from_flax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale,
                            dtype=torch.float32, device=dev)

    # 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s for "
          f"{', '.join(sorted(reports))}")
    for name, text in sorted(reports.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for H in (128, 96):
        fwd = {N: lem_scan.lem_launch_shape(N, H) for N in (100, 1600)}
        bwd = lem_scan.lem_launch_shape(1600, H, backward=True)
        print(f"  LEM clusters at hidden {H} (rows a cluster, CTAs a cluster, "
              f"CTAs, dynamic shared bytes a CTA): lem_fwd N=100 {fwd[100]}, "
              f"N=1600 {fwd[1600]}; lem_bwd N=1600 {bwd}")

    # 2. LEM-scan kernel vs plain ----------------------------------------
    T = 25
    err = {"lem_fwd": 0.0, "mp_pair_fwd": 0.0}
    for H, N in LEM_CASES:
        args = lem_args(rand, T, N, H)
        yk, zk = lem_scan.lem_scan(*args)
        again = lem_scan.lem_scan(*args)
        yp, zp = lem_scan.lem_scan_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(yk, again[0]) and torch.equal(zk, again[1]),
              f"lem_fwd N={N} H={H}: two runs differ")
        e = max((yk - yp).abs().max().item(), (zk - zp).abs().max().item())
        err["lem_fwd"] = max(err["lem_fwd"], e)
        print(f"lem_fwd N={N} H={H}: max |kernel - plain| = {e:.3e}; two "
              "runs bitwise equal")
        check(e <= TOL_LEM,
              f"lem_fwd N={N} H={H} differs by {e:.3e} > {TOL_LEM}")
    H = 128

    # 4 (set-up). full-width serving trainer and converted weights -------
    trainer = build_serving_trainer("E1", "MSMP-PDE", device=dev)
    model = trainer.model
    params = params_from_flax(flax_tree(model, seed=0))
    n_params = sum(v.numel() for v in params.values())
    print(f"MSMP-PDE E1: {n_params} parameters")
    engine = RolloutEngine(trainer, params, batch_buckets=BUCKETS)
    spec = trainer.spec
    nx, K = spec.idx.shape
    V = 1 + len(trainer.eq_norms)

    # 3. fused gated-pair kernel vs plain, at the model's own weights ----
    Wg, Wl = model.gate_0.weights(), model.gnn_0.weights()
    pair_args = {}
    cases = [(B, nx, H, V, spec.idx, spec.mask, Wg, Wl)
             for B in BUCKETS + (48,)]
    # a width that no 64-column tile divides, three variables, radius 2
    odd_idx, odd_mask = build_neighbors_radius(np.linspace(0.0, 16.0, 40), 2)
    odd_gen = torch.Generator().manual_seed(4)
    cases.append((2, 40, 96, 3, torch.as_tensor(odd_idx, device=dev),
                  torch.as_tensor(odd_mask, device=dev),
                  *[GNNLayer(96, T, 3, odd_gen).to(dev).weights()
                    for _ in "gl"]))
    with torch.no_grad():
        for B, n, h, v, idx, mask, wg, wl in cases:
            px = (spec.x.expand(B, nx)[..., None] / spec.L if n == nx else
                  torch.linspace(0, 1, n, device=dev).expand(B, n)[..., None])
            args = (rand(B, n, h), rand(B, n, T), px,
                    rand(B, n, v, scale=.5), idx, mask, wg, wl)
            if n == nx:
                pair_args[B] = args
            ok = mp_pair.fused_gated_pair(*args)
            again = mp_pair.fused_gated_pair(*args)
            op = mp_pair.fused_gated_pair_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(ok, again),
                  f"mp_pair_fwd B={B} H={h}: two runs differ")
            e = (ok - op).abs().max().item()
            err["mp_pair_fwd"] = max(err["mp_pair_fwd"], e)
            print(f"mp_pair_fwd B={B} nx={n} H={h}: max |kernel - plain| = "
                  f"{e:.3e}; two runs bitwise equal")
            check(e <= TOL_PAIR,
                  f"mp_pair_fwd B={B} H={h} differs by {e:.3e} > {TOL_PAIR}")

    # 4. whole model, kernel path vs plain path --------------------------
    B = 16
    window = rand(B, nx, T)
    steps = torch.full((B,), T, dtype=torch.int64, device=dev)
    check_model_forward(trainer, window, steps, "MSMP-PDE")

    # 5. the main path: HTTP rollout requests ----------------------------
    main_counts = serve_path(engine, "MSMP-PDE")
    main_lem, main_pair = main_counts["lem_fwd"], main_counts["mp_pair_fwd"]

    # 6. timings at the bucket-16 shapes ---------------------------------
    N = 16 * nx
    largs = (rand(T, N, 3 * H), rand(T, N, H), rand(N, H), rand(N, H),
             rand(H, 3 * H, scale=H ** -.5), rand(H, H, scale=H ** -.5))
    lem_ms = timed(lambda: lem_scan.lem_scan(*largs))
    lem_eager_ms = timed(lambda: lem_scan.lem_scan_plain(*largs))
    lem_plain_ms = timed_graph(lambda: lem_scan.lem_scan_plain(*largs))
    lem_bytes = 4 * (T * N * 4 * H + 4 * N * H + 4 * H * H)
    lem_flops = T * N * (2 * H * 3 * H + 2 * H * H)
    # every LEM product runs in 3xTF32 on the tensor cores
    lem_bound, lem_by = bound(lem_bytes, 0, lem_flops)

    D = T
    w_elems = sum(w.numel() for w in Wg) + sum(w.numel() for w in Wl)
    e_valid = float(spec.mask.sum().item())
    # i side with mix (u w_du + px w_dx, counted once), j side h w_hj,
    # edge w2 over the valid edges, update w3 and w4. The edge products
    # (w2 here; dw2 and dm1 in the backward) run in 3xTF32 on the tensor
    # cores (csrc/mp_phases.cuh), the rest as float32 FMAs.
    edge = 2 * e_valid * H * H
    per_layer = (2 * nx * (H + D + 1 + V) * H + 2 * nx * H * H
                 + edge + 2 * nx * (2 * H + V) * H + 2 * nx * H * H)
    print(f"lem_fwd @bucket 16: kernel {lem_ms:.4f} ms, plain "
          f"{lem_plain_ms:.4f} ms (CUDA graph; {lem_eager_ms:.4f} ms eager), "
          f"bound {lem_bound:.4f} ms ({lem_by})")
    pair_times = {}  # bucket: (kernel, plain, eager, bound ms, bound by)
    for B in (1, 16):
        pargs = pair_args[B]
        with torch.no_grad():
            ms = timed(lambda: mp_pair.fused_gated_pair(*pargs))
            ems = timed(lambda: mp_pair.fused_gated_pair_plain(*pargs))
            pms = timed_graph(lambda: mp_pair.fused_gated_pair_plain(*pargs))
        bms, by = bound(
            4 * (B * nx * (2 * H + D + 1 + V) + 2 * nx * K + w_elems),
            B * 2 * (per_layer - edge), B * 2 * edge)
        pair_times[B] = (ms, pms, ems, bms, by)
        print(f"mp_pair_fwd @bucket {B}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms (CUDA graph; {ems:.4f} ms eager), bound "
              f"{bms:.4f} ms ({by})")
    pair_ms, pair_plain_ms, _, pair_bound, pair_by = pair_times[16]

    time_forwards(trainer, window, steps, "MSMP-PDE", {
        B: f"pairs 6 x {pair_times[B][0]:.4f}" + (
            f", LEM 1 x {lem_ms:.4f}" if B == 16 else "") for B in (1, 16)})
    time_rollouts(engine, "MSMP-PDE")

    # 7-10. training: kernels vs plain, one step, the main path ----------
    e_stash, e_lbwd = check_lem_training_kernels(rand, T)
    train_tr = build_trainer("E1", "MSMP-PDE", device=dev)
    train_tr.model.load_state_dict(params, strict=True)
    e_pbwd, pbwd_args = check_pair_bwd(rand, train_tr.model, train_tr.spec, T,
                                       H, V)
    u_all = torch.as_tensor(smooth_trajectories(
        16, spec.t_grid.cpu().numpy(), spec.x.cpu().numpy(), spec.L, seed=0),
        device=dev)
    check_train_step(train_tr, u_all, np.random.default_rng(1))
    train_launches, epoch_s = train_main_path(train_tr, u_all)

    # 11. training timings -----------------------------------------------
    stash_ms = timed(lambda: lem_scan.lem_scan_kernel(*largs, stash=True))
    stash_eager_ms = timed(
        lambda: lem_scan.lem_scan_plain(*largs, stash=True))
    stash_plain_ms = timed_graph(
        lambda: lem_scan.lem_scan_plain(*largs, stash=True))
    stash_bound, stash_by = bound(lem_bytes + 4 * 2 * T * N * H, 0,
                                  lem_flops)
    _, _, ys, zs = lem_scan.lem_scan_plain(*largs, stash=True)
    bargs = (*largs, ys, zs, rand(N, H), rand(N, H))
    lbwd_ms = timed(lambda: lem_scan.lem_scan_bwd_kernel(*bargs))
    lbwd_eager_ms = timed(lambda: lem_scan.lem_scan_bwd_plain(*bargs))
    lbwd_plain_ms = timed_graph(lambda: lem_scan.lem_scan_bwd_plain(*bargs))
    # reads gx, zx, ys, zs, y0, z0, dyT, dzT, Wy, Wzz; writes dgx, dzx, dy0,
    # dz0, dWy, dWzz. Operations: the sweep's four recurrent products
    # (16 H^2 a row-step) and the two weight gradients (8 H^2 a row-step).
    lbwd_flops = 24 * T * N * H * H
    lbwd_bound, lbwd_by = bound(
        4 * (10 * T * N * H + 6 * N * H + 8 * H * H), 0, lbwd_flops)
    pbwd_ms = timed(lambda: mp_pair.fused_gated_pair_bwd_kernel(*pbwd_args))
    pbwd_eager_ms = timed(
        lambda: mp_pair.fused_gated_pair_bwd_plain(*pbwd_args))
    pbwd_plain_ms = timed_graph(
        lambda: mp_pair.fused_gated_pair_bwd_plain(*pbwd_args))
    # the pair's backward needs both layers' forward and backward:
    # dw4, da3, dw3, dh|dagg, dw2 and dm1 over the valid edges, dh from
    # ds_i|ds_j, dw_hi|dw_hj, dw_du|dw_dx|dw_v
    bwd_layer = (2 * nx * H * H * 2 + 2 * nx * (2 * H + V) * H
                 + 2 * nx * H * 2 * H + 2 * edge
                 + 2 * nx * 2 * H * H + 2 * nx * H * 2 * H
                 + 2 * nx * (D + 1 + V) * H)
    # a layer's forward and backward: three edge products on the tensor
    # cores, the rest on the CUDA cores
    fb_core = per_layer + bwd_layer - 3 * edge
    pbwd_bound, pbwd_by = bound(
        4 * (16 * nx * (3 * H + D + 1 + V) + 2 * nx * K + 2 * w_elems),
        16 * 2 * fb_core, 16 * 2 * 3 * edge)
    lem_card_times(rand, T, H)
    # the LEM bounds take every product as 3xTF32 (the kernels' type);
    # the same products as float32 FMAs on the CUDA cores, beside them
    for name, flops in (("lem_fwd", lem_flops), ("lem_bwd", lbwd_flops)):
        print(f"{name} @N={N}: {flops:.3e} FLOP as float32 on the CUDA "
              f"cores (67 TFLOP/s) {flops / F32_FLOP_S * 1e3:.4f} ms, in "
              f"3xTF32 (495/3 TFLOP/s) {3 * flops / TF32_FLOP_S * 1e3:.4f} "
              "ms")
    for name, ms, pms, ems, bms, by in (
            ("lem_fwd_stash", stash_ms, stash_plain_ms, stash_eager_ms,
             stash_bound, stash_by),
            ("lem_bwd", lbwd_ms, lbwd_plain_ms, lbwd_eager_ms, lbwd_bound,
             lbwd_by),
            ("mp_pair_bwd", pbwd_ms, pbwd_plain_ms, pbwd_eager_ms,
             pbwd_bound, pbwd_by)):
        print(f"{name} @batch 16: kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"(CUDA graph; {ems:.4f} ms eager), bound {bms:.4f} ms ({by})")
    time_train_steps(train_tr, u_all, "MSMP-PDE")
    print(f"train_epoch (250 steps): {epoch_s:.3f} s")

    # 12. the single-layer kernels vs plain, at MP-PDE's weights ---------
    mp_tr = build_serving_trainer("E1", "MP-PDE", device=dev)
    mp_params = params_from_flax(flax_tree(mp_tr.model, seed=1))
    print(f"MP-PDE E1: {sum(v.numel() for v in mp_params.values())} "
          "parameters")
    mp_engine = RolloutEngine(mp_tr, mp_params, batch_buckets=BUCKETS)
    e_lfwd, e_lbwd_layer = check_layer_kernels(
        rand, mp_tr.model.gnn_0.weights(), spec, T, H, V)

    # 13. the pair's stash variant and fallback route --------------------
    e_pstash, e_fb, (args48, gn48, ln48, g48) = check_pair_fallback(
        rand, train_tr.model, spec, T, H, V)
    u48 = torch.as_tensor(smooth_trajectories(
        48, spec.t_grid.cpu().numpy(), spec.x.cpu().numpy(), spec.L, seed=1),
        device=dev)
    fb_counts = fallback_step(train_tr, u48)
    del u48

    # 14. MP-PDE and LEM forwards; the served MP-PDE ---------------------
    lem_tr = build_serving_trainer("E1", "LEM", device=dev)
    lem_params = params_from_flax(flax_tree(lem_tr.model, seed=2))
    lem_tr.model.load_state_dict(lem_params, strict=True)
    check_model_forward(mp_tr, window, steps, "MP-PDE")
    check_model_forward(lem_tr, window, steps, "LEM")
    mp_counts = serve_path(mp_engine, "MP-PDE")

    # 15. training MP-PDE and LEM; the MP-PDE epoch ----------------------
    trainers = {}
    for name, p in (("MP-PDE", mp_params), ("LEM", lem_params)):
        trainers[name] = build_trainer("E1", name, device=dev)
        trainers[name].model.load_state_dict(p, strict=True)
        check_train_step(trainers[name], u_all, np.random.default_rng(1),
                         name)
    mp_train = trainers["MP-PDE"]
    mp_train_counts, mp_epoch_s = train_main_path(mp_train, u_all, "MP-PDE")

    # 16. timings of the slice's kernels and of MP-PDE -------------------
    W1 = tuple(w.detach() for w in mp_tr.model.gnn_0.weights())
    w_one = sum(w.numel() for w in W1)
    largs16 = (*pair_args[16][:6], W1)
    g16 = rand(16, nx, H)
    with torch.no_grad():
        largs1 = (*pair_args[1][:6], W1)
        lf1_ms = timed(
            lambda: mp_layer.fused_mp_layer_kernel(*largs1, True, True))
        lf1_eager_ms = timed(
            lambda: mp_layer.fused_mp_layer_plain(*largs1, True, True))
        lf1_plain_ms = timed_graph(
            lambda: mp_layer.fused_mp_layer_plain(*largs1, True, True))
        lf_ms = timed(
            lambda: mp_layer.fused_mp_layer_kernel(*largs16, True, True))
        lf_eager_ms = timed(
            lambda: mp_layer.fused_mp_layer_plain(*largs16, True, True))
        lf_plain_ms = timed_graph(
            lambda: mp_layer.fused_mp_layer_plain(*largs16, True, True))
        lb_ms = timed(lambda: mp_layer.fused_mp_layer_bwd_kernel(
            *largs16, g16, True, True))
        lb_eager_ms = timed(lambda: mp_layer.fused_mp_layer_bwd_plain(
            *largs16, g16, True, True))
        lb_plain_ms = timed_graph(lambda: mp_layer.fused_mp_layer_bwd_plain(
            *largs16, g16, True, True))
        st_ms = timed(
            lambda: mp_pair.fused_gated_pair_kernel(*args48, stash=True))
        st_eager_ms = timed(
            lambda: mp_pair.fused_gated_pair_plain(*args48, stash=True))
        st_plain_ms = timed_graph(
            lambda: mp_pair.fused_gated_pair_plain(*args48, stash=True))
        pargs16 = (*pair_args[16][:6], *args48[6:])
        st16_ms = timed(
            lambda: mp_pair.fused_gated_pair_kernel(*pargs16, stash=True))
        nost16_ms = timed(lambda: mp_pair.fused_gated_pair_kernel(*pargs16))
        fused48_ms = timed(
            lambda: mp_pair.fused_gated_pair_bwd_kernel(*args48, g48))
        fb48_ms = timed(
            lambda: mp_pair.fallback_bwd(*args48, gn48, ln48, g48))
        # the same two routes at batch 16, where the fused one is taken
        _, gn16, ln16 = mp_pair.fused_gated_pair_kernel(*pargs16, stash=True)
        fused16_ms = timed(
            lambda: mp_pair.fused_gated_pair_bwd_kernel(*pargs16, g16))
        fb16_ms = timed(
            lambda: mp_pair.fallback_bwd(*pargs16, gn16, ln16, g16))
    # one layer as the pair counts one (plus the residual's read of h and
    # final swish, elementwise); the backward as the pair's, for one layer
    lf_bound, lf_by = bound(
        4 * (16 * nx * (2 * H + D + 1 + V) + 2 * nx * K + w_one),
        16 * (per_layer - edge), 16 * edge)
    lf1_bound, lf1_by = bound(
        4 * (nx * (2 * H + D + 1 + V) + 2 * nx * K + w_one),
        per_layer - edge, edge)
    lb_bound, lb_by = bound(
        4 * (16 * nx * (3 * H + D + 1 + V) + 2 * nx * K + 2 * w_one),
        16 * fb_core, 16 * 3 * edge)
    # the pair forward at batch 48 with gn and ln written too
    st_bound, st_by = bound(
        4 * (48 * nx * (4 * H + D + 1 + V) + 2 * nx * K + w_elems),
        48 * 2 * (per_layer - edge), 48 * 2 * edge)
    for name, at, ms, pms, ems, bms, by in (
            ("mp_layer_fwd", "batch 1", lf1_ms, lf1_plain_ms, lf1_eager_ms,
             lf1_bound, lf1_by),
            ("mp_layer_fwd", "batch 16", lf_ms, lf_plain_ms, lf_eager_ms,
             lf_bound, lf_by),
            ("mp_layer_bwd", "batch 16", lb_ms, lb_plain_ms, lb_eager_ms,
             lb_bound, lb_by),
            ("mp_pair_fwd_stash", "batch 48", st_ms, st_plain_ms,
             st_eager_ms, st_bound, st_by)):
        print(f"{name} @{at}: kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"(CUDA graph; {ems:.4f} ms eager), bound {bms:.4f} ms ({by})")
    print(f"mp_pair_fwd @batch 16: stash {st16_ms:.4f} ms, no stash "
          f"{nost16_ms:.4f} ms")
    for at, fused_ms, fb_ms in ((48, fused48_ms, fb48_ms),
                                (16, fused16_ms, fb16_ms)):
        print(f"pair backward @batch {at}: fused kernel {fused_ms:.4f} ms, "
              f"fallback route (combine + 2 x mp_layer_bwd) {fb_ms:.4f} ms")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = mp_layer.grid_blocks
    print("cooperative grid (blocks on %d SMs): mp_pair_fwd %d / %d (stash), "
          "mp_pair_bwd %d, mp_layer_fwd %d / %d, mp_layer_bwd %d / %d "
          "(GNN_Layer / GNN_LayerLin)" % (
              sms, grid("mp_pair_fwd"), grid("mp_pair_fwd", True),
              grid("mp_pair_bwd"), grid("mp_layer_fwd", True),
              grid("mp_layer_fwd"), grid("mp_layer_bwd", True),
              grid("mp_layer_bwd")))
    time_forwards(mp_tr, window, steps, "MP-PDE", {
        1: f"layers 6 x {lf1_ms:.4f}", 16: f"layers 6 x {lf_ms:.4f}"})
    time_rollouts(mp_engine, "MP-PDE")
    time_train_steps(mp_train, u_all, "MP-PDE")
    print(f"MP-PDE train_epoch (250 steps): {mp_epoch_s:.3f} s")

    kernels = [
        {"name": "lem_fwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/lem_fwd.cu",
         "replaces": "msmp_pde_tpu/ops/lem_pallas.py:41",
         "launches": main_lem, "max_abs_err": err["lem_fwd"],
         "ms": lem_ms, "plain_ms": lem_plain_ms, "bound_ms": lem_bound,
         "bound_by": lem_by, "library_ms": None},
        {"name": "mp_pair_fwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_pair_fwd.cu",
         "replaces": "msmp_pde_tpu/ops/mp_pallas.py:260",
         "launches": main_pair, "max_abs_err": err["mp_pair_fwd"],
         "ms": pair_ms, "plain_ms": pair_plain_ms, "bound_ms": pair_bound,
         "bound_by": pair_by, "library_ms": None},
        {"name": "lem_fwd_stash", "route": "cuda",
         "source": "msmp_pde_torch/csrc/lem_fwd.cu",
         "replaces": "msmp_pde_tpu/ops/lem_pallas.py:41",
         "launches": train_launches["lem_fwd_stash"], "max_abs_err": e_stash,
         "ms": stash_ms, "plain_ms": stash_plain_ms, "bound_ms": stash_bound,
         "bound_by": stash_by, "library_ms": None},
        {"name": "lem_bwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/lem_bwd.cu",
         "replaces": "msmp_pde_tpu/ops/lem_pallas.py:73",
         "launches": train_launches["lem_bwd"], "max_abs_err": e_lbwd,
         "ms": lbwd_ms, "plain_ms": lbwd_plain_ms, "bound_ms": lbwd_bound,
         "bound_by": lbwd_by, "library_ms": None},
        {"name": "mp_pair_bwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_pair_bwd.cu",
         "replaces": "msmp_pde_tpu/ops/mp_pallas.py:291",
         "launches": train_launches["mp_pair_bwd"], "max_abs_err": e_pbwd,
         "ms": pbwd_ms, "plain_ms": pbwd_plain_ms, "bound_ms": pbwd_bound,
         "bound_by": pbwd_by, "library_ms": None},
        {"name": "mp_layer_fwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_layer_fwd.cu",
         "replaces": "msmp_pde_tpu/ops/mp_pallas.py:156",
         "launches": mp_counts["mp_layer_fwd"], "max_abs_err": e_lfwd,
         "ms": lf_ms, "plain_ms": lf_plain_ms, "bound_ms": lf_bound,
         "bound_by": lf_by, "library_ms": None},
        {"name": "mp_layer_bwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_layer_bwd.cu",
         "replaces": "msmp_pde_tpu/ops/mp_pallas.py:228",
         "launches": mp_train_counts["mp_layer_bwd"],
         "max_abs_err": e_lbwd_layer, "ms": lb_ms, "plain_ms": lb_plain_ms,
         "bound_ms": lb_bound, "bound_by": lb_by, "library_ms": None},
        {"name": "mp_pair_fwd_stash", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_pair_fwd.cu",
         "replaces": "msmp_pde_tpu/ops/mp_pallas.py:260",
         "launches": fb_counts["mp_pair_fwd_stash"], "max_abs_err": e_pstash,
         "ms": st_ms, "plain_ms": st_plain_ms, "bound_ms": st_bound,
         "bound_by": st_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
