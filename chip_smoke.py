#!/usr/bin/env python3
"""Smoke and measurement run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. build every CUDA kernel (serving and training) from
     msmp_pde_torch/csrc, printing ptxas's registers and spills;
  2. LEM-scan kernel vs its plain PyTorch version, N in {100, 400, 1600, 37};
  3. fused gated-pair kernel vs its plain version, B in {1, 4, 16};
  4. the full-width MSMP-PDE forward (E1: nx=100, tw=25, hidden 128, six
     gated pairs) with weights made from a numpy seed in the flax layout
     and carried across by params_from_flax: kernel path vs
     reference_forward, the same forward through the plain versions;
  5. the main path: the port's HTTP server on localhost answers rollout
     requests (B = 1, 3, 16, 20, and one trajectory) at n_windows=8, each
     checked against RolloutEngine.rollout and against the expected kernel
     launch counts;
  6. timings (CUDA events, medians) of each kernel beside its plain
     version (replayed from a CUDA graph, and eager) and its bound, and
     request latency per bucket;
  7. the LEM-scan stash variant and backward kernel vs their plain
     versions, N in {100, 400, 1600, 37};
  8. the fused-pair backward kernel vs its plain version, B in {1, 4, 16}
     with the model's weights and one width no 64-column tile divides; two
     runs give bitwise equal gradients;
  9. one training step at batch 16, kernel path vs plain path (the loss
     and every parameter's gradient, unrolled 0 and 1);
 10. the training main path: one train_epoch (epoch 1, unrolling 1, batch
     16, lr 1e-4) over 16 smooth in-memory trajectories of E1's shape
     [16, 250, 100], i.e. 250 optimizer steps, each with the expected
     kernel launches, finite losses, and a falling loss;
 11. timings of the three training kernels beside their plain versions and
     bounds, and of one train step at unrolled 0 and 1.

Comparisons run in full float32 (TF32 off for matmuls and cuDNN convs).
Exits non-zero, printing no result, without CUDA or outside a checkout.
The last line is {"ok": true, "device": {...}}.
"""
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks: HBM bytes/s, float32 FLOP/s outside tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
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
    pairs: b4 (``TorchDense_2.bias``) takes its layer's w4 gradient's."""
    named = dict(named)
    w4 = lambda n: named[n[:-len("bias")] + "kernel"]
    return {n: (w4(n) if n.endswith("TorchDense_2.bias") else g)
            .abs().max().item() for n, g in named.items()}


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


def bound(nbytes, flops):
    t_mem, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
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
    """MPSolver.forward written out through the plain versions of both
    kernels (``lem_scan_plain``, ``fused_gated_pair_plain``) on the model's
    own parameters: the on-card reference of the kernel path."""
    import torch

    from msmp_pde_torch.models.common import swish
    from msmp_pde_torch.ops.lem_scan import lem_scan_plain
    from msmp_pde_torch.ops.mp_pair import fused_gated_pair_plain

    B, nx, tw = window.shape
    V, H = var_vec.shape[-1], model.hidden
    px_n = pos_x / model.L
    variables = var_vec[:, None, :].expand(B, nx, V)
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
        h = fused_gated_pair_plain(
            h, window, px_n[..., None], variables, idx, mask,
            getattr(model, f"gate_{i}").weights(),
            getattr(model, f"gnn_{i}").weights())
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


def check_lem_training_kernels(rand, T, H):
    """Phase 7: returns (stash max error, backward max error)."""
    import torch

    from msmp_pde_torch.ops import lem_scan

    e_stash = e_bwd = 0.0
    names = ("dgx", "dzx", "dy0", "dz0", "dwy", "dwzz")
    for N in (100, 400, 1600, 37):
        args = (rand(T, N, 3 * H), rand(T, N, H), rand(N, H, scale=.5),
                rand(N, H, scale=.5), rand(H, 3 * H, scale=H ** -.5),
                rand(H, H, scale=H ** -.5))
        k = lem_scan.lem_scan_kernel(*args, stash=True)
        p = lem_scan.lem_scan_plain(*args, stash=True)
        torch.cuda.synchronize()
        e = max((a - b).abs().max().item() for a, b in zip(k, p))
        e_stash = max(e_stash, e)
        print(f"lem_fwd_stash N={N}: max |kernel - plain| = {e:.3e}")
        check(e <= TOL_LEM, f"lem_fwd_stash N={N} differs by {e:.3e}")
        cot = (rand(N, H), rand(N, H))
        gk = lem_scan.lem_scan_bwd_kernel(*args, *p[2:], *cot)
        gp = lem_scan.lem_scan_bwd_plain(*args, *p[2:], *cot)
        torch.cuda.synchronize()
        for name, a, b in zip(names, gk, gp):
            atol = LEM_BWD_ATOL
            if name.startswith("dw"):
                atol *= b.abs().max().item()
            e = (a - b).abs().max().item()
            e_bwd = max(e_bwd, e)
            check(bool(torch.allclose(a, b, rtol=LEM_BWD_RTOL, atol=atol)),
                  f"lem_bwd N={N} {name}: max |diff| {e:.3e}, atol {atol}")
        print(f"lem_bwd N={N}: all six outputs within rtol {LEM_BWD_RTOL} "
              f"(max |kernel - plain| {e_bwd:.3e})")
    return e_stash, e_bwd


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
    cases = [(B, nx, H, V, spec.idx, spec.mask, Wg, Wl) for B in (1, 4, 16)]
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


def check_train_step(trainer, u_all, rng):
    """Phase 9: one step's loss and gradients, kernel path vs plain path."""
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
              f"train step unrolled={unrolled}: loss {loss_k.item()} vs "
              f"{loss_p.item()}")
        worst = 0.0
        scales = grad_scales(zip(names, grads_p))
        for name, a, b in zip(names, grads_k, grads_p):
            check(bool(torch.isfinite(a).all()), f"{name}: grad not finite")
            ok, e = scale_aware(a, b, scales[name])
            worst = max(worst, e)
            check(ok, f"train step unrolled={unrolled}: {name} grad "
                  f"differs by {e:.3e}")
        print(f"train step B={TRAIN_BATCH} unrolled={unrolled}: loss "
              f"{loss_k.item():.6f} (plain {loss_p.item():.6f}, rel "
              f"{rel:.2e}); {len(params)} grads within the scale-aware "
              f"bound (max |diff| {worst:.3e})")


def train_main_path(trainer, u_all):
    """Phase 10: one train_epoch; returns the launch counts of the run."""
    import numpy as np

    from msmp_pde_torch.ops import lem_scan, mp_pair
    from msmp_pde_torch.training.loop import train_epoch

    nt = u_all.shape[1]
    tx = trainer.make_optimizer(1e-4, 0.4, [1, 5, 10, 15], nt)
    counters = lambda: (lem_scan.launches, lem_scan.stash_launches,
                        mp_pair.launches, mp_pair.bwd_launches,
                        lem_scan.bwd_launches)
    lem_scan.launches = lem_scan.stash_launches = 0
    lem_scan.bwd_launches = 0
    mp_pair.launches = mp_pair.bwd_launches = 0
    per_step, last = [], [counters()]

    def on_step(flag):
        now = counters()
        per_step.append((flag, tuple(a - b for a, b in zip(now, last[0]))))
        last[0] = now

    t0 = time.perf_counter()
    mean, losses = train_epoch(trainer, tx, u_all, {}, epoch=1,
                               batch_size=TRAIN_BATCH, t_res=nt,
                               unrolling=1, rng=np.random.default_rng(0),
                               print_interval=50, on_step=on_step)
    took = time.perf_counter() - t0
    totals = counters()
    losses = losses.reshape(-1)
    print(f"train_epoch: {len(losses)} steps in {took:.3f} s, mean loss / "
          f"batch {mean:.6f}")
    print("pass losses: " + " ".join(f"{v:.4g}" for v in losses))
    check(len(per_step) == len(losses) == nt, "train_epoch step count")
    for i, (f, d) in enumerate(per_step):
        want = (f + 1, 1, 6 * (f + 1), 6, 1)
        check(d == want, f"step {i} (unrolled {f}): launches lem_fwd, "
              f"lem_fwd_stash, mp_pair_fwd, mp_pair_bwd, lem_bwd = {d}, "
              f"expected {want}")
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
        check(final < first, f"the loss at unrolled {f} did not fall")
    flags = flags.tolist()
    print(f"main path launches: lem_fwd {totals[0]} (of which stash "
          f"{totals[1]}), mp_pair_fwd {totals[2]}, mp_pair_bwd {totals[3]}, "
          f"lem_bwd {totals[4]}; steps at unrolled 0/1: {flags.count(0)}/"
          f"{flags.count(1)}")
    return dict(zip(("lem_fwd", "lem_fwd_stash", "mp_pair_fwd",
                     "mp_pair_bwd", "lem_bwd"), totals)), took


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "msmp_pde_torch" / "csrc").is_dir():
        fail(f"no msmp_pde_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from msmp_pde_torch.ops import _build, lem_scan, mp_pair
    from msmp_pde_torch.serving import serve
    from msmp_pde_torch.serving.engine import (
        RolloutEngine,
        build_serving_trainer,
    )
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

    # 2. LEM-scan kernel vs plain ----------------------------------------
    T, H = 25, 128
    err = {"lem_fwd": 0.0, "mp_pair_fwd": 0.0}
    for N in (100, 400, 1600, 37):
        args = (rand(T, N, 3 * H), rand(T, N, H), rand(N, H, scale=.5),
                rand(N, H, scale=.5), rand(H, 3 * H, scale=H ** -.5),
                rand(H, H, scale=H ** -.5))
        yk, zk = lem_scan.lem_scan(*args)
        yp, zp = lem_scan.lem_scan_plain(*args)
        torch.cuda.synchronize()
        e = max((yk - yp).abs().max().item(), (zk - zp).abs().max().item())
        err["lem_fwd"] = max(err["lem_fwd"], e)
        print(f"lem_fwd N={N}: max |kernel - plain| = {e:.3e}")
        check(e <= TOL_LEM, f"lem_fwd N={N} differs by {e:.3e} > {TOL_LEM}")

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
    with torch.no_grad():
        for B in BUCKETS:
            args = (rand(B, nx, H), rand(B, nx, T),
                    spec.x.expand(B, nx)[..., None] / spec.L,
                    rand(B, nx, V, scale=.5), spec.idx, spec.mask, Wg, Wl)
            pair_args[B] = args
            ok = mp_pair.fused_gated_pair(*args)
            op = mp_pair.fused_gated_pair_plain(*args)
            torch.cuda.synchronize()
            e = (ok - op).abs().max().item()
            err["mp_pair_fwd"] = max(err["mp_pair_fwd"], e)
            print(f"mp_pair_fwd B={B}: max |kernel - plain| = {e:.3e}")
            check(e <= TOL_PAIR,
                  f"mp_pair_fwd B={B} differs by {e:.3e} > {TOL_PAIR}")

    # 4. whole model, kernel path vs plain path --------------------------
    B = 16
    window = rand(B, nx, T)
    steps = torch.full((B,), T, dtype=torch.int64, device=dev)
    with torch.no_grad():
        out_k, _ = trainer.forward(window, steps, {})
        out_p = reference_forward(
            model, window, spec.x.expand(B, nx),
            trainer.graph_vars(spec.t_grid[steps], {}), spec.idx, spec.mask)
    torch.cuda.synchronize()
    check(out_k.shape == (B, nx, T), f"model output {tuple(out_k.shape)}")
    check(bool(torch.isfinite(out_k).all()), "model output not finite")
    e = (out_k - out_p).abs().max().item()
    print(f"MSMP-PDE forward B={B}: max |kernel path - plain path| = {e:.3e}"
          f" (output max |.| {out_p.abs().max().item():.3e})")
    check(e <= TOL_MODEL, f"model differs by {e:.3e} > {TOL_MODEL}")

    # 5. the main path: HTTP rollout requests ----------------------------
    from http.server import ThreadingHTTPServer

    meta = {"backend": "cuda", "experiment": "E1", "model": "MSMP-PDE",
            "buckets": list(BUCKETS)}
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve.make_handler(engine, meta))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    lem_scan.launches = 0
    mp_pair.launches = 0
    served = []
    try:
        for B, traj in ((1, False), (3, False), (16, False), (20, False),
                        (4, True)):
            w = np.random.default_rng(B).normal(size=(B, nx, T)).astype(
                np.float32)
            before = (lem_scan.launches, mp_pair.launches)
            t0 = time.perf_counter()
            got = serve.request_rollout("127.0.0.1", port, w,
                                        n_windows=N_WINDOWS,
                                        as_trajectory=traj)
            lat = time.perf_counter() - t0
            served.append((B, traj, w, got, lat,
                           lem_scan.launches - before[0],
                           mp_pair.launches - before[1]))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join()
    main_lem, main_pair = lem_scan.launches, mp_pair.launches
    print(f"main path launches: lem_fwd {main_lem}, mp_pair_fwd {main_pair}")
    check(main_lem > 0 and main_pair > 0,
          "a kernel of the path was not launched on the main path")
    for B, traj, w, got, lat, d_lem, d_pair in served:
        want_lem = N_WINDOWS * -(-B // BUCKETS[-1])  # windows x chunks
        check(d_lem == want_lem and d_pair == 6 * want_lem,
              f"B={B}: launches lem {d_lem} pair {d_pair}, expected "
              f"{want_lem} and {6 * want_lem}")
        shape = ((B, N_WINDOWS * T, 1, nx) if traj
                 else (B, N_WINDOWS, nx, T))
        check(got.shape == shape, f"B={B}: response {got.shape}")
        check(bool(np.isfinite(got).all()), f"B={B}: not finite")
        kw = dict(n_windows=N_WINDOWS)
        direct = (engine.trajectory(w, **kw) if traj
                  else engine.rollout(w, **kw))
        check(np.array_equal(got, direct),
              f"B={B}: served result differs from engine.rollout")
        print(f"served B={B}{' trajectory' if traj else ''}: {got.shape}, "
              f"{lat * 1e3:.3f} ms, launches lem {d_lem} pair {d_pair}")

    # 6. timings at the bucket-16 shapes ---------------------------------
    N = 16 * nx
    largs = (rand(T, N, 3 * H), rand(T, N, H), rand(N, H), rand(N, H),
             rand(H, 3 * H, scale=H ** -.5), rand(H, H, scale=H ** -.5))
    lem_ms = timed(lambda: lem_scan.lem_scan(*largs))
    lem_eager_ms = timed(lambda: lem_scan.lem_scan_plain(*largs))
    lem_plain_ms = timed_graph(lambda: lem_scan.lem_scan_plain(*largs))
    lem_bytes = 4 * (T * N * 4 * H + 4 * N * H + 4 * H * H)
    lem_flops = T * N * (2 * H * 3 * H + 2 * H * H)
    lem_bound, lem_by = bound(lem_bytes, lem_flops)

    pargs = pair_args[16]
    with torch.no_grad():
        pair_ms = timed(lambda: mp_pair.fused_gated_pair(*pargs))
        pair_eager_ms = timed(
            lambda: mp_pair.fused_gated_pair_plain(*pargs))
        pair_plain_ms = timed_graph(
            lambda: mp_pair.fused_gated_pair_plain(*pargs))
    D = T
    w_elems = sum(w.numel() for w in Wg) + sum(w.numel() for w in Wl)
    pair_bytes = 4 * (16 * nx * (2 * H + D + 1 + V) + 2 * nx * K + w_elems)
    e_valid = float(spec.mask.sum().item())
    # i side with mix (u w_du + px w_dx, counted once), j side h w_hj,
    # edge w2 over the valid edges, update w3 and w4
    per_layer = (2 * nx * (H + D + 1 + V) * H + 2 * nx * H * H
                 + 2 * e_valid * H * H + 2 * nx * (2 * H + V) * H
                 + 2 * nx * H * H)
    pair_flops = 16 * 2 * per_layer
    pair_bound, pair_by = bound(pair_bytes, pair_flops)
    for name, ms, pms, ems, bms, by in (
            ("lem_fwd", lem_ms, lem_plain_ms, lem_eager_ms, lem_bound,
             lem_by),
            ("mp_pair_fwd", pair_ms, pair_plain_ms, pair_eager_ms,
             pair_bound, pair_by)):
        print(f"{name} @bucket 16: kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"(CUDA graph; {ems:.4f} ms eager), bound {bms:.4f} ms ({by})")

    with torch.no_grad():
        fwd_ms = timed(lambda: trainer.forward(window, steps, {}), reps=5)
    print(f"MSMP-PDE forward @bucket 16: {fwd_ms:.4f} ms (LEM 1 x "
          f"{lem_ms:.4f}, pairs 6 x {pair_ms:.4f})")
    for B in BUCKETS:
        w = np.random.default_rng(B).normal(size=(B, nx, T)).astype(
            np.float32)
        lats = []
        for _ in range(ROLLOUT_SAMPLES):
            t0 = time.perf_counter()
            engine.rollout(w, n_windows=N_WINDOWS)
            lats.append((time.perf_counter() - t0) * 1e3)
        p50, p90 = np.percentile(lats, [50, 90])
        print(f"rollout bucket {B} x {N_WINDOWS} windows, closed loop, "
              f"{ROLLOUT_SAMPLES} requests: p50 {p50:.3f} ms, p90 "
              f"{p90:.3f} ms, {B * N_WINDOWS / p50 * 1e3:.1f} "
              "sample-windows/s at p50")

    # 7-10. training: kernels vs plain, one step, the main path ----------
    e_stash, e_lbwd = check_lem_training_kernels(rand, T, H)
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
    stash_bound, stash_by = bound(lem_bytes + 4 * 2 * T * N * H, lem_flops)
    _, _, ys, zs = lem_scan.lem_scan_plain(*largs, stash=True)
    bargs = (*largs, ys, zs, rand(N, H), rand(N, H))
    lbwd_ms = timed(lambda: lem_scan.lem_scan_bwd_kernel(*bargs))
    lbwd_eager_ms = timed(lambda: lem_scan.lem_scan_bwd_plain(*bargs))
    lbwd_plain_ms = timed_graph(lambda: lem_scan.lem_scan_bwd_plain(*bargs))
    # reads gx, zx, ys, zs, y0, z0, dyT, dzT, Wy, Wzz; writes dgx, dzx, dy0,
    # dz0, dWy, dWzz. Operations: the sweep's four recurrent products
    # (16 H^2 a row-step) and the two weight gradients (8 H^2 a row-step).
    lbwd_bound, lbwd_by = bound(
        4 * (10 * T * N * H + 6 * N * H + 8 * H * H), 24 * T * N * H * H)
    pbwd_ms = timed(lambda: mp_pair.fused_gated_pair_bwd_kernel(*pbwd_args))
    pbwd_eager_ms = timed(
        lambda: mp_pair.fused_gated_pair_bwd_plain(*pbwd_args))
    pbwd_plain_ms = timed_graph(
        lambda: mp_pair.fused_gated_pair_bwd_plain(*pbwd_args))
    # the pair's backward needs both layers' forward (the kernel recomputes
    # the gate's a second time, not counted) and both layers' backward:
    # dw4, da3, dw3, dh|dagg, dw2 and dm1 over the valid edges, dh from
    # ds_i|ds_j, dw_hi|dw_hj, dw_du|dw_dx|dw_v
    bwd_layer = (2 * nx * H * H * 2 + 2 * nx * (2 * H + V) * H
                 + 2 * nx * H * 2 * H + 2 * 2 * e_valid * H * H
                 + 2 * nx * 2 * H * H + 2 * nx * H * 2 * H
                 + 2 * nx * (D + 1 + V) * H)
    pbwd_bound, pbwd_by = bound(
        4 * (16 * nx * (3 * H + D + 1 + V) + 2 * nx * K + 2 * w_elems),
        16 * 2 * (per_layer + bwd_layer))
    for name, ms, pms, ems, bms, by in (
            ("lem_fwd_stash", stash_ms, stash_plain_ms, stash_eager_ms,
             stash_bound, stash_by),
            ("lem_bwd", lbwd_ms, lbwd_plain_ms, lbwd_eager_ms, lbwd_bound,
             lbwd_by),
            ("mp_pair_bwd", pbwd_ms, pbwd_plain_ms, pbwd_eager_ms,
             pbwd_bound, pbwd_by)):
        print(f"{name} @batch 16: kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"(CUDA graph; {ems:.4f} ms eager), bound {bms:.4f} ms ({by})")
    tx = train_tr.make_optimizer(1e-4, 0.4, [1, 5, 10, 15], 250)
    idx_b = torch.arange(TRAIN_BATCH, device=dev)
    for f in (0, 1):
        step = train_tr.train_step_fn(tx, f)
        st = torch.full((TRAIN_BATCH,), 100, dtype=torch.int64, device=dev)
        ms = timed(lambda: step(u_all, {}, idx_b, st), reps=5)
        print(f"train step @batch {TRAIN_BATCH} unrolled={f}: {ms:.4f} ms, "
              f"{TRAIN_BATCH / ms * 1e3:.1f} samples/s")
    print(f"train_epoch (250 steps): {epoch_s:.3f} s")

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
