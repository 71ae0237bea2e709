#!/usr/bin/env python3
"""Smoke and measurement run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. build every CUDA kernel of the serving path from msmp_pde_torch/csrc;
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
     request latency per bucket.

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
