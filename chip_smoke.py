#!/usr/bin/env python3
"""Smoke and measurement run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. build every CUDA kernel (serving and training) from
     msmp_pde_torch/csrc, printing ptxas's registers and spills of each
     kernel and the LEM kernels' grid and shared memory a CTA;
  2. LEM-scan kernel vs its plain PyTorch version, N in {100, 400, 1600, 37}
     at hidden 128 and 96 (the clusters) and 164 (the hidden-164 route), from
     a random non-zero (y0, z0); two runs give bitwise equal outputs;
  3. fused gated-pair kernel vs its plain version, B in {1, 4, 16, 48} at
     the model's weights, one width no 64-column tile divides, and hidden
     164 at B in {1, 16, 48}; two runs give bitwise equal outputs;
  4. the full-width MSMP-PDE forward (E1: nx=100, tw=25, hidden 128, six
     gated pairs) with weights made from a numpy seed in the flax layout
     and carried across by params_from_flax: kernel path vs
     reference_forward, the same forward through the plain versions;
  5. the main path: the port's HTTP server on localhost answers rollout
     requests (B = 1, 3, 16, 20, and one trajectory) at n_windows=8, each
     checked against RolloutEngine.rollout and against the expected kernel
     launch counts; after it (and every later serving phase)
     ``rollout_replay_check``: each rollout the engine replays as a CUDA
     graph bitwise its eager RolloutProgram's, and the kernels traced in
     the replays the launch counters' moves;
  6. timings (CUDA events, medians) of each kernel beside its plain
     version (replayed from a CUDA graph, and eager) and its bound, the
     pair's forward at buckets 1 and 16, the model's forward at buckets 1
     and 16 beside the host's time to enqueue it, and request latency per
     bucket;
  7. the LEM-scan stash variant and backward kernel vs their plain
     versions, N in {100, 400, 1600, 37} at hidden 128, 96 and 164, from a
     non-zero (y0, z0) (dy0, dz0 held with the other outputs); two runs of
     each give bitwise equal outputs, and the stash variant's yT, zT are
     bitwise the other variant's;
  8. the fused-pair backward kernel vs its plain version, B in {1, 4, 16,
     48} with the model's weights, one width no 64-column tile divides and
     hidden 164 at B in {1, 16}; two runs give bitwise equal gradients;
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
     MP-PDE's forward, train step and rollouts;
 17. E1 datagen on the card: the port's generate CLI (32 train, 16 valid,
     16 test samples, chunk 32, seed 0, float64) into a temporary
     directory; the four resolutions, the schema's keys and attributes,
     finite values, the first train chunk at pde_250-100 against the
     port's CPU solve of the same draws, and PDEDataset reading it;
 18. the train CLI's fit on that data: MSMP-PDE at full width (hidden 128,
     six gated pairs), batch 16, unrolling 1, lr 1e-4, two epochs, each
     step with its expected kernel launches and the metrics' forwards with
     theirs, finite losses falling within epoch 0; after it (and every
     later fit) ``replay_check``: the fit's last steps as replayed CUDA
     graphs bitwise the eager step's, and the kernels traced in the
     replays the launch counters' moves; the best-val
     checkpoint restores parameters, AdamW's state, the schedule and the
     epoch bitwise, and --resume starts after it; compute_l2_norms on the
     valid set, kernel path vs plain path; the HTTP server started with
     the checkpoint and --data_dir answers one request equal to
     RolloutEngine.rollout;
 19. the five models of the slice at full width (E1, nx 100, tw 25, six
     layers or pairs, weights from a numpy seed in the flax layout):
     MSSMP-PDE (two towers), MSGMP-PDE (hidden 164, GLU decoder),
     SaveMSMP-PDE (also from a non-zero state, and its new state),
     LSTMGated and LSTM: one forward at batch 16 vs reference_apply with
     its launches, and one train step at batch 16, kernel path vs plain
     path, unrolled 0 and 1 (the state threaded);
 20. the slice's main path: the train CLI's fit of MSGMP-PDE at hidden 164
     on phase 17's data (batch 16, unrolling 1, one epoch), each step with
     its expected launches, finite losses falling; the HTTP server answers
     SaveMSMP-PDE and MSSMP-PDE requests at 8 windows from start steps of
     which three cross nt - tw, equal to RolloutEngine.rollout, each window
     within TOL_MODEL of the plain path's from the same window with the
     same reset, which fires; timings of the hidden-164 kernels
     (lem_fwd_ring, lem_bwd with lem_bwd_ring and lem_bwd_wgrad, the pairs)
     beside their 3xTF32 bounds, each launch's own card time, torch.matmul
     of the weight gradients as lem_bwd_wgrad's library yardstick,
     MSGMP-PDE's train step (with the card's busy time) and rollouts;
 21. the message-passing kernels at the 2-D models' shapes on RP's grid,
     D = 2 tw = 50 and V = 3 (t, a, b): the pair's forward and backward at
     B in {1, 16, 48} at hidden 128 (MSMP-PDE2D's weights) and 164
     (MSGMP-PDE2D's), the stash and the forced fallback at batch 48, both
     single-layer switch settings forward and backward (MP-PDE2D's
     weights), each against its plain version and bitwise repeatable;
 22. the ten 2-D models at full width on RP's grid (nx 100, tw 25, six
     layers or pairs, weights from a numpy seed through params_from_flax,
     the variables a and b): one forward at batch 16 vs reference_apply
     with its launches (MSG2-PDE2D 12 single layers, GLEMGated2D no
     message-passing kernel), SaveMSMP-PDE2D also from a non-zero state,
     and one train step at unrolled 0 and 1, kernel path vs plain path
     (MSG2-PDE2D's at unrolled 1 also against the plain path in float64,
     each gradient within twice the float32 plain path's own distance
     where it misses the usual bound); MSG2-PDE2D's step at unrolled 1
     at three more weight and batch seeds, each path's distance from
     float64 printed;
 23. the 2-D main path: RP datagen through the generate CLI on the card
     (32/16/16 samples, float64; schema, the first chunk against the CPU's
     solve of the same draws, PDEDataset), fit of MSMP-PDE2D one epoch
     with its metrics, best-val checkpoint, --resume and the HTTP server
     on it; a train_epoch of MSG2-PDE2D, a forced-fallback step of
     MSMP-PDE2D at batch 48, MSG2-PDE2D and GLEMGated2D served over HTTP;
     timings of the four message-passing kernels at D = 50 and of
     MSMP-PDE2D's rollouts and train step, beside MSMP-PDE's of phases 6
     and 11;
 24. the seven grid models at their reference widths (BaseCNN, FNO, VNO
     on E1's grid, FNOP on E3's, BaseCNN2D, FNO2D, FNO2DP on RP's; weights
     from a numpy seed through params_from_flax): the forward at batch 16
     in float32 against the same module in float64 on the card (TOL_GRID
     of max|out|), a step's loss and gradients at unrolled 0 and 1 against
     the float64 step, no launch of a kernel of the table; each model's
     forward, step and rollout times; fit of BaseCNN one epoch on phase
     17's E1 data and of FNO2DP on phase 23's RP data, each resumed and
     served over HTTP (equal to RolloutEngine.rollout); the eval CLI on
     FNO2DP's checkpoint and on phase 18's MSMP-PDE checkpoint (its L2
     norms equal compute_l2_norms); the cv CLI with BaseCNN one epoch on
     E1's 64 merged samples;
 25. the wave equation, KF and KS: WE1, WE2, WE3 and KF through the
     generate CLI on the card (32/16/16 samples, float64; the schema, WE's
     int boundaries and WE3's quirk, the first train chunk at pde_250-100
     against the port's CPU solve of the same draws, PDEDataset); KS
     through generate_ks at the reference's dt 0.00025 and tend 100,
     restricted to the resolutions fit reads, 250-200 and 250-100 (its
     CUDA graphs' replays bitwise equal to the eager loop, the card
     against the CPU over the first 9,575 fine steps, and over the whole
     horizon against a CPU process started before, the distance printed);
     the four message-passing kernels on WE's k-NN graph (K = 3, unequal
     in-degrees) at V = 3 and V = 1 against their plain versions; fit of
     MSMP-PDE one epoch on WE3 and on KS (--short_horizon_windows 2),
     each resumed, held window by window and served with --data_dir;
     eval --ks_spectrum on the KS checkpoint (the diagnostics against the
     CPU's and the plain path's); one train_epoch of MP-PDE on WE3 and a
     forced-fallback step of MSMP-PDE at batch 48 on WE3's grid; the
     k-NN kernels' times and MSMP-PDE's step on WE3;
 26. RPU, the advection system on the unstructured LCG grid: the generate
     CLI on the card (32/16/16 samples, every resolution, float64; each
     resolution's x the LCG grid bit for bit, the first train chunk
     within 1e-9 of the CPU's solve of the same draws); the four
     message-passing kernels on RPU's k-NN graph (K = 3 on the
     cylindrical coordinates of the LCG grid of 100, nodes of in-degree
     0, the largest above 3) at D = 50, V = 3 against their plain
     versions, bitwise repeatable; fit of MSMP-PDE2D one epoch (500
     steps, launches counted), resumed, held window by window and served
     with --data_dir; MP-PDE2D's train_epoch and a forced-fallback step
     of MSMP-PDE2D at batch 48 on RPU's grid; FNO2DPU against float64 on
     the card, fit one epoch and served; the interpolated route: the
     interpolate CLI on the card (against the CPU's), fit --data_suffix
     _I of FNO2DP on the uniform grid (asserted, and served with the
     suffix), eval_interpolated's interp-back L2 and rel-L2 (equal to a
     direct reduction of the interpolated-back rollout);
 27. the bf16 precision modes (mp_precision bfloat16 and bfloat16s): the
     four message-passing kernels (and the stash at batch 48) in both
     modes against their plain versions in the same mode at E1's shapes
     (batches 1, 16, 48), hidden 164, D = 50 with V = 3 and RPU's k-NN
     graph (nodes of in-degree 0), two runs bitwise equal, held three
     ways (BF16_*): a forward's outputs by their distance over the plain
     bf16-to-float32 distance, a backward's by the spread of four sound
     plain versions, and every rounding site on the kernel's own operands
     from its workspace; faults planted in the plain site functions must
     fail their sites; each kernel timed in float32, bfloat16 and
     bfloat16s in this call with its bound (every bf16 product at 989
     TFLOP/s, the storage mode's 2-byte operands); fit of MSMP-PDE one
     epoch on phase 17's data in each mode (every step's launches as
     float32's) with a step held per gradient against the spread of the
     plain steps from the same pushed window and every launch of the step
     held site by site; the bf16 checkpoint served with --mp_precision
     bfloat16s and phase 18's float32 checkpoint in bfloat16, each window
     held against the plain path; MP-PDE's step (held as MSMP-PDE's) and
     train_epoch in each mode; the forced-fallback step of MSMP-PDE at
     batch 48 in each mode;
 28. the exported rollouts (serving/export.py, the kernels as the msmp
     torch.library ops): MSMP-PDE at full width (E1, hidden 128, bucket
     16, 8 windows), MP-PDE, MSGMP-PDE at hidden 164 (the LEM's ring
     route) and MSMP-PDE in bfloat16s exported on the card, then replayed
     in a fresh process (``chip_smoke.py --replay``) that builds no model,
     each bitwise equal to the engine's rollout of the same request with
     the engine's launches; the exported program's and the engine's
     rollout p50 at buckets 1, 4 and 16, in turns; MSMP-PDE exported on
     the CPU and moved to the card at load time (move_to_device_pass)
     against the card's rollout; the op layer's host time a launch beside
     the kernel function's;
 29. data parallelism (parallel/mesh.py): whether a process keeps a
     failed CUDA initialisation; MSMP-PDE's step at batch 16, unrolled 0
     and 1, at world size 1 under NCCL (a rank process, ``chip_smoke.py
     --ddp``) bitwise equal to the step without a group, and at two gloo
     ranks on the one card (NCCL takes a card a rank), 8 samples each,
     every gradient within scale_aware of the plain step's, each rank with
     a step's launches; the steps' times in the group and before it, and
     the gradients' all-reduce alone. cuDNN runs its deterministic
     algorithms in this phase: its default conv backward need not repeat
     bitwise.

Comparisons run in full float32 (TF32 off for matmuls and cuDNN convs),
the bf16 modes' against the plain versions in the same mode.
Exits non-zero, printing no result, without CUDA or outside a checkout.
The last line is {"ok": true, "device": {...}}.
"""
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks: HBM bytes/s, float32 FLOP/s outside the tensor
# cores, dense TF32 and dense bf16 FLOP/s on them
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
BF16_FLOP_S = 989e12
N_WINDOWS = 8
BUCKETS = (1, 4, 16)
TOL_LEM = 1e-5    # FMA order only
TOL_PAIR = 1e-4   # FMA order, then InstanceNorm's divide by the spread
TOL_MODEL = 5e-4  # six pairs and the LEM compound the pair's rounding
# LEM backward: per-row outputs as tests/test_lem_pallas.py:151. The weight
# gradients are sums over T*N rows, whose float32 rounding grows with the
# sum and not with each element: their atol is 1e-5 * max|ref|.
LEM_BWD_RTOL, LEM_BWD_ATOL = 5e-4, 1e-5
TRAIN_BATCH = 16
TRAIN_LOSS_RTOL = 1e-4
# phase 17: the card's and the CPU's float64 solves of one chunk take the
# same steps and differ by rounding only
TOL_DATAGEN = 1e-9
# the samples of phase 17's E1 and phase 23's RP datasets
E1_SAMPLES = {"train": 32, "valid": 16, "test": 16}
# phase 18, relative: an 8-window rollout compounds TOL_MODEL's rounding
TOL_L2 = 1e-3
# phase 26: the interpolate CLI on the card against the CPU, float64; the
# same searchsorted, gathers, products and sums, so rounding only
TOL_INTERP = 1e-12


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


def launch_counts():
    """{kernel: launches since the last reset} (``ops.LAUNCH_COUNTERS``);
    the stash variants are counted in their kernel's total too."""
    from msmp_pde_torch import ops

    return ops.launch_counts()


def reset_counts():
    from msmp_pde_torch import ops

    ops.set_launch_counts(dict.fromkeys(ops.LAUNCH_COUNTERS, 0))


def diff_counts(now, before):
    return {k: now[k] - before[k] for k in now}


def expected_launches(model, forwards, grad_steps=0):
    """The launches of ``forwards`` model forwards, of which ``grad_steps``
    with grad and a backward (on the fused pair route): a LEM scan a
    forward with the LEM encoder (none with the MLP or the LSTM); a pair
    kernel a sigmoid-gated pair, a layer kernel an ungated layer and two
    a gradient-gated pair (gate and layer), none for attention layers;
    the twin-tower model runs two towers. A grid model (CNN, FNO) launches
    none."""
    from msmp_pde_torch.models.gnn import MPSolver

    want = dict.fromkeys(launch_counts(), 0)
    if not isinstance(model, MPSolver):
        return want
    towers = ((model.diff_tower, model.scale_tower) if model.twin_scale
              else (model,))
    for m in towers:
        if m.encoder == "lem":
            want["lem_fwd"] += forwards
            want["lem_fwd_stash"] += grad_steps
            want["lem_bwd"] += grad_steps
        if m.layer_type == "gat":
            continue
        kind = "mp_pair" if m.gate == "sigmoid" else "mp_layer"
        n = m.layers * (2 if m.gate == "grad" else 1)
        want[f"{kind}_fwd"] += n * forwards
        want[f"{kind}_bwd"] += n * grad_steps
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


def bound(nbytes, flops, tc_flops=0, bf16_flops=0):
    """The least time in ms for a kernel that moves ``nbytes`` and does
    ``flops`` float32 operations on the CUDA cores, ``tc_flops`` in 3xTF32
    on the tensor cores (three TF32 products for each) and ``bf16_flops``
    products of bf16 operands summed in float32, which the tensor cores run
    at the dense bf16 rate, and which of the two bounds it."""
    t_mem = nbytes / HBM_BYTES_S
    t_ops = (flops / F32_FLOP_S + 3 * tc_flops / TF32_FLOP_S
             + bf16_flops / BF16_FLOP_S)
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def layer_ops(nx, H, D, V, e_valid):
    """(forward, edge product, backward) FLOP of one message-passing layer
    on one graph. Forward: the i side with mix (u w_du + px w_dx, counted
    once), the j side h w_hj, the edge product w2 over the valid edges, the
    update w3 and w4. In float32 the edge products (w2; dw2 and dm1 in the
    backward) run in 3xTF32 on the tensor cores (csrc/mp_phases.cuh), the
    rest as float32 FMAs. Only products are counted. Backward: dw4, da3,
    dw3, dh|dagg, dw2 and dm1 over the valid edges, dh from ds_i|ds_j,
    dw_hi|dw_hj, dw_du|dw_dx|dw_v."""
    edge = 2 * e_valid * H * H
    fwd = (2 * nx * (H + D + 1 + V) * H + 2 * nx * H * H
           + edge + 2 * nx * (2 * H + V) * H + 2 * nx * H * H)
    bwd = (2 * nx * H * H * 2 + 2 * nx * (2 * H + V) * H
           + 2 * nx * H * 2 * H + 2 * edge
           + 2 * nx * 2 * H * H + 2 * nx * H * 2 * H
           + 2 * nx * (D + 1 + V) * H)
    return fwd, edge, bwd


def mp_calls(name, mp_precision="float32"):
    """(kernel, plain version) of one message-passing kernel in
    ``mp_precision``, each called on the operands ``mp_bound`` reads: a
    pair's (h, u, px, v, idx, mask, Wg, Wl[, g]), a single layer's (h, u,
    px, v, idx, mask, W[, g]) as GNN_Layer (final_act and residual on)."""
    from functools import partial

    from msmp_pde_torch.ops import mp_layer, mp_pair

    m = mp_precision
    layer = lambda f: lambda *a, **k: f(*a, True, True, m, **k)  # noqa: E731
    pair = lambda f, **k: partial(f, mp_precision=m, **k)  # noqa: E731
    return {
        "mp_pair_fwd": (pair(mp_pair.fused_gated_pair_kernel),
                        pair(mp_pair.fused_gated_pair_plain)),
        "mp_pair_fwd_stash": (
            pair(mp_pair.fused_gated_pair_kernel, stash=True),
            pair(mp_pair.fused_gated_pair_plain, stash=True)),
        "mp_pair_bwd": (pair(mp_pair.fused_gated_pair_bwd_kernel),
                        pair(mp_pair.fused_gated_pair_bwd_plain)),
        "mp_layer_fwd": (layer(mp_layer.fused_mp_layer_kernel),
                         layer(mp_layer.fused_mp_layer_plain)),
        "mp_layer_bwd": (layer(mp_layer.fused_mp_layer_bwd_kernel),
                         layer(mp_layer.fused_mp_layer_bwd_plain)),
    }[name]


def mp_bound(name, args, mp_precision="float32"):
    """``bound`` of one message-passing kernel on ``args`` (``mp_calls``'s
    operands) in ``mp_precision``, at any B, nx, H, D, V, K. Bytes: each
    input read once and each output written once; a forward reads h, u,
    px, v, idx, mask and the weights and writes h (the stash gn and ln
    too), a backward also reads g and writes dh and the weights' gradients;
    the storage mode reads h, u, px, v and the weight matrices as 2-byte
    bf16. Operations: ``layer_ops`` per layer and graph. In float32 the
    edge products (three in a backward) in 3xTF32 on the tensor cores and
    the rest on the CUDA cores; in the bf16 modes every product has bf16
    operands and a float32 sum, all at the dense bf16 rate (``layer_ops``
    counts only products)."""
    h, u, _, v, idx, mask = args[:6]
    B, nx, H = h.shape
    D, V, K = u.shape[-1], v.shape[-1], idx.shape[1]
    layers = 2 if name.startswith("mp_pair") else 1
    Ws = args[6:6 + layers]
    w = sum(x.numel() for W in Ws for x in W)
    w_bias = sum(W[i].numel() for W in Ws for i in (5, 7, 9, 11))
    fwd, edge, bwd = layer_ops(nx, H, D, V, float(mask.sum().item()))
    n = B * layers
    in_b = 2 if mp_precision == "bfloat16s" else 4
    ins = in_b * (B * nx * (H + D + 1 + V) + w - w_bias) + 4 * (
        w_bias + 2 * nx * K)
    bf16 = mp_precision != "float32"

    def ops(f32, edges):
        return (0, 0, f32 + edges) if bf16 else (f32, edges)

    if name.endswith("_bwd"):
        return bound(ins + 4 * (2 * B * nx * H + w),
                     *ops(n * (fwd + bwd - 3 * edge), n * 3 * edge))
    outs = 3 * H if name.endswith("_stash") else H
    return bound(ins + 4 * B * nx * outs, *ops(n * (fwd - edge), n * edge))


def mp_kernel_times(cases):
    """Each (kernel name, operands[, mp_precision]) of ``cases`` timed on
    the card: the kernel, its plain version in a CUDA graph and eager, and
    ``mp_bound``; printed, and returned in order as (ms, plain ms, eager
    ms, bound ms, bound by)."""
    import torch

    out = []
    with torch.no_grad():
        for name, args, *mode in cases:
            mode = mode[0] if mode else "float32"
            kern, plain = mp_calls(name, mode)
            r = (timed(lambda: kern(*args)), timed_graph(lambda: plain(*args)),
                 timed(lambda: plain(*args)), *mp_bound(name, args, mode))
            B, _, H = args[0].shape
            tag = "" if mode == "float32" else f"@{BF16_TAGS[mode]}"
            print(f"{name}{tag} @D={args[1].shape[-1]} V={args[3].shape[-1]} "
                  f"H={H} batch {B}: kernel {r[0]:.4f} ms, plain {r[1]:.4f} "
                  f"ms (CUDA graph; {r[2]:.4f} ms eager), bound {r[3]:.4f} "
                  f"ms ({r[4]})")
            out.append(r)
    return out


def flax_tree(model, seed):
    """Random weights for every leaf of ``model``, as a nested numpy dict
    under flax paths, each U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with the
    fan-in of the flax initializer (the LEM's and the LSTM's, and an
    attention layer's q, k and bias: the hidden width; a twin tower's
    leaves as its own model's). The attention layer's bias, zeros in
    flax, is drawn too. A grid model's leaves as its flax initializers
    draw them: a spectral weight [c_in, c_out, modes, 2] scale U(0, 1),
    scale = 1 / (c_in c_out) (msmp_pde_tpu/models/fno.py:41-48), BaseCNN's
    kernels within the Xavier bound, the biases and Dense leaves within
    the fan-in bound."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    H = getattr(model, "hidden", None)  # a grid model has none
    tree = {}
    for key, val in sd.items():
        parts = key.split(".")
        node = tree.setdefault("params", {})
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if val.dim() == 4:  # spectral
            lo, hi = 0.0, 1.0 / (val.shape[0] * val.shape[1])
            node[parts[-1]] = rng.uniform(lo, hi, size=tuple(val.shape)
                                          ).astype(np.float32)
            continue
        mod, leaf = parts[-2], parts[-1]
        if parts[0].startswith("_CircularConv") and leaf == "kernel":
            o, c, k = val.shape
            b = math.sqrt(6.0 / (c * k + o * k))
            node[leaf] = rng.uniform(-b, b, size=tuple(val.shape)).astype(
                np.float32)
            continue
        if ("embedding_lem" in parts or "lstm" in parts
                or leaf in ("att_q", "att_k")
                or (leaf == "bias" and mod.startswith(("gnn_", "gate_")))):
            fan = H  # every recurrent parameter: U(+-1/sqrt(H))
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
        node[leaf] = rng.uniform(-b, b, size=tuple(val.shape)).astype(
            np.float32)
    return tree


def plain_functions():
    """Autograd Functions of the message-passing layers on the plain
    versions, forward and backward, on any device: (layer, pair), applied
    as ``FusedMPLayer`` and ``FusedGatedPair`` are. In the bf16 modes the
    plain path's step differentiates through them: autograd through the
    plain forward would round the cotangents where the bf16 casts stand,
    which the kernels' backward (mp_pallas.py::_layer_bwd_math) does not."""
    import torch

    from msmp_pde_torch.ops import mp_layer, mp_pair

    class Layer(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, u, px, v, idx, mask, final_act, residual, mode,
                    *W):
            ctx.save_for_backward(h, u, px, v, idx, mask, *W)
            ctx.args = (final_act, residual, mode)
            return mp_layer.fused_mp_layer_plain(h, u, px, v, idx, mask, W,
                                                 final_act, residual, mode)

        @staticmethod
        def backward(ctx, g):
            h, u, px, v, idx, mask, *W = ctx.saved_tensors
            dh, dws = mp_layer.fused_mp_layer_bwd_plain(
                h, u, px, v, idx, mask, W, g, *ctx.args)
            return (dh,) + (None,) * 8 + tuple(dws)

    class Pair(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, u, px, v, idx, mask, mode, *W):
            ctx.save_for_backward(h, u, px, v, idx, mask, *W)
            ctx.mode = mode
            return mp_pair.fused_gated_pair_plain(
                h, u, px, v, idx, mask, W[:12], W[12:], mp_precision=mode)

        @staticmethod
        def backward(ctx, g):
            h, u, px, v, idx, mask, *W = ctx.saved_tensors
            dh, dwg, dwl = mp_pair.fused_gated_pair_bwd_plain(
                h, u, px, v, idx, mask, W[:12], W[12:], g, ctx.mode)
            return (dh,) + (None,) * 6 + tuple(dwg) + tuple(dwl)

    return Layer, Pair


def reference_apply(model, window, pos_x, var_vec, idx, mask,
                    lem_state=None):
    """MPSolver.forward written out through the plain versions of the
    kernels (``lem_scan_plain``, ``fused_mp_layer_plain``,
    ``fused_gated_pair_plain``) on the model's own parameters, for every
    encoder (mlp, lem, lstm), processor (ungated layers, sigmoid-gated
    pairs, gradient-gated layers, attention layers) and decoder (cnn, glu,
    diff_only, at d = 1 and 2), the twin towers and the LEM's state: the
    on-card reference of the kernel path. The recurrent encoders' step
    inputs are the model's ``_sequence``; the message-passing layers run
    in the model's ``mp_precision``, in the bf16 modes through
    ``plain_functions``. Returns (out, the LEM's new state or None)."""
    import torch

    from msmp_pde_torch.models.common import swish
    from msmp_pde_torch.ops.lem_scan import lem_scan_plain
    from msmp_pde_torch.ops.mp_layer import fused_mp_layer_plain
    from msmp_pde_torch.ops.mp_pair import fused_gated_pair_plain

    if model.twin_scale:
        diff, _ = reference_apply(model.diff_tower, window, pos_x, var_vec,
                                  idx, mask)
        scale, _ = reference_apply(model.scale_tower, window, pos_x,
                                   var_vec, idx, mask)
        return model._compose_scale_diff(window, scale, diff), None
    B, nx, _ = window.shape
    V, H = var_vec.shape[-1], model.hidden
    px_n = pos_x / model.L
    variables = var_vec[:, None, :].expand(B, nx, V)
    state = None
    if model.encoder == "mlp":
        node_in = torch.cat([window, px_n[..., None], variables], -1)
        h = swish(model.embed_2(swish(model.embed_1(node_in))))
    else:
        seq = model._sequence(window, px_n, variables)
        if model.encoder == "lstm":  # plain torch ops: no kernel
            y = model.lstm(seq)
        else:
            lem = model.embedding_lem
            W, Wz, I = lem.weights, lem.weights_lin_z, seq.shape[-1]
            gx = seq @ W[:, :I].T + lem.bias
            zx = seq @ Wz[:, :I].T + lem.bias_lin_z
            zeros = window.new_zeros((B * nx, H))
            y0, z0 = ((zeros, zeros) if lem_state is None else
                      (s.reshape(B * nx, H) for s in lem_state))
            y, z = lem_scan_plain(gx, zx, y0, z0, W[:, I:].T, Wz[:, I:].T,
                                  dt=float(lem.dt))
            if model.save_state:
                state = (y.reshape(B, nx, H), z.reshape(B, nx, H))
        h = swish(model.lemout_2(swish(model.lemout_1(y.reshape(B, nx, H)))))
    args = (window, px_n, variables, idx, mask)
    mode = model.mp_precision
    mp_args = (window, px_n[..., None], variables, idx, mask)
    if mode == "float32":
        plain_layer = lambda m: fused_mp_layer_plain(  # noqa: E731
            h, *mp_args, m.weights(), m.final_act, m.residual)
        plain_pair = lambda g, m: fused_gated_pair_plain(  # noqa: E731
            h, *mp_args, g.weights(), m.weights())
    else:
        Layer, Pair = plain_functions()
        plain_layer = lambda m: Layer.apply(  # noqa: E731
            h, *mp_args, m.final_act, m.residual, mode, *m.weights())
        plain_pair = lambda g, m: Pair.apply(  # noqa: E731
            h, *mp_args, mode, *g.weights(), *m.weights())
    for i in range(model.layers):
        layer = getattr(model, f"gnn_{i}")
        gate = getattr(model, f"gate_{i}", None)
        if model.layer_type == "gat":  # plain torch ops: no kernel
            apply = lambda m: m(h, *args)
        else:
            apply = plain_layer
        if gate is None:
            h = apply(layer)
        elif model.gate == "sigmoid" and model.layer_type == "mp":
            h = plain_pair(gate, layer)
        else:
            h = model._gated(h, apply(gate), apply(layer), idx, mask)
    return model._decode(h, window), state


def reference_forward(model, window, pos_x, var_vec, idx, mask):
    """``reference_apply``'s output alone, from a zero LEM state."""
    return reference_apply(model, window, pos_x, var_vec, idx, mask)[0]


def plain_forward(trainer):
    """``trainer.forward`` through ``reference_forward``; a grid model's
    forward itself (it runs no kernel of the table)."""
    if trainer.kind == "grid":
        return trainer.forward
    model, spec = trainer.model, trainer.spec

    def forward(window, steps, variables, lem_state=None):
        var_vec = trainer.var_vec(steps, variables)
        return reference_apply(
            model, window, spec.x.expand(window.shape[0], spec.nx), var_vec,
            spec.idx, spec.mask, lem_state)

    return forward


def reference_step_loss(trainer, u_all, idx_batch, steps, unrolled,
                        var_all=None):
    """``Trainer.step_loss`` with every forward through
    ``reference_forward``: autograd then differentiates the plain versions,
    the on-card reference of the kernel path's training step."""
    return trainer.step_loss(u_all, var_all or {}, idx_batch, steps,
                             unrolled, forward=plain_forward(trainer))


# (hidden, rows) of phases 2 and 7: buckets 1, 4, 16 of nx 100 and a ragged
# tile, at MSMP-PDE's width, one more of the clusters and MSGMP-PDE's 164
# (the hidden-164 route); y0, z0 random, non-zero (lem_times.lem_args)
LEM_CASES = [(H, N) for H in (128, 96, 164) for N in (100, 400, 1600, 37)]
GLU_H = 164  # MSGMP-PDE's hidden width


def by_route(errs):
    """{hidden: max error} -> (the clusters' max, the hidden-164 route's)."""
    return (max(e for H, e in errs.items() if H != GLU_H), errs[GLU_H])


def check_lem_training_kernels(rand, T):
    """Phase 7: returns ({H: stash max error}, {H: backward max error},
    {H: the weight gradients' max error}); dy0 and dz0 are held with the
    other outputs."""
    import torch

    from msmp_pde_torch.ops import lem_scan
    from msmp_pde_torch.tools.lem_times import lem_args

    e_stash, e_bwd, e_wgrad = {}, {}, {}
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
        e_stash[H] = max(e_stash.get(H, 0.0), e)
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
            if name.startswith("dw"):
                e_wgrad[H] = max(e_wgrad.get(H, 0.0), e)
            check(bool(torch.allclose(a, b, rtol=LEM_BWD_RTOL, atol=atol)),
                  f"lem_bwd N={N} H={H} {name}: max |diff| {e:.3e}, atol "
                  f"{atol}")
        e_bwd[H] = max(e_bwd.get(H, 0.0), worst)
        print(f"lem_bwd N={N} H={H}: all six outputs (dy0, dz0 from a "
              f"non-zero y0, z0) within rtol {LEM_BWD_RTOL} (max |kernel - "
              f"plain| {worst:.3e}); two runs bitwise equal")
    return e_stash, e_bwd, e_wgrad


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


def lem_card_times164(args, bargs):
    """Phase 20: the hidden-164 kernels' own card time from torch.profiler,
    ms a call, launch by launch (lem_fwd_ring without and with the stash;
    lem_bwd's two transposes, lem_bwd_ring, lem_bwd_wgrad and the ordered
    sum). Returns lem_bwd's {launch: ms}."""
    from msmp_pde_torch.ops import lem_scan
    from msmp_pde_torch.tools.lem_times import kernels_us, short

    for name, fn in (
            ("lem_fwd", lambda: lem_scan.lem_scan_kernel(*args)),
            ("lem_fwd_stash",
             lambda: lem_scan.lem_scan_kernel(*args, stash=True)),
            ("lem_bwd", lambda: lem_scan.lem_scan_bwd_kernel(*bargs))):
        ks = kernels_us(fn)
        own = (" + ".join(f"{short(k)} {us / 1e3:.4f}" for k, us in ks)
               if ks else "not measured")
        print(f"{name} @hidden 164, N={args[2].shape[0]}: card by launch "
              f"{own} ms")
    return {short(k): us / 1e3 for k, us in ks or ()}


def check_pair_bwd(rand, model, spec, T, H, V, W164, b164=(1, 16)):
    """Phases 8 and 21: returns ({hidden: max error}, {hidden: the
    batch-16 args}), the latter for the timings. ``W164``: a gate's and a
    layer's weights at hidden 164, MSGMP-PDE's width, checked at batches
    ``b164``. T is the window's width D (the 2-D models' 50)."""
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
    cases += [(B, nx, GLU_H, V, spec.idx, spec.mask, *map(detach, W164))
              for B in b164]
    errs, args16 = {}, {}
    for B, n, h, v, idx, mask, wg, wl in cases:
        err = errs.get(h, 0.0)
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
        errs[h] = err
        print(f"mp_pair_bwd B={B} nx={n} H={h}: dh and 24 grads within the "
              f"scale-aware bound (max |kernel - plain| {err:.3e}); two runs "
              "bitwise equal")
        if B == 16:
            args16[h] = args
    return errs, args16


def kernel_push(trainer):
    """A forward for ``Trainer.step_loss`` that runs the pushforward (no
    grad) on the kernel path and the step's forward (with grad) through
    ``plain_forward``: the plain path's step on the kernel path's pushed
    window and LEM state."""
    import torch

    plain = plain_forward(trainer)

    def forward(window, steps, variables, lem_state=None):
        fwd = plain if torch.is_grad_enabled() else trainer.forward
        return fwd(window, steps, variables, lem_state=lem_state)

    return forward


def double_trainer(trainer):
    """A float64 copy of ``trainer`` (its model and its graph), for the
    plain path in float64: the yardstick of float32's rounding."""
    import copy
    import dataclasses

    import torch

    tr = copy.deepcopy(trainer)
    tr.model = tr.model.double()
    tr.spec = dataclasses.replace(trainer.spec, **{
        f.name: getattr(trainer.spec, f.name).double()
        for f in dataclasses.fields(trainer.spec)
        if torch.is_tensor(getattr(trainer.spec, f.name))
        and getattr(trainer.spec, f.name).is_floating_point()})
    return tr


def step_batch(rng, n, unrolled, dev):
    """A train step's (sample indices, start steps) at batch TRAIN_BATCH
    from ``n`` trajectories of 250 steps, room left for ``unrolled``
    pushforward windows."""
    import torch

    idx = torch.as_tensor(rng.permutation(n)[:TRAIN_BATCH], device=dev)
    steps = torch.as_tensor(
        rng.integers(25, 250 - 25 * (unrolled + 1) + 1, TRAIN_BATCH),
        device=dev)
    return idx, steps


def step_drift(trainer, u_all, name):
    """Phase 19: where one train step's gradients at batch 16 lie from the
    plain path's in float64, on the kernel path and on the plain path in
    float32: over the parameters, the largest max |error| relative to the
    gradient's scale (``grad_scales``), at unrolled 0 and 1. Printed, not
    held: it shows how far float32 itself carries a step."""
    import numpy as np
    import torch

    tr64 = double_trainer(trainer)
    names = [n for n, _ in trainer.model.named_parameters()]
    rng = np.random.default_rng(2)
    for unrolled in (0, 1):
        idx, steps = step_batch(rng, len(u_all), unrolled, u_all.device)
        grads = {}
        for path, tr, loss in (
                ("kernel", trainer, lambda t: t.step_loss(
                    u_all, {}, idx, steps, unrolled)),
                ("plain32", trainer, lambda t: reference_step_loss(
                    t, u_all, idx, steps, unrolled)),
                ("plain64", tr64, lambda t: reference_step_loss(
                    t, u_all.double(), idx, steps, unrolled))):
            grads[path] = torch.autograd.grad(loss(tr),
                                              list(tr.model.parameters()))
        scales = grad_scales(zip(names, grads["plain64"]))
        worst = {p: max((a.double() - b).abs().max().item() / scales[n]
                        for n, a, b in zip(names, grads[p],
                                           grads["plain64"]))
                 for p in ("kernel", "plain32")}
        print(f"{name} train step unrolled={unrolled}: from the plain path "
              f"in float64, the kernel path {worst['kernel']:.2e} and the "
              f"plain path in float32 {worst['plain32']:.2e} of a "
              "gradient's scale (the largest over parameters)")


def f64_step_grads(trainer, u_all, var_all, idx, steps, unrolled):
    """The plain path's step in float64 (``double_trainer``) from the
    kernel path's pushforward, run in float32 and cast: (the loss, the
    gradients in parameter order)."""
    import torch

    tr64 = double_trainer(trainer)
    plain64 = plain_forward(tr64)

    def forward(window, steps_, variables, lem_state=None):
        if torch.is_grad_enabled():
            return plain64(window, steps_, {k: v.double() for k, v in
                                            variables.items()}, lem_state)
        state = (None if lem_state is None else
                 tuple(x.float() for x in lem_state))
        out, new = trainer.forward(window.float(), steps_, variables,
                                   lem_state=state)
        return out.double(), (None if new is None else
                              tuple(x.double() for x in new))

    loss = tr64.step_loss(u_all.double(), var_all, idx, steps, unrolled,
                          forward=forward)
    return loss, torch.autograd.grad(loss, list(tr64.model.parameters()))


def check_train_step(trainer, u_all, rng, name="MSMP-PDE", same_push=False,
                     var_all=None, f64_yardstick=False):
    """Phases 9, 15, 19 and 22: one step's loss and gradients, kernel path vs
    plain path. With ``same_push`` the plain path's step at unrolled 1
    starts from the kernel path's pushed window and state
    (``kernel_push``): the pushforward amplifies float32's rounding, so
    that at unrolled 1 both paths lie ~10x farther from the plain path in
    float64 than at unrolled 0, past the scale-aware bound (``step_drift``
    prints it for MSSMP-PDE and MSGMP-PDE), and only the same inputs hold
    the kernels to that bound. ``var_all``: the equation variables of
    ``u_all``'s samples (none by default).

    ``f64_yardstick`` (phase 22, MSG2-PDE2D alone) adds, at unrolled 1
    only, the plain path's step in float64 from the same pushed window
    (``f64_distances``): a gradient that misses the scale-aware bound
    against the float32 plain path must lie within max(the scale-aware
    bound, twice the float32 plain path's own distance) of the float64
    step, each gradient against its own. The JAX package's float32 step of
    this model lies as far from its float64 step
    (tests/test_torch_f32_drift.py); the printout says which check held."""
    import torch

    var_all = var_all or {}
    params = list(trainer.model.parameters())
    names = [n for n, _ in trainer.model.named_parameters()]
    for unrolled in (0, 1):
        idx, steps = step_batch(rng, len(u_all), unrolled, trainer.device)
        loss_k = trainer.step_loss(u_all, var_all, idx, steps, unrolled)
        grads_k = torch.autograd.grad(loss_k, params)  # every one is used
        if same_push and unrolled:
            loss_p = trainer.step_loss(u_all, var_all, idx, steps, unrolled,
                                       forward=kernel_push(trainer))
        else:
            loss_p = reference_step_loss(trainer, u_all, idx, steps,
                                         unrolled, var_all)
        grads_p = torch.autograd.grad(loss_p, params)
        torch.cuda.synchronize()
        rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        check(rel <= TRAIN_LOSS_RTOL,
              f"{name} train step unrolled={unrolled}: loss {loss_k.item()}"
              f" vs {loss_p.item()}")
        yardstick = f64_yardstick and unrolled == 1
        if yardstick:
            dk, d32, s64 = f64_distances(trainer, u_all, var_all, idx, steps,
                                         unrolled, grads_k, grads_p)
        worst, missed = 0.0, []
        scales = grad_scales(zip(names, grads_p))
        for pname, a, b in zip(names, grads_k, grads_p):
            check(bool(torch.isfinite(a).all()), f"{pname}: grad not finite")
            ok, e = scale_aware(a, b, scales[pname])
            worst = max(worst, e)
            if not ok and yardstick:
                missed.append(pname)
                lim = max(1e-3, 2e-4 / s64[pname], 2 * d32[pname])
                ok = dk[pname] <= lim
                check(ok, f"{name} train step unrolled={unrolled}: {pname} "
                      f"grad lies {dk[pname]:.3e} of its scale from the "
                      f"float64 step, past {lim:.3e} (twice the float32 "
                      f"plain path's {d32[pname]:.3e})")
            check(ok, f"{name} train step unrolled={unrolled}: {pname} "
                  f"grad differs by {e:.3e}")
        push = (" (the plain step from the kernel path's pushforward)"
                if same_push and unrolled else "")
        held = (f"{len(params)} grads within the scale-aware bound (max "
                f"|diff| {worst:.3e})")
        if missed:
            held = (f"{len(missed)} of {len(names)} grads past the "
                    f"scale-aware bound against the float32 plain path "
                    f"({', '.join(missed[:3])}"
                    f"{', ...' if len(missed) > 3 else ''}), each within "
                    "twice the float32 plain path's own distance from the "
                    "float64 step")
        print(f"{name} train step B={TRAIN_BATCH} unrolled={unrolled}"
              f"{push}: loss {loss_k.item():.6f} (plain "
              f"{loss_p.item():.6f}, rel {rel:.2e}); {held}")
        if yardstick:
            print(f"{name} unrolled={unrolled} from the float64 step: "
                  + f64_reading(dk, d32, s64))


def f64_distances(trainer, u_all, var_all, idx, steps, unrolled, grads_k,
                  grads_p):
    """Each gradient's distance from the plain path's step in float64 from
    the kernel path's pushforward (``f64_step_grads``), relative to its
    scale (``grad_scales`` of the float64 gradients): ({name: the kernel
    path's}, {name: the float32 plain path's}, {name: scale})."""
    _, g64 = f64_step_grads(trainer, u_all, var_all, idx, steps, unrolled)
    names = [n for n, _ in trainer.model.named_parameters()]
    scales = grad_scales(zip(names, g64))
    dist = lambda grads: {  # noqa: E731
        n: (a.double() - b).abs().max().item() / scales[n]
        for n, a, b in zip(names, grads, g64)}
    return dist(grads_k), dist(grads_p), scales


def f64_reading(dk, d32, scales):
    """``f64_distances`` in a line: the largest distance of each path,
    and the largest ratio of the kernel path's to the float32 plain path's
    over the gradients past the scale-aware bound's floor."""
    past = [n for n in dk if dk[n] > max(1e-3, 2e-4 / scales[n])]
    ratio = max((dk[n] / d32[n] for n in past), default=0.0)
    return (f"the kernel path {max(dk.values()):.3e}, the float32 plain "
            f"path {max(d32.values()):.3e} of a gradient's scale (largest); "
            f"{len(past)} of {len(dk)} kernel-path grads past 1e-3 of their "
            f"scale, at most {ratio:.2f}x the float32 plain path's own")


def f64_seed_readings(u_all, var_all, name, seeds, experiment="RP"):
    """Phase 22: ``name``'s step at unrolled 1 from the kernel path's
    pushforward, at other weights and batches (numpy seeds ``seeds``):
    each path's distance from the float64 step, printed, not held."""
    import numpy as np
    import torch

    for seed in seeds:
        tr = weighted_trainer(experiment, name, seed, u_all.device)
        idx, steps = step_batch(np.random.default_rng(seed), len(u_all), 1,
                                u_all.device)
        params = list(tr.model.parameters())
        grads_k = torch.autograd.grad(
            tr.step_loss(u_all, var_all, idx, steps, 1), params)
        grads_p = torch.autograd.grad(tr.step_loss(
            u_all, var_all, idx, steps, 1, forward=kernel_push(tr)), params)
        print(f"{name} unrolled=1, weights and batch from seed {seed}, from "
              "the float64 step: " + f64_reading(*f64_distances(
                  tr, u_all, var_all, idx, steps, 1, grads_k, grads_p)))


def train_main_path(trainer, u_all, name="MSMP-PDE", var_all=None):
    """Phases 10, 15 and 23: one train_epoch; returns the launch counts of
    the run and its time."""
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
    mean, losses = train_epoch(trainer, tx, u_all, var_all or {}, epoch=1,
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


def serve_path(engine, name, experiment="E1"):
    """Phases 5, 14 and 23, the serving main path: the port's HTTP server
    on localhost answers rollout requests (B = 1, 3, 16, 20, and one
    trajectory) at n_windows=8, each with the model's equation variables
    (U(0.1, 1) a sample), checked against RolloutEngine.rollout and
    against the expected kernel launches. Returns the launch counts of the
    run."""
    from http.server import ThreadingHTTPServer

    import numpy as np

    from msmp_pde_torch.serving import serve

    nx, T, d = engine.trainer.spec.nx, engine.trainer.tw, engine.trainer.d
    meta = {"backend": "cuda", "experiment": experiment, "model": name,
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
            r = np.random.default_rng(B)
            w = r.normal(size=(B, nx, d * T)).astype(np.float32)
            var = {k: r.uniform(0.1, 1.0, B).astype(np.float32)
                   for k in engine.trainer.eq_norms}
            before = launch_counts()
            t0 = time.perf_counter()
            got = serve.request_rollout("127.0.0.1", port, w,
                                        variables=var, n_windows=N_WINDOWS,
                                        as_trajectory=traj)
            lat = time.perf_counter() - t0
            served.append((B, traj, w, var, got, lat,
                           diff_counts(launch_counts(), before)))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join()
    totals = launch_counts()
    print(f"{name} main path launches: {nonzero(totals)}")
    for B, traj, w, var, got, lat, n in served:
        forwards = N_WINDOWS * -(-B // BUCKETS[-1])  # windows x chunks
        want = expected_launches(engine.trainer.model, forwards)
        check(n == want, f"{name} B={B}: launches {nonzero(n)}, expected "
              f"{nonzero(want)}")
        shape = ((B, N_WINDOWS * T, d, nx) if traj
                 else (B, N_WINDOWS, nx, d * T))
        check(got.shape == shape, f"{name} B={B}: response {got.shape}")
        check(bool(np.isfinite(got).all()), f"{name} B={B}: not finite")
        kw = dict(n_windows=N_WINDOWS, variables=var or None)
        direct = (engine.trajectory(w, **kw) if traj
                  else engine.rollout(w, **kw))
        check(np.array_equal(got, direct),
              f"{name} B={B}: served result differs from engine.rollout")
        print(f"{name} served B={B}{' trajectory' if traj else ''}: "
              f"{got.shape}, {lat * 1e3:.3f} ms, launches {nonzero(n)}")
    rollout_replay_check(engine, name)
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
            trainer.var_vec(steps, {}), spec.idx, spec.mask)
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
    fused_limit(spec, H, T, V)
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
    want_counts = dict.fromkeys(launch_counts(), 0)
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


def fused_limit(spec, H, T, V):
    """Phases 13 and 20: the largest batch whose pair backward takes the
    fused kernel at hidden H (``pair_bwd_fused_fits``), checked to take
    batches 1, 16 and 48 and to switch right after the limit."""
    import torch

    from msmp_pde_torch.ops import mp_pair

    nx, K = spec.idx.shape
    fits = lambda B: mp_pair.pair_bwd_fused_fits(B, nx, H, T, V, K,
                                                 spec.x.device)
    top, over = 1, 2  # the largest batch that fits, the least that does not
    while fits(over):
        top, over = over, 2 * over
    while over - top > 1:
        mid = (top + over) // 2
        top, over = (mid, over) if fits(mid) else (top, mid)
    print(f"fused pair backward at hidden {H} up to batch {top} (its "
          f"workspace in a quarter of "
          f"{torch.cuda.get_device_properties(0).total_memory} bytes); the "
          "fallback takes larger batches")
    check(all(fits(B) for B in (1, 16, 48)) and not fits(top + 1),
          f"pair_bwd_fused_fits switch at hidden {H}")
    return top


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


def fallback_step(trainer, u_all, name="MSMP-PDE", var_all=None):
    """Phases 13 and 23, the fallback's main path: one optimizer step of a
    gated model at batch 48 through ``train_step_fn`` with the fallback
    forced, every pair on the stash forward and two single-layer
    backwards. Returns the launch counts of the run."""
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
        loss = step(u_all, var_all or {}, torch.arange(B, device=dev), st)
    counts = launch_counts()
    L = trainer.model.layers
    want = expected_launches(trainer.model, 1, 1)
    want.update(mp_pair_fwd_stash=L, mp_pair_bwd=0, mp_layer_bwd=2 * L)
    check(counts == want, f"{name} step at batch {B}: launches "
          f"{nonzero(counts)}, expected {nonzero(want)}")
    check(bool(torch.isfinite(loss)), "batch-48 loss not finite")
    print(f"{name} train step at batch {B}: loss {loss.item():.4f}, "
          f"launches {nonzero(counts)}")
    return counts


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


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def datagen_phase(data_dir, on):
    """Phase 17: E1 datagen on the card through the generate CLI."""
    import numpy as np
    import torch

    from msmp_pde_torch.data.dataset import PDEDataset
    from msmp_pde_torch.datagen import generate, hdf5_io
    from msmp_pde_torch.equations import CE

    argv = ["--experiment=E1", "--chunk=32", "--seed=0", "--device=cuda",
            "--dtype=float64", f"--data_dir={data_dir}"]
    argv += [f"--{m}_samples={n}" for m, n in E1_SAMPLES.items()]
    args = generate.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    seconds = generate.main(args)
    took = time.perf_counter() - t0
    for (mode, key), sec in seconds.items():
        print(f"E1 datagen {mode} {key}, {E1_SAMPLES[mode]} samples: "
              f"{sec:.3f} s ({on})")
    print(f"E1 datagen in all (float64, the CLI's wall clock): {took:.3f} s "
          f"({on})")
    npz = Path(data_dir) / "CE_E1.npz"
    check(npz.is_file(), f"datagen wrote no {npz}")
    with hdf5_io.open_dataset(str(npz)) as f:
        for mode, n in E1_SAMPLES.items():
            for nt, nx in generate.RES_CE:
                name = f"{mode}/pde_{nt}-{nx}"
                u, a = f.array(name), f.attrs(name)
                pde = CE(tmax=4.0, grid_size=(nt, nx))
                check(u.shape == (n, nt, nx) and u.dtype == np.float64,
                      f"{name}: {u.shape} {u.dtype}")
                check(bool(np.isfinite(u).all()), f"{name}: not finite")
                check(int(a["nt"]) == nt and int(a["nx"]) == nx
                      and float(a["dt"]) == pde.dt
                      and float(a["dx"]) == pde.dx
                      and float(a["tmin"]) == 0.0
                      and float(a["tmax"]) == 4.0
                      and np.array_equal(a["x"], np.linspace(0, 16.0, nx)),
                      f"{name}: attributes {a}")
            for name, v in (("alpha", 1.0), ("beta", 0.0), ("gamma", 0.0)):
                check(np.array_equal(f.array(f"{mode}/{name}"),
                                     np.full(n, v)), f"{mode}/{name}")
        chunk = f.array("train/pde_250-100")[:32]
    # the first train chunk again, on the CPU, from the same draws
    pde = CE(tmin=0.0, tmax=4.0, grid_size=(250, 100))
    draws = generate.draw_chunk(np.random.default_rng(0), 32, args.batch_size,
                                *generate.CE_EXPERIMENTS["E1"][1:], pde)
    t0 = time.perf_counter()
    cpu = generate.ce_solver(pde, torch.float64, "cpu")(
        *(torch.as_tensor(a) for a in draws)).reshape(32, 250, 100).numpy()
    e = float(np.abs(cpu - chunk).max())
    print(f"E1 train chunk 0 at pde_250-100: max |card - CPU| = {e:.3e} "
          f"(max |u| {np.abs(cpu).max():.3f}; the CPU solve took "
          f"{time.perf_counter() - t0:.3f} s)")
    check(e <= TOL_DATAGEN, f"E1 datagen: the card's chunk differs from the "
          f"CPU's by {e:.3e} > {TOL_DATAGEN}")
    ds = PDEDataset(str(npz), pde, "train")
    check(ds.u_super.shape == (32, 250, 100) and ds.u_super.dtype == np.float32
          and bool(np.isfinite(ds.u_super).all()), "PDEDataset on E1")
    print(f"PDEDataset: train u_super {ds.u_super.shape} {ds.u_super.dtype}, "
          f"u_base {ds.u_base.shape}, x {ds.x.shape}")


# {launch counter: the names of the kernel that each of its launches runs
# once} (the hidden-164 LEM's ring kernels beside the others)
TRACED_KERNELS = {"lem_fwd": ("lem_fwd_kernel", "lem_fwd_ring"),
                  "lem_bwd": ("lem_bwd_sweep", "lem_bwd_ring"),
                  "mp_pair_fwd": ("mp_pair_fwd_kernel",),
                  "mp_pair_bwd": ("mp_pair_bwd_kernel",),
                  "mp_layer_fwd": ("mp_layer_fwd_kernel",),
                  "mp_layer_bwd": ("mp_layer_bwd_kernel",)}
REPLAY_STEPS = 4  # the steps of each depth that replay_check takes
RETRACES = 2  # rollout_replay_check's traces after one that misses records


def replay_check(trainer, calls, name):
    """What the graphed step of every fit is held to, from copies of
    ``trainer``'s weights: the last REPLAY_STEPS steps of each depth in
    ``calls`` ((depth, (u_all, var_all, idx, steps)) of the fit, in its
    order), as replays of CUDA graphs and through the eager step
    (``Trainer._one_step``) on the same kind of optimizer, with a milestone
    two steps in, cuDNN deterministic and TF32 off, give bitwise equal
    losses, weights and AdamW state, and move each launch counter alike;
    and the kernels that torch.profiler records in the replays are, name
    by name, the launches the counters add. Returns the counters' moves."""
    import copy
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    picked = sorted(i for f in {f for f, _ in calls} for i in
                    [j for j, c in enumerate(calls) if c[0] == f]
                    [-REPLAY_STEPS:])
    steps = [calls[i] for i in picked]
    with cudnn_deterministic():
        graphed, eager = copy.deepcopy(trainer), copy.deepcopy(trainer)
        check(graphed.graphed(), f"{name}: the graphed route not taken")
        tx_g = graphed.make_optimizer(1e-4, 0.4, [1], 2)
        tx_e = eager.make_optimizer(1e-4, 0.4, [1], 2)
        fns = {f: graphed.train_step_fn(tx_g, f) for f, _ in steps}
        ref = {f: eager._one_step(tx_e, f) for f, _ in steps}
        for f in fns:  # the captures, which change no state, untraced
            fns[f].capture(*next(a for g, a in steps if g == f))
        before = launch_counts()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        try:
            got = [fns[f](*a) for f, a in steps]
            torch.cuda.synchronize()
        finally:
            prof.stop()
        moved = diff_counts(launch_counts(), before)
        before = launch_counts()
        want = [ref[f](*a) for f, a in steps]
        torch.cuda.synchronize()
        check(diff_counts(launch_counts(), before) == moved,
              f"{name}: replays launched {nonzero(moved)}, the eager steps "
              f"{nonzero(diff_counts(launch_counts(), before))}")
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{name}: replayed losses {[x.item() for x in got]} against the "
          f"eager steps' {[x.item() for x in want]}")
    for (n, p), q in zip(graphed.model.named_parameters(),
                         eager.model.parameters()):
        check(torch.equal(p, q), f"{name}: {n} after the replays differs "
              "from the eager steps'")
        sg, se = tx_g[0].state[p], tx_e[0].state[q]
        check(sg.keys() == se.keys() and all(
            torch.equal(sg[k], se[k]) for k in sg),
            f"{name}: AdamW's state of {n} after the replays differs")
    kernels = Counter(e.name() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA)
    traced = {k: sum(n for kernel, n in kernels.items()
                     if any(x in kernel for x in names))
              for k, names in TRACED_KERNELS.items()}
    check(traced == {k: moved[k] for k in TRACED_KERNELS},
          f"{name}: kernels traced in the replays {traced}, the counters "
          f"moved {nonzero(moved)}")
    print(f"{name}: {len(steps)} graphed steps (depths "
          f"{[f for f, _ in steps]}) bitwise the eager steps' (losses, "
          f"weights, AdamW's state); their traced kernels "
          f"{nonzero(traced) or 'none'}, each the counters' move")
    return moved


def rollout_replay_check(engine, name):
    """What every served engine is held to after its serving phase: for
    each CUDA graph it captured (serving/engine.py::GraphedRollout, one a
    (bucket, n_windows, replica)), a request of the bucket's size with
    random windows, start steps and equation variables is replayed, not
    captured, and its answer is bitwise ``engine.program(n_windows)``
    called eagerly on the same inputs, under the same cuDNN and TF32
    settings as the capture; the replays move each launch counter as the
    eager calls do; and the kernels that torch.profiler records in the
    replays are, name by name, the launches the counters add.

    Where a trace keeps fewer records than the counters add, the requests
    are traced again, up to ``RETRACES`` times, and one exact trace
    passes. Only where every trace misses, each by the same records, all
    of them the LEM forward's cluster launches (``lem_fwd_kernel``,
    ``lem_fwd_ring``) and at most one a request, does the check pass,
    printing the shortfall beside what the profiler records in the eager
    calls of the same programs; any other miss fails. Returns the
    counters' moves."""
    from collections import Counter

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from msmp_pde_torch.serving import engine as engine_mod

    tr, dev = engine.trainer, engine.trainer.device
    keys = sorted(k for k in engine.graphs if k[2] == 0)
    check(bool(keys), f"{name}: no served rollout was replayed from a graph")
    nx, dtw, tw = tr.spec.nx, tr.d * tr.tw, tr.tw
    nt = int(tr.spec.t_grid.shape[0])
    requests = []
    for i, (bucket, n, _) in enumerate(keys):
        rng = np.random.default_rng(70 + i)
        requests.append((n, rng.normal(size=(bucket, nx, dtw)).astype(
            np.float32), rng.integers(tw, nt - tw + 1, bucket).astype(
            np.int32), {k: rng.uniform(0.1, 1.0, bucket).astype(np.float32)
                        for k in tr.eq_norms}))

    def eager_calls():
        with torch.inference_mode():
            return [engine.program(n)(
                torch.as_tensor(w, device=dev),
                torch.as_tensor(st, device=dev, dtype=torch.int64),
                {k: torch.as_tensor(v, device=dev) for k, v in var.items()}
            ).cpu().numpy() for n, w, st, var in requests]

    def replays():
        return [engine.rollout(w, var or None, start_step=st, n_windows=n)
                for n, w, st, var in requests]

    def traced(calls):
        """``calls()`` under torch.profiler: (what it returned, the
        counters' moves, the kernels traced by TRACED_KERNELS' names, the
        traced kernels whose names hold "lem")."""
        torch.cuda.synchronize()
        before = launch_counts()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        try:
            got = calls()
            torch.cuda.synchronize()
        finally:
            prof.stop()
        moved = diff_counts(launch_counts(), before)
        kernels = Counter(
            e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA)
        return got, moved, {k: sum(c for kernel, c in kernels.items()
                                   if any(x in kernel for x in names))
                            for k, names in TRACED_KERNELS.items()}, {
            k.split("(")[0]: c for k, c in kernels.items() if "lem" in k}

    captured, replayed = engine_mod.captures, engine_mod.replays
    got, moved, traced_k, lem_k = traced(replays)
    check(engine_mod.captures == captured
          and engine_mod.replays == replayed + len(requests),
          f"{name}: {engine_mod.captures - captured} captures and "
          f"{engine_mod.replays - replayed} replays for "
          f"{len(requests)} requests of captured buckets")
    before = launch_counts()
    want = eager_calls()
    eager = diff_counts(launch_counts(), before)
    check(eager == moved, f"{name}: replayed rollouts launched "
          f"{nonzero(moved)}, the eager programs {nonzero(eager)}")
    for (bucket, n, _), a, b in zip(keys, got, want):
        check(np.array_equal(a, b), f"{name} @bucket {bucket} x {n} "
              f"windows: the replay differs from the eager program by "
              f"{np.abs(a - b).max():.3e}")
    shorts = []
    for _ in range(RETRACES + 1):
        short = {k: moved[k] - traced_k[k] for k in TRACED_KERNELS}
        shorts.append(short)
        if not any(short.values()):
            break
        print(f"{name}: a trace of the replays kept {nonzero(traced_k)} "
              f"of the counters' {nonzero(moved)}; its LEM kernels {lem_k}")
        if len(shorts) <= RETRACES:
            _, moved, traced_k, lem_k = traced(replays)
    if any(shorts[-1].values()):
        _, _, eager_k, eager_lem = traced(eager_calls)
        lem_only = {k: 0 for k in TRACED_KERNELS}
        lem_only["lem_fwd"] = shorts[0]["lem_fwd"]
        check(all(s == shorts[0] for s in shorts)
              and shorts[0] == lem_only
              and 0 < lem_only["lem_fwd"] <= len(requests),
              f"{name}: kernels traced in the replayed rollouts "
              f"{traced_k}, the counters moved {nonzero(moved)}")
        print(f"{name}: every one of {len(shorts)} traces of the replays "
              f"kept {traced_k['lem_fwd']} of their {moved['lem_fwd']} LEM "
              f"forward records ({lem_k}); a trace of the eager calls kept "
              f"{eager_k['lem_fwd']} ({eager_lem}), its other kernels "
              f"{nonzero({k: v for k, v in eager_k.items() if k != 'lem_fwd'})}")
    print(f"{name}: {len(keys)} graphed rollouts ((bucket, n_windows) "
          f"{[k[:2] for k in keys]}) bitwise the eager program's; their "
          f"traced kernels {nonzero(traced_k) or 'none'}, the counters moved "
          f"{nonzero(moved) or 'none'}")
    return moved


def counted_fit(args, exp, data, save_path, on, snapshot=None):
    """Phases 18, 20 and 23: ``train.fit`` with each optimizer step's launches
    counted, and what every fit is held to: each step's expected launches,
    the metrics' forwards' launches, the pushforward depths of each epoch,
    finite losses, a loss falling within epoch 0, and after it
    ``replay_check`` on the fit's last steps. ``snapshot(save, path, model,
    tx, epoch)`` runs in place of each checkpoint save. Returns (fit's
    result, the run's launch counts, its seconds)."""
    import numpy as np

    from msmp_pde_torch.training import train
    from msmp_pde_torch.utils import checkpoint

    trainer, t_res = exp.trainer, exp.t_res
    model, name = trainer.model, args.model
    per_step, calls = [], []
    step_fn, save = trainer.train_step_fn, checkpoint.save_checkpoint

    def counted(tx, unrolled):
        fn = step_fn(tx, unrolled)

        def step(*a):
            before = launch_counts()
            loss = fn(*a)
            per_step.append((unrolled, diff_counts(launch_counts(), before)))
            calls.append((unrolled, a))
            return loss

        return step

    trainer.train_step_fn = counted
    if snapshot is not None:
        checkpoint.save_checkpoint = lambda *a: snapshot(save, *a)
    reset_counts()
    t0 = time.perf_counter()
    try:
        res = train.fit(args, exp, data, save_path)
    finally:
        checkpoint.save_checkpoint = save
        del trainer.train_step_fn
    took = time.perf_counter() - t0
    totals = launch_counts()
    epochs = args.num_epochs
    print(f"{name} fit: {epochs} epoch(s) in {took:.3f} s, launches "
          f"{nonzero(totals)}")

    n_batches = E1_SAMPLES["train"] // TRAIN_BATCH
    per_epoch = t_res * n_batches
    hist = res["history"]
    check(len(per_step) == epochs * per_epoch, f"{name} fit: step count")
    for i, (f, d) in enumerate(per_step):
        want = expected_launches(model, f + 1, 1)
        check(d == want, f"{name} fit step {i} (unrolled {f}): launches "
              f"{nonzero(d)}, expected {nonzero(want)}")
    # the metrics' forwards: the one-step losses at 9 steps and the 8-window
    # rollout of the unrolled loss, on one batch of the valid set; where
    # the validation loss improved, the same on the test set and the two
    # sets' L2 norms; with --short_horizon_windows, its windows on the
    # valid set, and on the test set where it improved
    steps_at, windows = 9, 8
    shw = getattr(args, "short_horizon_windows", 0)  # valid, and test
    fwd = sum(steps_at + windows + shw
              + (steps_at + 3 * windows + shw if h["improved"] else 0)
              for h in hist)
    summed = dict.fromkeys(totals, 0)
    for _, d in per_step:
        summed = {k: summed[k] + d[k] for k in totals}
    want = expected_launches(model, fwd)
    check(diff_counts(totals, summed) == want, f"{name} fit metrics: "
          f"launches {nonzero(diff_counts(totals, summed))}, expected "
          f"{nonzero(want)}")
    for k, n in expected_launches(model, 1, 1).items():
        check(totals[k] > 0 or n == 0, f"{name} fit launched no {k}")
    flags = [f for f, _ in per_step]
    for e in range(epochs):
        depths = set(range(min(e, args.unrolling) + 1))
        check(set(flags[e * per_epoch:(e + 1) * per_epoch]) == depths,
              f"{name} fit: pushforward depths of epoch {e}")
    for h in hist:
        check(bool(np.isfinite(h["losses"]).all()),
              f"{name} fit epoch {h['epoch']}: a loss is not finite")
        print(f"{name} fit epoch {h['epoch']}: {h['losses'].size} steps in "
              f"{h['train_s']:.3f} s, metrics {h['metric_s']:.3f} s, train "
              f"loss {h['train_loss']:.5f}, valid loss {h['val_loss']:.5f}"
              f"{' (best)' if h['improved'] else ''} ({on})")
    first = hist[0]["losses"].reshape(-1)
    check(first[-50:].mean() < first[:50].mean(),
          f"{name} fit: the loss did not fall within epoch 0")
    print(f"{name} fit epoch 0 mean loss, first 50 steps "
          f"{first[:50].mean():.4f}, last 50 {first[-50:].mean():.4f}")
    print(f"{name} fit: valid rel-L2 {100 * res['valid_rel_L2']:.3f} %, test "
          f"rel-L2 {100 * res['test_rel_L2']:.3f} % (32 training samples, "
          f"{epochs} epoch(s); {on})")
    replay_check(trainer, calls, name)
    return res, totals, took


def fit_phase(data_dir, work_dir, on, experiment="E1", model="MSMP-PDE",
              epochs=2, per_window=False, extra=(), suffix=""):
    """Phases 18, 23-26: fit ``model`` (MSMP-PDE or its 2-D version
    at full width, or a grid model at its reference widths) on
    ``experiment``'s data for ``epochs`` epochs, the checkpoint and
    resume, the L2 norms on both paths (one path for a grid model), and
    the server on the checkpoint answering a request with the test set's
    equation variables; ``extra``: more train CLI arguments. ``suffix``
    (phase 26's ``_I``) trains on the interpolated files and serves with
    ``--data_suffix``: both must take RPU's uniform grid, whose graph is
    the radius stencil. Returns the fit's launch counts.

    The L2 norms of the two paths agree within TOL_L2. With
    ``per_window`` (phase 23) the kernel path's 8-window rollout of the
    norms is held window by window instead, each window within TOL_MODEL
    of the plain path's forward from the same window, as phase 20 holds a
    served rollout: after one epoch the 2-D model's free-running rollouts
    amplify float32's rounding on either path (their norms, with the
    plain path's in float64, are printed)."""
    import contextlib
    import copy
    import io
    import types
    import urllib.request

    import numpy as np
    import torch

    from msmp_pde_torch.data.graph import (
        build_neighbors_radius,
        slice_windows,
    )
    from msmp_pde_torch.serving import serve
    from msmp_pde_torch.training import metrics, train
    from msmp_pde_torch.training.setup import (
        build_trainer,
        data_family,
        setup_experiment,
    )
    from msmp_pde_torch.utils import checkpoint

    name = model
    args = train.build_parser().parse_args([
        f"--experiment={experiment}", f"--model={name}",
        f"--num_epochs={epochs}", "--batch_size=16", "--unrolling=1",
        "--lr=1e-4", "--print_interval=100", "--device=cuda",
        f"--data_dir={data_dir}", f"--data_suffix={suffix}", *extra])
    exp = setup_experiment(args, data_dir=data_dir)
    trainer, t_res = exp.trainer, exp.t_res
    model = trainer.model
    uniform = (np.linspace(0.0, 16.0, 100).astype(np.float32),
               build_neighbors_radius(np.linspace(0.0, 16.0, 100),
                                      args.neighbors)[0])
    on_uniform = lambda spec: (  # noqa: E731
        np.array_equal(spec.x.cpu().numpy(), uniform[0])
        and np.array_equal(spec.idx.cpu().numpy(), uniform[1]))
    if suffix:
        check(on_uniform(trainer.spec), f"fit --data_suffix={suffix}: not "
              "the uniform grid's radius stencil")
        print(f"fit --data_suffix={suffix}: {name} trains on the uniform "
              f"grid of {trainer.spec.nx} (the radius stencil, K = "
              f"{trainer.spec.idx.shape[1]})")
    if trainer.kind == "grid":
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == GRID_PARAMS[name], f"fit: {name} has {n_params} "
              f"parameters, not {GRID_PARAMS[name]}")
    else:
        check(model.hidden == 128 and model.layers == 6
              and model.gate == "sigmoid" and model.encoder == "lem",
              f"fit: not {name} at full width")
    data = {m: train.device_arrays(exp.datasets[m], trainer.device)
            for m in E1_SAMPLES}
    save_path = str(Path(work_dir) / "models" / f"{name}_{experiment}.pt")

    # the state each checkpoint saved
    saved = []

    def snapshot(save, path, model, tx=None, epoch=None):
        save(path, model, tx, epoch)
        saved.append(({k: v.detach().clone()
                       for k, v in model.state_dict().items()},
                      copy.deepcopy(tx[0].state_dict()), tx[1].state_dict(),
                      epoch))

    res, totals, _ = counted_fit(args, exp, data, save_path, on, snapshot)
    hist = res["history"]
    n_batches = E1_SAMPLES["train"] // TRAIN_BATCH
    windows = 8  # of a rollout from nr_gt_steps to the data horizon

    # the best-val checkpoint, restored into a model of other weights
    check(Path(save_path).is_file() and saved, "fit wrote no checkpoint")
    sd, opt_sd, sched_sd, epoch = saved[-1]
    check(epoch == max(h["epoch"] for h in hist if h["improved"]),
          "the checkpoint is not the best epoch's")
    fresh = build_trainer(experiment, name, device=trainer.device, seed=1,
                          grid=exp.datasets["train"], data_suffix=suffix)
    tx = fresh.make_optimizer(args.lr, args.lr_decay, [args.unrolling, 5, 10,
                                                       15], t_res * n_batches)
    check(checkpoint.restore_checkpoint(save_path, fresh.model, tx) == epoch,
          "restored epoch")
    check(all(torch.equal(v, sd[k])
              for k, v in fresh.model.state_dict().items()),
          "restored parameters differ")
    got = tx[0].state_dict()
    check(got["state"].keys() == opt_sd["state"].keys() and all(
        torch.equal(got["state"][i][k], st[k])
        for i, st in opt_sd["state"].items() for k in st),
        "restored AdamW state differs")
    check(tx[1].state_dict() == sched_sd, "restored schedule differs")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        again = train.fit(train.build_parser().parse_args([
            f"--experiment={experiment}", f"--model={name}",
            "--batch_size=16", f"--num_epochs={epoch + 1}",
            f"--resume={save_path}"]),
            types.SimpleNamespace(trainer=fresh, t_res=t_res), data,
            str(Path(work_dir) / "models" / "resumed.pt"))
    check(f"at epoch {epoch + 1}" in out.getvalue() and not again["history"],
          "--resume did not start after the checkpoint's epoch")
    print(f"checkpoint of epoch {epoch}: parameters, AdamW's moments and "
          f"steps (step {int(next(iter(got['state'].values()))['step'])}), "
          f"the schedule (count {sched_sd['last_epoch']}) and the epoch "
          "restored bitwise; --resume starts at epoch "
          f"{epoch + 1}")

    # the paper's metric on the valid set, kernel path vs plain path (a
    # grid model has one path: its norms and their launches, none)
    u_v, _, var_v = data["valid"]
    quiet = dict(log=lambda *a: None)
    reset_counts()
    t0 = time.perf_counter()
    lk = metrics.compute_l2_norms(trainer, u_v, var_v, TRAIN_BATCH,
                                  args.nr_gt_steps, t_res, **quiet)
    k_s = time.perf_counter() - t0
    d = launch_counts()
    check(d == expected_launches(model, windows),
          f"compute_l2_norms launches {nonzero(d)}")
    if trainer.kind == "grid":
        check(all(np.isfinite(lk)), f"compute_l2_norms: {lk}")
        print(f"compute_l2_norms valid: L2 {lk[0]:.6f}, rel "
              f"{100 * lk[1]:.4f} % ({k_s:.3f} s), no kernel launched")
    else:
        plain = types.SimpleNamespace(tw=trainer.tw, d=trainer.d,
                                      forward=plain_forward(trainer))
        t0 = time.perf_counter()
        lp = metrics.compute_l2_norms(plain, u_v, var_v, TRAIN_BATCH,
                                      args.nr_gt_steps, t_res, **quiet)
        p_s = time.perf_counter() - t0
        rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        print(f"compute_l2_norms valid: kernel path L2 {lk[0]:.6f}, rel "
              f"{100 * lk[1]:.4f} % ({k_s:.3f} s); plain path L2 "
              f"{lp[0]:.6f}, rel {100 * lp[1]:.4f} % ({p_s:.3f} s); max "
              f"relative difference {rel:.3e}")
        if per_window:
            held_per_window(trainer, metrics, u_v, var_v, args.nr_gt_steps,
                            t_res, windows)
        else:
            check(rel <= TOL_L2, f"compute_l2_norms: kernel vs plain "
                  f"{rel:.3e} > {TOL_L2}")

    # the server on the checkpoint and the dataset's grid
    sargs = serve.build_parser().parse_args([
        f"--experiment={experiment}", f"--model={name}",
        f"--checkpoint={save_path}", f"--data_dir={data_dir}", "--port=0",
        "--warmup_windows=0", "--device=cuda", f"--data_suffix={suffix}"])
    srv, engine = serve.build_server(sargs)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    u_t, _, var_t = data["test"]
    steps = torch.full((4,), trainer.tw, dtype=torch.int64,
                       device=trainer.device)
    w = slice_windows(u_t[:4], steps, trainer.tw)[0].cpu().numpy()
    var = {k: var_t[k][:4].cpu().numpy() for k in trainer.eq_norms}
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        reset_counts()
        got = serve.request_rollout("127.0.0.1", port, w, variables=var,
                                    n_windows=N_WINDOWS)
        d = launch_counts()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    check(not th.is_alive(), "the server thread did not stop")
    stem = f"{data_family(experiment)}_{experiment}{suffix}.npz"
    check(health["grid"] == str(Path(data_dir) / stem),
          f"served grid {health['grid']}")
    check(not suffix or on_uniform(engine.trainer.spec),
          f"served with --data_suffix={suffix}: not the uniform grid")
    check(all(torch.equal(v.cpu(), sd[k].cpu())
              for k, v in engine.trainer.model.state_dict().items()),
          "the served weights are not the checkpoint's")
    check(d == expected_launches(model, N_WINDOWS),
          f"served request: launches {nonzero(d)}")
    check(got.shape == (4, N_WINDOWS, 100, trainer.d * trainer.tw)
          and bool(np.isfinite(got).all()), f"served {got.shape}")
    check(np.array_equal(got, engine.rollout(w, variables=var or None,
                                             n_windows=N_WINDOWS)),
          "the served rollout differs from engine.rollout")
    print(f"served the checkpoint on the grid of {health['grid']}: B=4, "
          f"{N_WINDOWS} windows, {got.shape}, equal to engine.rollout, "
          f"launches {nonzero(d)}")
    rollout_replay_check(engine, f"{name} served")
    return totals


def held_per_window(trainer, metrics, u_v, var_v, nr_gt_steps, t_res,
                    windows):
    """Phase 23: the kernel path's rollout of ``compute_l2_norms`` (the
    valid set's first batch, ``windows`` windows from nr_gt_steps tw) held
    window by window within TOL_MODEL (scaled by the window's largest
    value where that passes 1) of the plain path's forward from the same
    window (``plain_rollout`` following it); the free-running norms of
    the float32 plain path and of the plain path in float64 printed."""
    import types

    import numpy as np
    import torch

    from msmp_pde_torch.data.graph import slice_windows

    tw, B = trainer.tw, TRAIN_BATCH
    u, var = u_v[:B], {k: v[:B] for k, v in var_v.items()}
    steps = torch.full((B,), tw * nr_gt_steps, dtype=torch.int64,
                       device=u.device)
    with torch.inference_mode():
        preds = metrics._rollout_collect(trainer, u, var, nr_gt_steps,
                                         t_res)[0]
    got = preds.transpose(0, 1).cpu().numpy()  # [B, S, nx, d tw]
    check(got.shape[1] == windows, f"rollout windows {got.shape}")
    plain = plain_rollout(trainer, slice_windows(u, steps, tw)[0], steps,
                          windows, follow=got, variables=var)
    errs = [float(np.abs(got[:, i] - plain[:, i]).max())
            / max(1.0, float(np.abs(plain[:, i]).max()))
            for i in range(windows)]
    check(max(errs) <= TOL_MODEL, f"the fit's rollout vs the plain path's "
          f"windows {['%.2e' % x for x in errs]}")
    tr64 = double_trainer(trainer)
    quiet = dict(log=lambda *a: None)
    norms = {}
    for label, tr, uu, vv in (
            ("kernel path", trainer, u, var),
            ("plain path in float32", types.SimpleNamespace(
                tw=tw, d=trainer.d, forward=plain_forward(trainer)), u, var),
            ("plain path in float64", types.SimpleNamespace(
                tw=tw, d=trainer.d, forward=plain_forward(tr64)), u.double(),
             {k: v.double() for k, v in var.items()})):
        norms[label] = metrics.compute_l2_norms(tr, uu, vv, B, nr_gt_steps,
                                                t_res, **quiet)[0]
    ref = norms["plain path in float64"]
    print(f"the fit's valid rollout ({B} samples, {windows} windows): each "
          f"window within {max(errs):.3e} of the plain path's from the same "
          "window; free-running L2 " + ", ".join(
              f"{k} {v:.6f}" + ("" if k.endswith("64") else
                                f" ({abs(v - ref) / ref:.2e} from float64)")
              for k, v in norms.items()))


# the TPU kernel each CUDA kernel replaces
REPLACES = {"lem_fwd": "msmp_pde_tpu/ops/lem_pallas.py:41",
            "lem_fwd_stash": "msmp_pde_tpu/ops/lem_pallas.py:41",
            "lem_bwd": "msmp_pde_tpu/ops/lem_pallas.py:73",
            "mp_pair_fwd": "msmp_pde_tpu/ops/mp_pallas.py:260",
            "mp_pair_bwd": "msmp_pde_tpu/ops/mp_pallas.py:291",
            "mp_pair_fwd_stash": "msmp_pde_tpu/ops/mp_pallas.py:260",
            "mp_layer_fwd": "msmp_pde_tpu/ops/mp_pallas.py:156",
            "mp_layer_bwd": "msmp_pde_tpu/ops/mp_pallas.py:228"}
VARIANTS = ("MSSMP-PDE", "MSGMP-PDE", "SaveMSMP-PDE", "LSTMGated", "LSTM")
# phase 20's request: samples starting at 200, 225 and 150 cross nt - tw
# = 225 within 8 windows, the one at 25 does not
STATEFUL_STEPS = (25, 200, 150, 225)


def weighted_trainer(experiment, name, seed, dev, grid=None):
    """``build_trainer`` of ``name`` (on ``grid``, default the uniform
    one) with weights from ``flax_tree`` of a numpy seed through
    params_from_flax."""
    from msmp_pde_torch.training.setup import build_trainer
    from msmp_pde_torch.utils.convert import params_from_flax

    tr = build_trainer(experiment, name, device=dev, grid=grid)
    tr.model.load_state_dict(params_from_flax(flax_tree(tr.model, seed)),
                             strict=True)
    return tr


def variants_phase(rand, u_all, T, names=VARIANTS, experiment="E1",
                   var_all=None, seed=10, f64_models=()):
    """Phases 19 and 22: the models ``names`` at full width on
    ``experiment``'s grid (nx 100, tw 25, six layers or pairs, weights
    from a numpy seed in the flax layout through params_from_flax): one
    forward at batch 16 against reference_apply with its launches, the
    stateful model also from a non-zero state (the output and the new
    state), and one train step at batch 16, kernel path vs plain path,
    unrolled 0 and 1 (the state threaded through the pushforward; at
    unrolled 1 both steps from the kernel path's pushforward,
    ``check_train_step``). ``var_all``: the equation variables of
    ``u_all``'s samples, which the forwards take too; ``f64_models``: the
    models whose step ``check_train_step`` also holds against float64
    (``f64_yardstick``). Returns {name: trainer}."""
    import numpy as np
    import torch

    trainers = {}
    var_all = var_all or {}
    var = {k: v[:TRAIN_BATCH] for k, v in var_all.items()}
    for i, name in enumerate(names):
        tr = weighted_trainer(experiment, name, seed + i, u_all.device)
        m, spec = tr.model, tr.spec
        n_params = sum(v.numel() for v in m.state_dict().values())
        B, nx, dtw = TRAIN_BATCH, spec.nx, tr.d * T
        window = rand(B, nx, dtw)
        steps = torch.full((B,), T, dtype=torch.int64, device=u_all.device)
        H = m.diff_tower.hidden if m.twin_scale else m.hidden
        states = [None]
        if m.save_state:
            states.append(tuple(rand(B, nx, H, scale=.5) for _ in "yz"))
        for state in states:
            with torch.no_grad():
                reset_counts()
                out, new = tr.forward(window, steps, var, lem_state=state)
                counts = launch_counts()
                ref, ref_new = plain_forward(tr)(window, steps, var,
                                                 lem_state=state)
            torch.cuda.synchronize()
            want = expected_launches(m, 1)
            check(counts == want, f"{name} forward: launches "
                  f"{nonzero(counts)}, expected {nonzero(want)}")
            check(out.shape == (B, nx, dtw)
                  and bool(torch.isfinite(out).all()),
                  f"{name} output {tuple(out.shape)}")
            e = (out - ref).abs().max().item()
            if m.save_state:
                check(len(new) == 2 and all(
                    a.shape == (B, nx, H) for a in new), f"{name} state")
                e = max([e] + [(a - b).abs().max().item()
                               for a, b in zip(new, ref_new)])
            else:
                check(new is None and ref_new is None, f"{name}: a state")
            tag = ("" if state is None else
                   " from a non-zero state (output and new state)")
            print(f"{name} (hidden {H}, {n_params} parameters) forward "
                  f"B={B}{tag}: max |kernel path - plain path| = {e:.3e} "
                  f"(output max |.| {ref.abs().max().item():.3e}); launches "
                  f"{nonzero(counts)}")
            check(e <= TOL_MODEL, f"{name} differs by {e:.3e} > "
                  f"{TOL_MODEL}")
        check_train_step(tr, u_all, np.random.default_rng(1), name,
                         same_push=True, var_all=var_all,
                         f64_yardstick=name in f64_models)
        if name in ("MSSMP-PDE", "MSGMP-PDE"):
            step_drift(tr, u_all, name)
        trainers[name] = tr
    return trainers


def plain_rollout(trainer, window, steps, n_windows, follow=None,
                  variables=None):
    """The engine's rollout written out through ``plain_forward``: the
    windows advance by the pushforward rule, the time feature clamps to
    [tw, nt - tw], and the LEM state of each sample whose window starts
    past nt - tw is zeroed. With ``follow`` (another rollout [B, S, nx,
    d tw]) each window advances by that rollout's prediction instead of
    its own, the plain path's LEM state carried as its own. ``variables``:
    the equation variables, {name: [B] tensor on the trainer's device}."""
    import torch

    from msmp_pde_torch.data.graph import advance_windows

    tw, dev = trainer.tw, trainer.device
    nt = int(trainer.spec.t_grid.shape[0])
    forward = plain_forward(trainer)
    w = torch.as_tensor(window, device=dev)
    s = torch.as_tensor(steps, device=dev, dtype=torch.int64)
    preds, state = [], None
    with torch.no_grad():
        for i in range(n_windows):
            if i:
                last = (preds[-1] if follow is None else
                        torch.as_tensor(follow[:, i - 1], device=dev))
                w = advance_windows(w, last, trainer.d, tw)
                s = s + tw
                if state is not None:
                    keep = (s <= nt - tw).to(w.dtype)[:, None, None]
                    state = tuple(x * keep for x in state)
            pred, state = forward(w, torch.clamp(s, tw, nt - tw),
                                  variables or {}, lem_state=state)
            preds.append(pred)
    return torch.stack(preds, dim=1).cpu().numpy()


def serve_stateful(engine, name):
    """Phase 20, serving: the HTTP server answers a request of four
    samples at STATEFUL_STEPS and N_WINDOWS windows, equal to
    RolloutEngine.rollout, with its expected launches; each of its windows
    within TOL_MODEL (scaled by the window's largest value where that
    passes 1) of the plain path's forward from the same window
    (``plain_rollout`` following it, the same reset); for a stateful model
    the per-sample reset past nt - tw fires. The free-running plain
    rollout's distance is printed, not held, with each path's distance
    from the plain path in float64 window by window: at random weights
    a rollout amplifies float32's rounding from window to window, on
    either path. Returns the launch counts of the request."""
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from msmp_pde_torch.serving import engine as engine_mod
    from msmp_pde_torch.serving import serve

    tr = engine.trainer
    nx, T = tr.spec.nx, tr.tw
    meta = {"backend": "cuda", "experiment": "E1", "model": name,
            "buckets": list(BUCKETS)}
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve.make_handler(engine, meta))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    w = np.random.default_rng(20).normal(size=(4, nx, T)).astype(np.float32)
    steps = list(STATEFUL_STEPS)
    resets, reset = [], engine_mod.reset_past_horizon

    def counting(state, s, last):
        # the graph's capture records the reset on the card; its eager
        # warm-up before it reads how many samples it reset
        if not torch.cuda.is_current_stream_capturing():
            resets.append(int((s > last).sum()))
        return reset(state, s, last)

    engine_mod.reset_past_horizon = counting
    try:
        reset_counts()
        t0 = time.perf_counter()
        got = serve.request_rollout("127.0.0.1", srv.server_address[1], w,
                                    steps=steps, n_windows=N_WINDOWS)
        lat = time.perf_counter() - t0
        counts = launch_counts()
        direct = engine.rollout(w, start_step=steps, n_windows=N_WINDOWS)
    finally:
        engine_mod.reset_past_horizon = reset
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    check(not th.is_alive(), f"{name}: the server thread did not stop")
    want = expected_launches(tr.model, N_WINDOWS)
    check(counts == want, f"{name} served: launches {nonzero(counts)}, "
          f"expected {nonzero(want)}")
    check(got.shape == (4, N_WINDOWS, nx, T)
          and bool(np.isfinite(got).all()), f"{name} served {got.shape}")
    check(np.array_equal(got, direct),
          f"{name}: the served rollout differs from engine.rollout")
    plain = plain_rollout(tr, w, steps, N_WINDOWS, follow=got)
    errs = [float(np.abs(got[:, i] - plain[:, i]).max())
            / max(1.0, float(np.abs(plain[:, i]).max()))
            for i in range(N_WINDOWS)]
    e = max(errs)
    check(e <= TOL_MODEL, f"{name}: served vs the plain path's windows "
          f"{['%.2e' % x for x in errs]}")
    free = plain_rollout(tr, w, steps, N_WINDOWS)
    drift = float(np.linalg.norm(got - free) / np.linalg.norm(free))
    truth = plain_rollout(double_trainer(tr), w.astype(np.float64), steps,
                          N_WINDOWS)
    top = float(np.abs(truth).max())
    for label, r in (("served", got), ("plain path in float32", free)):
        per = " ".join("%.1e" % (float(np.abs(r[:, i] - truth[:, i]).max())
                                 / top) for i in range(N_WINDOWS))
        print(f"{name} {label}: max |error| / max |value| from the plain "
              f"path in float64, window by window: {per}")
    stateful = tr.model.save_state
    fired = sum(resets)
    check(fired > 0 if stateful else not resets,
          f"{name}: the state reset fired {resets}")
    print(f"{name} served B=4 from steps {steps}, {N_WINDOWS} windows: "
          f"{lat * 1e3:.3f} ms, equal to engine.rollout, each window within "
          f"{e:.3e} of the plain path's from the same window (the free-"
          f"running plain rollout at rel-L2 {drift:.3e}), launches "
          f"{nonzero(counts)}"
          + (f"; the state reset past nt - tw fired for {fired} "
             f"sample-windows in the capture's eager warm-up"
             if stateful else ""))
    rollout_replay_check(engine, name)
    return counts


def msgmp_fit_phase(data_dir, work_dir, on):
    """Phase 20, training: the train CLI's fit of MSGMP-PDE at full width
    (hidden 164, six gated pairs, the GLU decoder) on phase 17's data,
    batch 16, unrolling 1, lr 1e-4, one epoch. Returns (the trainer, the
    run's launch counts, its seconds)."""
    from msmp_pde_torch.training import train
    from msmp_pde_torch.training.setup import setup_experiment

    args = train.build_parser().parse_args([
        "--experiment=E1", "--model=MSGMP-PDE", "--num_epochs=1",
        "--batch_size=16", "--unrolling=1", "--lr=1e-4",
        "--print_interval=100", "--device=cuda", f"--data_dir={data_dir}"])
    exp = setup_experiment(args, data_dir=data_dir)
    model = exp.trainer.model
    check(model.hidden == GLU_H and model.layers == 6
          and model.gate == "sigmoid" and model.decoder == "glu",
          "fit: not MSGMP-PDE at full width")
    data = {m: train.device_arrays(exp.datasets[m], exp.trainer.device)
            for m in E1_SAMPLES}
    save_path = str(Path(work_dir) / "models" / "MSGMP-PDE_E1.pt")
    _, totals, took = counted_fit(args, exp, data, save_path, on)
    return exp.trainer, totals, took


MODELS_2D = ("MP-PDE2D", "Gated2D", "MSMP-PDE2D", "MSGMP-PDE2D",
             "SaveMSMP-PDE2D", "MSG2-PDE2D", "LSTMGated2D", "LEM2D",
             "GLEMGated2D", "LSTM2D")


def d50_phase(rand, T, dev):
    """Phase 21: the message-passing kernels at the 2-D models' shapes on
    RP's grid, D = 2 tw = 50 and V = 3 (t, a, b), with MSMP-PDE2D's,
    MSGMP-PDE2D's (hidden 164) and MP-PDE2D's weights: the pair's forward
    and backward at batches 1, 16 and 48 at hidden 128 and 164 (and the
    narrow odd width of phases 3 and 8), the stash at batch 48 with the
    fallback forced, both single-layer switch settings forward and
    backward at batches 1, 4, 16 and 48; each against its plain version,
    two runs bitwise equal. Returns ({kernel: max error}, the timings'
    (kernel, operands) at batch 16, the stash at 48)."""
    import torch

    from msmp_pde_torch.ops import mp_pair

    D = 2 * T
    gated = weighted_trainer("RP", "MSMP-PDE2D", 30, dev)
    glu = weighted_trainer("RP", "MSGMP-PDE2D", 31, dev)
    plain = weighted_trainer("RP", "MP-PDE2D", 32, dev)
    spec = gated.spec
    nx, V = spec.nx, 1 + len(gated.eq_norms)
    print(f"phase 21: the message-passing kernels at D = {D}, V = {V}")
    w = lambda m: tuple(x.detach() for x in (m.gate_0.weights()
                                             + m.gnn_0.weights()))
    errs, fwd_args = {}, {}
    with torch.no_grad():
        for H, W in ((128, w(gated.model)), (GLU_H, w(glu.model))):
            for B in (1, 16, 48):
                args = (rand(B, nx, H), rand(B, nx, D),
                        spec.x.expand(B, nx)[..., None] / spec.L,
                        rand(B, nx, V, scale=.5), spec.idx, spec.mask,
                        W[:12], W[12:])
                ok = mp_pair.fused_gated_pair(*args)
                again = mp_pair.fused_gated_pair(*args)
                op = mp_pair.fused_gated_pair_plain(*args)
                torch.cuda.synchronize()
                check(torch.equal(ok, again), f"mp_pair_fwd D={D} B={B} "
                      f"H={H}: two runs differ")
                e = (ok - op).abs().max().item()
                errs["mp_pair_fwd"] = max(errs.get("mp_pair_fwd", 0.0), e)
                print(f"mp_pair_fwd D={D} V={V} B={B} H={H}: max |kernel - "
                      f"plain| = {e:.3e}; two runs bitwise equal")
                check(e <= TOL_PAIR, f"mp_pair_fwd D={D} B={B} H={H} "
                      f"differs by {e:.3e} > {TOL_PAIR}")
                fwd_args[(H, B)] = args
    e_bwd, bwd_args = check_pair_bwd(
        rand, gated.model, spec, D, 128, V,
        (glu.model.gate_0.weights(), glu.model.gnn_0.weights()),
        b164=(1, 16, 48))
    errs["mp_pair_bwd"] = max(e_bwd.values())
    errs["mp_layer_fwd"], errs["mp_layer_bwd"] = check_layer_kernels(
        rand, plain.model.gnn_0.weights(), spec, D, 128, V)
    errs["mp_pair_fwd_stash"], e_fb, stash = check_pair_fallback(
        rand, gated.model, spec, D, 128, V)
    errs["mp_pair_fallback"] = e_fb
    W1 = tuple(x.detach() for x in plain.model.gnn_0.weights())
    layer = (*fwd_args[(128, 16)][:6], W1)
    g16 = bwd_args[128][-1]
    return errs, [("mp_pair_fwd", fwd_args[(128, 16)]),
                  ("mp_pair_bwd", bwd_args[128]),
                  ("mp_layer_fwd", layer), ("mp_layer_bwd", (*layer, g16)),
                  ("mp_pair_fwd_stash", stash[0])]


def rp_datagen_phase(data_dir, on, experiment="RP"):
    """Phases 23 and 26, datagen: RP (or RPU, on its LCG grids) through the
    generate CLI on the card (32, 16 and 16 samples, float64) into
    ``data_dir``; the four resolutions, the schema's keys and attributes
    (RPU's x each resolution's ``pseudo_random_grid`` bit for bit), a and b
    by groups within their ranges, finite values, the first train chunk
    at pde_250-100 against the port's CPU solve of the same draws on the
    same grid, and PDEDataset reading it (RPU's target its base
    trajectories)."""
    import numpy as np
    import torch

    from msmp_pde_torch.data.dataset import PDEDataset
    from msmp_pde_torch.datagen import generate, hdf5_io
    from msmp_pde_torch.equations import AD
    from msmp_pde_torch.training.setup import pde_for_experiment

    rpu = experiment == "RPU"
    argv = [f"--experiment={experiment}", "--chunk=32", "--seed=0",
            "--device=cuda", "--dtype=float64", f"--data_dir={data_dir}"]
    argv += [f"--{m}_samples={n}" for m, n in E1_SAMPLES.items()]
    args = generate.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    seconds = generate.main(args)
    took = time.perf_counter() - t0
    print(f"{experiment} datagen in all (float64, the CLI's wall clock): "
          f"{took:.3f} s, the solves {sum(seconds.values()):.3f} s ({on})")
    tmax, a_range, b_range, family = generate.AD_EXPERIMENTS[experiment]
    npz = Path(data_dir) / f"AD_{experiment}.npz"
    check(npz.is_file(), f"datagen wrote no {npz}")
    with hdf5_io.open_dataset(str(npz)) as f:
        for mode, n in E1_SAMPLES.items():
            for nt, nx in generate.RES_AD:
                name = f"{mode}/pde_{nt}-{nx}"
                u, a = f.array(name), f.attrs(name)
                pde = AD(tmax=tmax, grid_size=(nt, nx), L=16.0)
                x = generate.ad_grid(pde, rpu)
                check(u.shape == (n, 2, nt, nx) and u.dtype == np.float64,
                      f"{name}: {u.shape} {u.dtype}")
                check(bool(np.isfinite(u).all()), f"{name}: not finite")
                check(int(a["nt"]) == nt and int(a["nx"]) == nx
                      and float(a["dt"]) == pde.dt
                      and float(a["dx"]) == pde.dx
                      and float(a["tmin"]) == 0.0
                      and float(a["tmax"]) == tmax
                      and a["x"].tobytes() == x.tobytes(),
                      f"{name}: attributes {a}")
            for name, (lo, hi) in (("a", a_range), ("b", b_range)):
                v = f.array(f"{mode}/{name}")
                check(v.shape == (n,) and lo <= v.min() and v.max() <= hi
                      and bool(np.all(v.reshape(-1, args.batch_size)
                                      == v[::args.batch_size, None])),
                      f"{mode}/{name}: {v}")
        chunk = f.array("train/pde_250-100")[:32]
    if rpu:
        print("RPU: each resolution's stored x is pseudo_random_grid's LCG "
              "grid bit for bit")
    pdes = generate.ad_pdes(tmax, family)
    draws = generate.draw_ad_chunk(np.random.default_rng(0), 32,
                                   args.batch_size, a_range, b_range,
                                   family, next(iter(pdes.values())))
    cpu = generate.ad_solver(pdes["pde_250-100"], family, torch.float64,
                             "cpu", rpu)(*(torch.as_tensor(d) for d in draws))
    e = float(np.abs(cpu.numpy() - chunk).max())
    print(f"{experiment} train chunk 0 at pde_250-100: max |card - CPU| = "
          f"{e:.3e} (max |u| {float(cpu.abs().max()):.3f})")
    check(e <= TOL_DATAGEN, f"{experiment} datagen: the card's chunk differs "
          f"from the CPU's by {e:.3e} > {TOL_DATAGEN}")
    ds = PDEDataset(str(npz), pde_for_experiment(experiment, (250, 100)),
                    "train")
    check(ds.u_super.shape == (32, 250, 2, 100)
          and ds.u_super.dtype == np.float32 and ds.n_components == 2
          and bool(np.isfinite(ds.u_super).all())
          and set(ds.variables) == {"a", "b"}, f"PDEDataset on {experiment}")
    if rpu:
        check(np.array_equal(ds.u_super, ds.u_base), "RPU's target is not "
              "its base trajectories")
    print(f"PDEDataset: {experiment} train u_super {ds.u_super.shape} "
          f"{ds.u_super.dtype}, u_base {ds.u_base.shape}, x {ds.x.shape}")

# phase 24: the grid models, their parameter counts at the reference
# widths (the JAX modules' at nx 100, tw 25; FNOP with E3's three
# variables, the 2-D ones with a and b)
GRID_PARAMS = {"BaseCNN": 69905, "FNO": 554201, "FNOP": 554393,
               "VNO": 554201, "BaseCNN2D": 667570, "FNO2D": 2192818,
               "FNO2DP": 2193074, "FNO2DPU": 2193074}
# phase 24, relative to max|out|: the float32 forward against the same
# module in float64. Float32 rounds at 6e-8; a grid forward is at most
# ~10 layers of sums over <= 1,152 terms (BaseCNN2D's convolutions 128 x
# 9, the FFTs over 100 points, the channel mixes over 128 x 16 modes),
# whose rounding grows with sqrt(terms) and compounds layer by layer to
# ~1e-6 of the output's scale; 1e-5 leaves a tenfold margin and is
# tighter than 1e-4.
TOL_GRID = 1e-5


def grid_models_phase(rand, dev, on, names=None, experiment=None,
                      grid=None):
    """Phase 24, the models: the seven grid models at the reference widths
    (BaseCNN, FNO and VNO on E1's grid, FNOP on E3's with alpha, beta and
    gamma, BaseCNN2D, FNO2D and FNO2DP on RP's with a and b; weights from
    a numpy seed through params_from_flax), or ``names`` on
    ``experiment``'s ``grid`` (phase 26: FNO2DPU on RPU's LCG grid): the
    forward at batch 16 in
    float32 (TF32 off) against the same module in float64 on the card
    within TOL_GRID of max|out|, a step's loss (TRAIN_LOSS_RTOL) and every
    gradient (``scale_aware``) at unrolled 0 and 1 against the float64
    step (at 1 from the float32 path's pushed window,
    ``f64_step_grads``), no launch of a kernel of the table in any of
    them; then each model's forward, step and rollout times. Returns
    {name: trainer}."""
    import numpy as np
    import torch

    from msmp_pde_torch.models.registry import GRID
    from msmp_pde_torch.serving.engine import (
        RolloutEngine,
        build_serving_trainer,
    )
    from msmp_pde_torch.tools.model_times import (
        experiment_of,
        time_rollouts,
        time_train_steps,
        train_data,
    )

    trainers = {}
    names = names or tuple(n for n in GRID if n != "FNO2DPU")
    for i, name in enumerate(GRID):
        if name not in names:
            continue
        on_exp = experiment or experiment_of(name)
        tr = weighted_trainer(on_exp, name, 70 + i, dev, grid)
        n_params = sum(p.numel() for p in tr.model.parameters())
        check(tr.kind == "grid" and n_params == GRID_PARAMS[name],
              f"{name}: {n_params} parameters, not {GRID_PARAMS[name]}")
        u_all, var_all = train_data(tr, TRAIN_BATCH, seed=80 + i)
        B, nx, dtw = TRAIN_BATCH, tr.spec.nx, tr.d * tr.tw
        window = rand(B, nx, dtw)
        steps = torch.full((B,), tr.tw, dtype=torch.int64, device=dev)
        tr64 = double_trainer(tr)
        reset_counts()
        with torch.no_grad():
            out, state = tr.forward(window, steps, var_all)
            ref, _ = tr64.forward(window.double(), steps,
                                  {k: v.double() for k, v in var_all.items()})
        torch.cuda.synchronize()
        check(out.shape == (B, nx, dtw) and state is None
              and bool(torch.isfinite(out).all()),
              f"{name} output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        e = (out.double() - ref).abs().max().item()
        print(f"{name} ({on_exp}, {n_params} parameters) forward B={B} "
              f"float32 vs float64 on the card: max |diff| = {e:.3e} "
              f"(output max |.| {scale:.3e}; bound {TOL_GRID * scale:.3e})")
        check(e <= TOL_GRID * scale, f"{name} float32 forward differs from "
              f"float64 by {e:.3e} > {TOL_GRID} x {scale:.3e}")
        names = [n for n, _ in tr.model.named_parameters()]
        rng = np.random.default_rng(90 + i)
        for unrolled in (0, 1):
            idx, st = step_batch(rng, TRAIN_BATCH, unrolled, dev)
            loss = tr.step_loss(u_all, var_all, idx, st, unrolled)
            grads = torch.autograd.grad(loss, list(tr.model.parameters()))
            loss64, g64 = f64_step_grads(tr, u_all, var_all, idx, st,
                                         unrolled)
            rel = abs(loss.item() - loss64.item()) / abs(loss64.item())
            check(rel <= TRAIN_LOSS_RTOL, f"{name} step unrolled={unrolled}"
                  f": loss {loss.item()} vs float64 {loss64.item()}")
            scales = grad_scales(zip(names, g64))
            worst = 0.0
            for pname, a, b in zip(names, grads, g64):
                check(bool(torch.isfinite(a).all()), f"{pname}: not finite")
                ok, err = scale_aware(a.double(), b, scales[pname])
                worst = max(worst, err / scales[pname])
                check(ok, f"{name} step unrolled={unrolled}: {pname} grad "
                      f"differs from float64 by {err:.3e} (scale "
                      f"{scales[pname]:.3e})")
            print(f"{name} train step B={TRAIN_BATCH} unrolled={unrolled} "
                  f"against float64: loss {loss.item():.6f} (rel "
                  f"{rel:.2e}); {len(names)} grads within the scale-aware "
                  f"bound (largest {worst:.2e} of a scale)")
        # the last loss's autograd graph would tie the parameters' gradient
        # accumulators to this stream: the graphed step below could not be
        # captured
        del loss
        counts = launch_counts()
        check(not any(counts.values()), f"{name}: launches "
              f"{nonzero(counts)}, expected none")
        with torch.no_grad():
            ms = timed(lambda: tr.forward(window, steps, var_all), reps=5)
            hms = host_ms(lambda: tr.forward(window, steps, var_all))
        print(f"{name} forward @bucket 16: {ms:.4f} ms (CUDA events; host "
              f"enqueue {hms:.4f} ms; no kernel of the table)")
        # five profiled steps: the profiler's host-side processing of a
        # 50-step trace of a grid model takes ~19 s (an H100 machine's host)
        time_train_steps(tr, u_all, name, var_all)
        engine = RolloutEngine(
            build_serving_trainer(on_exp, name, device=dev, grid=grid),
            {k: v.detach() for k, v in tr.model.state_dict().items()},
            batch_buckets=BUCKETS)
        time_rollouts(engine, name)
        trainers[name] = tr
    print(f"grid model timings on {on}")
    return trainers


def eval_phase(data_dir, work_dir, experiment, name, ckpt, extra=()):
    """Phase 24, the eval CLI on ``ckpt`` (run in ``work_dir``): its test
    L2 / rel-L2 equal ``compute_l2_norms`` on the checkpoint's weights,
    its launches those of its forwards (none for a grid model). Returns
    eval's metrics."""
    from msmp_pde_torch.training import eval as evaluate
    from msmp_pde_torch.training import metrics, train
    from msmp_pde_torch.training.setup import setup_experiment
    from msmp_pde_torch.utils.checkpoint import restore_params

    args = evaluate.build_parser().parse_args([
        f"--experiment={experiment}", f"--model={name}",
        f"--model_to_test={ckpt}", f"--data_dir={data_dir}",
        "--batch_size=16", "--device=cuda", *extra])
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(work_dir):
        out = evaluate.main(args)
    took = time.perf_counter() - t0
    counts = launch_counts()
    exp = setup_experiment(args, modes=("test",), data_dir=data_dir)
    tr = exp.trainer
    tr.model.load_state_dict(restore_params(ckpt), strict=True)
    u, _, var = train.device_arrays(exp.datasets["test"], tr.device)
    want = metrics.compute_l2_norms(tr, u, var, 16, args.nr_gt_steps,
                                    exp.datasets["test"].nt,
                                    log=lambda *a: None)
    got = (out["test_L2"], out["test_rel_L2"])
    check(got == want, f"eval {name}: L2 {got} vs compute_l2_norms {want}")
    # 8 windows each: the L2 norms, the unrolled losses, the store
    forwards = 3 * 8
    check(counts == expected_launches(tr.model, forwards),
          f"eval {name}: launches {nonzero(counts)}")
    print(f"eval CLI on {name}'s checkpoint ({experiment}): test L2 "
          f"{got[0]:.6f}, rel-L2 {100 * got[1]:.4f} %, equal to "
          f"compute_l2_norms; unrolled loss {out['test_loss']:.5f}; figures "
          f"{'written' if out['figures'] else 'skipped (no matplotlib)'}; "
          f"launches {nonzero(counts) or 'none'}; {took:.3f} s")
    return out


def cv_phase(data_dir, work_dir):
    """Phase 24, the cv CLI: BaseCNN one epoch on E1's 64 merged samples,
    re-split 51/6/7 from seed 0 + rep 0, batch 16; finite results, the
    checkpoint under --cv_folder, no launch of a kernel of the table."""
    import numpy as np

    from msmp_pde_torch.training import cv

    folder = str(Path(work_dir) / "cvE1")
    args = cv.build_parser().parse_args([
        "--experiment=E1", "--model=BaseCNN", "--num_epochs=1",
        "--batch_size=16", "--print_interval=1000", "--device=cuda",
        f"--data_dir={data_dir}", f"--cv_folder={folder}"])
    sizes = [len(a) for a in cv.split_indices(64, 0, 0)]
    reset_counts()
    t0 = time.perf_counter()
    res = cv.main(args)
    took = time.perf_counter() - t0
    counts = launch_counts()
    check(not any(counts.values()), f"cv: launches {nonzero(counts)}")
    (h,) = res["history"]
    check(sizes == [51, 6, 7] and h["losses"].shape == (250, 3)
          and bool(np.isfinite(h["losses"]).all()), "cv: the epoch")
    check(all(np.isfinite(res[k]) for k in ("valid_L2", "test_L2")),
          "cv: the L2 norms")
    ckpts = list(Path(folder).glob("BaseCNN_CE_E1_rep0_*.pt"))
    check(len(ckpts) == 1, f"cv: checkpoints {ckpts}")
    print(f"cv CLI: BaseCNN on E1's 64 merged samples split {sizes}, one "
          f"epoch of {h['losses'].size} steps in {took:.3f} s, valid rel-L2 "
          f"{100 * res['valid_rel_L2']:.3f} %, test rel-L2 "
          f"{100 * res['test_rel_L2']:.3f} %, checkpoint {ckpts[0].name}")


# phase 25: the wave equation, KF and KS. The datagen CLI's families of
# this phase (KS through generate_ks, restricted to the resolutions fit
# reads, 250-200 and 250-100)
FAMILIES = ("WE1", "WE2", "WE3", "KF")
KS_RES = [(250, 200), (250, 100)]
# KS on the card against the CPU, float64: fine steps kept over the first
# 9,575 (t = 2.39, the transient's 8,001 and one output step), covering
# every CUDA graph of the binary decomposition
KS_SHORT_SAVE = (1, 7, 600, 1100, 8001, 9575)
# the CPU's run of KS over the whole horizon: train sample 0 at 250-100
KS_CPU_CODE = """
import sys, time
import numpy as np, torch
torch.set_num_threads(1)
from msmp_pde_torch.datagen import generate, ics
ks = generate.ks_pdes(100.0, 0.00025, [(250, 100)])["pde_250-100"]
draws = ics.sample_sine_params(np.random.default_rng(0), 32, ks.n_waves,
                               ks.lmin, ks.lmax)
t0 = time.perf_counter()
(u, valid), = generate.ks_solve([ks], [a[:1] for a in draws],
                                torch.float64, "cpu")
np.save(sys.argv[1], u.numpy())
print(time.perf_counter() - t0)
"""


def family_datagen_phase(data_dir, on, experiment):
    """Phase 25, datagen of WE1-3 or KF through the generate CLI on the
    card (32/16/16 samples, chunk 32, float64) into ``data_dir``: the
    schema (every resolution's keys and attributes, WE's Chebyshev x and
    its boundaries as ints, WE3's bc_right Dirichlet, c; KF's r and D by
    groups within their ranges), finite values, the first train chunk at
    pde_250-100 against the port's CPU solve of the same draws
    (TOL_DATAGEN), and PDEDataset reading it."""
    import numpy as np
    import torch

    from msmp_pde_torch.data.dataset import PDEDataset
    from msmp_pde_torch.datagen import generate, hdf5_io
    from msmp_pde_torch.equations.we import BC_NAMES
    from msmp_pde_torch.training.setup import data_family, pde_for_experiment

    argv = [f"--experiment={experiment}", "--chunk=32", "--seed=0",
            "--device=cuda", "--dtype=float64", f"--data_dir={data_dir}"]
    argv += [f"--{m}_samples={n}" for m, n in E1_SAMPLES.items()]
    args = generate.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    seconds = generate.main(args)
    took = time.perf_counter() - t0
    print(f"{experiment} datagen in all (float64, the CLI's wall clock): "
          f"{took:.3f} s, the solves {sum(seconds.values()):.3f} s ({on})")
    we = data_family(experiment) == "WE"
    pdes = generate.we_pdes(100.0) if we else generate.kf_pdes(5.0)
    npz = Path(data_dir) / f"{data_family(experiment)}_{experiment}.npz"
    check(npz.is_file(), f"datagen wrote no {npz}")
    with hdf5_io.open_dataset(str(npz)) as f:
        for mode, n in E1_SAMPLES.items():
            for key, pde in pdes.items():
                name = f"{mode}/{key}"
                u, a = f.array(name), f.attrs(name)
                x = pde.x if we else np.linspace(0.0, 16.0, pde.nx)
                check(u.shape == (n, pde.nt, pde.nx)
                      and u.dtype == np.float64, f"{name}: {u.shape}")
                check(bool(np.isfinite(u).all()), f"{name}: not finite")
                check(int(a["nt"]) == pde.nt and int(a["nx"]) == pde.nx
                      and float(a["dt"]) == pde.dt
                      and float(a["dx"]) == pde.dx
                      and float(a["tmin"]) == 0.0
                      and float(a["tmax"]) == pde.tmax
                      and np.array_equal(a["x"], x),
                      f"{name}: attributes {a}")
            if we:
                left, right = (f.array(f"{mode}/bc_{s}")
                               for s in ("left", "right"))
                want_left = {"WE1": {0}, "WE2": {1}, "WE3": {0, 1}}
                check(left.dtype.kind == right.dtype.kind == "i"
                      and set(left) <= want_left[experiment]
                      and np.array_equal(
                          right, left if experiment != "WE3"
                          else np.zeros(n, int))
                      and np.array_equal(f.array(f"{mode}/c"),
                                         np.full(n, 2.0)),
                      f"{experiment} {mode}: the boundaries {left} {right}")
            else:
                for name, (lo, hi) in zip(
                        ("r", "D"), generate.KF_EXPERIMENTS["KF"][1:]):
                    v = f.array(f"{mode}/{name}")
                    check(v.shape == (n,) and lo <= v.min()
                          and v.max() <= hi and bool(np.all(
                              v.reshape(-1, args.batch_size)
                              == v[::args.batch_size, None])),
                          f"{mode}/{name}: {v}")
        chunk = f.array("train/pde_250-100")[:32]
    pde = pdes["pde_250-100"]
    t0 = time.perf_counter()
    if we:
        bc_l, bc_r, starts = generate.draw_we_mode(
            np.random.default_rng(0), 32, generate.WE_EXPERIMENTS[experiment])
        cpu = np.empty_like(chunk)
        for bl in np.unique(bc_l):
            sel = bc_l == bl
            pde.bc_left, pde.bc_right = BC_NAMES[bl], BC_NAMES[bc_r[sel][0]]
            cpu[sel] = generate.we_solve(
                pde, generate.we_initial_state(pde.x, starts[sel], 2.0), 2.0,
                torch.float64, "cpu")[:, ::-1]
    else:
        draws = generate.draw_kf_chunk(
            np.random.default_rng(0), 32, args.batch_size,
            *generate.KF_EXPERIMENTS["KF"][1:], pdes["pde_250-200"])
        cpu = generate.kf_solver(pde, torch.float64, "cpu")(
            *(torch.as_tensor(d) for d in draws)).numpy()
    e = float(np.abs(cpu - chunk).max())
    print(f"{experiment} train chunk 0 at pde_250-100: max |card - CPU| = "
          f"{e:.3e} (max |u| {np.abs(cpu).max():.3f}; the CPU solve took "
          f"{time.perf_counter() - t0:.3f} s)")
    check(e <= TOL_DATAGEN, f"{experiment} datagen: the card's chunk "
          f"differs from the CPU's by {e:.3e} > {TOL_DATAGEN}")
    ds = PDEDataset(str(npz), pde_for_experiment(experiment, (250, 100)),
                    "train")
    check(ds.u_super.shape == (32, 250, 100)
          and ds.u_super.dtype == np.float32
          and bool(np.isfinite(ds.u_super).all()), f"PDEDataset on "
          f"{experiment}")
    print(f"PDEDataset: {experiment} train u_super {ds.u_super.shape}, "
          f"variables {sorted(ds.variables)}, x {ds.x[:3]} ...")
    return took


def ks_datagen_phase(data_dir, on):
    """Phase 25, KS datagen: ``generate_ks`` at the reference's dt 0.00025
    and tend 100 (400,000 fine steps, a transient of 8,001), restricted to
    KS_RES, 32/16/16 samples (one batch of 64 a resolution, the two on a
    stream each): the schema, every trajectory valid and finite, the time
    and its ms per 1,000 fine steps; each resolution alone over 20,000
    steps; on the card the CUDA graphs' replays bitwise equal to the eager
    loop of the same step; the card against the CPU over KS_SHORT_SAVE
    (TOL_DATAGEN); PDEDataset reading it."""
    import numpy as np
    import torch

    from msmp_pde_torch.data.dataset import PDEDataset
    from msmp_pde_torch.datagen import generate, hdf5_io, ics
    from msmp_pde_torch.training.setup import pde_for_experiment

    argv = ["--experiment=KS", "--chunk=32", "--seed=0", "--device=cuda",
            "--dtype=float64", f"--data_dir={data_dir}"]
    argv += [f"--{m}_samples={n}" for m, n in E1_SAMPLES.items()]
    args = generate.build_parser().parse_args(argv)
    tend, dt = generate.KS_EXPERIMENTS["KS"]
    t0 = time.perf_counter()
    seconds = generate.generate_ks(args, tend, dt, resolutions=KS_RES)
    took = time.perf_counter() - t0
    kss = generate.ks_pdes(tend, dt, KS_RES)
    steps = next(iter(kss.values())).nsteps
    solve_s = seconds[("all", "all resolutions")]
    print(f"KS datagen (float64, dt {dt}, {steps} fine steps, the "
          f"resolutions {', '.join(kss)} only, 64 samples a batch): "
          f"{took:.3f} s, the solves {solve_s:.3f} s together, "
          f"{1e3 * solve_s / (steps / 1000):.3f} ms per 1,000 fine steps "
          f"of both ({on})")
    npz = Path(data_dir) / "KS_KS.npz"
    check(npz.is_file(), f"datagen wrote no {npz}")
    with hdf5_io.open_dataset(str(npz)) as f:
        for mode, n in E1_SAMPLES.items():
            for key, ks in kss.items():
                name = f"{mode}/{key}"
                u, a = f.array(name), f.attrs(name)
                check(u.shape == (n, 250, ks.nx)
                      and bool(np.isfinite(u).all()), f"{name}: {u.shape}")
                check(int(a["nt"]) == 250 and int(a["nx"]) == ks.nx
                      and float(a["dt"]) == tend / 250
                      and float(a["dx"]) == ks.dx
                      and float(a["tmin"]) == 0.0
                      and float(a["tmax"]) == tend
                      and np.array_equal(a["x"], np.linspace(
                          0.0, 2 * np.pi * ks.L, ks.nx)),
                      f"{name}: attributes {a}")
    dev = torch.device("cuda")
    for key, ks in kss.items():
        params = ics.sample_sine_params(np.random.default_rng(0), 32,
                                        ks.n_waves, ks.lmin, ks.lmax)
        x = torch.as_tensor(np.linspace(0.0, 2 * np.pi * ks.L, ks.nx),
                            device=dev)
        A, _, phi, l = (torch.as_tensor(p, device=dev) for p in params)
        u0 = ics.ks_ic(A, phi, l, x, ks.L)
        u64 = torch.cat([u0, u0])  # 64 rows, as the datagen batch
        for _ in range(2):  # the first call builds cuFFT's plans
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ks.simulate(u64, np.array([10000, 20000]))
            torch.cuda.synchronize()
            alone = time.perf_counter() - t0
        t0 = time.perf_counter()
        eager, _ = ks.simulate(u64, np.array(KS_SHORT_SAVE[:4]),
                               graphs=False)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        graphed, _ = ks.simulate(u64, np.array(KS_SHORT_SAVE[:4]))
        check(torch.equal(eager, graphed), f"KS {key}: the graphs' replays "
              "differ from the eager loop")
        card, _ = ks.simulate(u0[:4], np.array(KS_SHORT_SAVE))
        t0 = time.perf_counter()
        cpu, _ = ks.simulate(u0[:4].cpu(), np.array(KS_SHORT_SAVE))
        cpu_s = time.perf_counter() - t0
        e = float((card.cpu() - cpu).abs().max())
        eager_ms = 1e6 * eager_s / KS_SHORT_SAVE[3]
        print(f"KS {key}, 64 rows: {1e3 * alone / 20:.3f} ms per 1,000 fine "
              f"steps with the graphs alone (20,000 steps, capture "
              f"included), {eager_ms:.3f} eager; "
              f"the replays bitwise equal to the eager loop over "
              f"{KS_SHORT_SAVE[3]} steps; card vs CPU over "
              f"{KS_SHORT_SAVE[-1]} steps (4 rows): max |diff| {e:.3e} "
              f"(max |u| {float(cpu.abs().max()):.3f}; the CPU "
              f"{cpu_s:.3f} s) ({on})")
        check(e <= TOL_DATAGEN, f"KS {key}: the card differs from the CPU "
              f"by {e:.3e} > {TOL_DATAGEN} over {KS_SHORT_SAVE[-1]} steps")
    ds = PDEDataset(str(npz), pde_for_experiment("KS", (250, 100)), "train")
    check(ds.u_super.shape == (32, 250, 100) and not ds.variables
          and bool(np.isfinite(ds.u_super).all()), "PDEDataset on KS")
    print(f"PDEDataset: KS train u_super {ds.u_super.shape}, dt {ds.dt}, "
          f"x [{ds.x[0]}, {ds.x[-1]}]")


def ks_cpu_reference(work_dir):
    """Phase 25: the CPU's run of KS_CPU_CODE in a process of its own
    (one thread), started before the card's datagen; returns (the process,
    the path of its output)."""
    import os

    out = str(Path(work_dir) / "ks_cpu.npy")
    proc = subprocess.Popen(
        [sys.executable, "-c", KS_CPU_CODE, out], cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out


def ks_full_horizon(proc, out, data_dir, on):
    """Phase 25: train sample 0 of the card's KS data at pde_250-100
    against the CPU's run over the whole horizon, 400,000 fine steps: the
    distance printed, held to no bound (L = 22 is chaotic; the short
    horizon holds the tolerance)."""
    import numpy as np

    from msmp_pde_torch.datagen import hdf5_io

    stdout, stderr = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"the CPU's KS run failed: {stderr[-2000:]}")
    cpu = np.load(out)[0]
    with hdf5_io.open_dataset(str(Path(data_dir) / "KS_KS.npz")) as f:
        card = f.array("train/pde_250-100")[0]
    d = np.abs(card - cpu).max(axis=-1)
    print(f"KS train sample 0 at pde_250-100, card vs CPU over the whole "
          f"horizon (t 2.0 to 100, 250 outputs): max |diff| {d.max():.3e} "
          f"(at output {int(d.argmax())}; {d[0]:.3e} at the first, "
          f"{d[124]:.3e} at output 124); max |u| {np.abs(cpu).max():.3f}; the "
          f"CPU took {float(stdout.split()[-1]):.1f} s for 400,000 steps "
          f"({on})")


def knn_phase(rand, T, dev, grid, experiments=("WE3", "WE1")):
    """Phases 25 and 26, the message-passing kernels on a k-NN graph (K = 3
    on ``grid``) with MSMP-PDE's, MSGMP-PDE's (164) and MP-PDE's weights,
    or their 2-D versions' on RPU: phase 25 on the wave equation's graph
    (WE's down-projected Chebyshev grid of 100, in-degrees 2 to 5), D = tw
    = 25, with WE3's V = 3 (t, bc_left, bc_right) and WE1's V = 1 (t);
    phase 26 on RPU's (the LCG grid of 100, cylindrical coordinates), D =
    2 tw = 50, V = 3 (t, a, b), where some nodes have in-degree 0 (no node
    lists them: empty inverse lists) and the largest is above K. The
    pair's forward at B in {1, 16, 48} at 128 and 164, its backward, both
    single-layer switch settings and the stash with the forced fallback,
    each against its plain version, two runs bitwise equal. Returns
    ({kernel: max error}, the timings' (kernel, operands) at the first
    experiment: batch 16, the stash at 48)."""
    import numpy as np
    import torch

    from msmp_pde_torch.ops import mp_pair

    errs, ops = {}, None
    for experiment in experiments:
        suffix = "2D" if experiment == "RPU" else ""
        phase = 26 if experiment == "RPU" else 25
        gated = weighted_trainer(experiment, "MSMP-PDE" + suffix, 50, dev,
                                 grid)
        glu = weighted_trainer(experiment, "MSGMP-PDE" + suffix, 51, dev,
                               grid)
        plain = weighted_trainer(experiment, "MP-PDE" + suffix, 52, dev,
                                 grid)
        spec = gated.spec
        nx, V, D = spec.nx, 1 + len(gated.eq_norms), gated.d * T
        deg = np.bincount(spec.idx.cpu().numpy().ravel(), minlength=nx)
        check(spec.idx.shape == (nx, 3) and deg.min() < 3 < deg.max(),
              f"{experiment}: not a k-NN graph of unequal in-degrees")
        if experiment == "RPU":
            check(deg.min() == 0, "RPU: no node of in-degree 0")
        print(f"phase {phase}: the message-passing kernels on "
              f"{experiment}'s k-NN graph, K = 3, in-degrees {deg.min()} to "
              f"{deg.max()} ({int((deg == 0).sum())} of in-degree 0), D = "
              f"{D}, V = {V}")
        w = lambda m: tuple(x.detach() for x in (m.gate_0.weights()
                                                 + m.gnn_0.weights()))
        fwd_args = {}
        with torch.no_grad():
            for H, W in ((128, w(gated.model)), (GLU_H, w(glu.model))):
                for B in (1, 16, 48):
                    args = (rand(B, nx, H), rand(B, nx, D),
                            spec.x.expand(B, nx)[..., None] / spec.L,
                            rand(B, nx, V, scale=.5), spec.idx, spec.mask,
                            W[:12], W[12:])
                    ok = mp_pair.fused_gated_pair(*args)
                    again = mp_pair.fused_gated_pair(*args)
                    op = mp_pair.fused_gated_pair_plain(*args)
                    torch.cuda.synchronize()
                    check(torch.equal(ok, again), f"mp_pair_fwd k-NN "
                          f"{experiment} B={B} H={H}: two runs differ")
                    e = (ok - op).abs().max().item()
                    errs["mp_pair_fwd"] = max(errs.get("mp_pair_fwd", 0.0), e)
                    print(f"mp_pair_fwd k-NN {experiment} V={V} B={B} H={H}: "
                          f"max |kernel - plain| = {e:.3e}; two runs bitwise "
                          "equal")
                    check(e <= TOL_PAIR, f"mp_pair_fwd k-NN {experiment} "
                          f"B={B} H={H} differs by {e:.3e} > {TOL_PAIR}")
                    fwd_args[(H, B)] = args
        e_bwd, bwd_args = check_pair_bwd(
            rand, gated.model, spec, D, 128, V,
            (glu.model.gate_0.weights(), glu.model.gnn_0.weights()),
            b164=(1, 16, 48))
        errs["mp_pair_bwd"] = max(errs.get("mp_pair_bwd", 0.0),
                                  *e_bwd.values())
        lf, lb = check_layer_kernels(rand, plain.model.gnn_0.weights(), spec,
                                     D, 128, V)
        errs["mp_layer_fwd"] = max(errs.get("mp_layer_fwd", 0.0), lf)
        errs["mp_layer_bwd"] = max(errs.get("mp_layer_bwd", 0.0), lb)
        st, fb, stash = check_pair_fallback(rand, gated.model, spec, D, 128,
                                            V)
        errs["mp_pair_fwd_stash"] = max(errs.get("mp_pair_fwd_stash", 0.0),
                                        st)
        errs["mp_pair_fallback"] = max(errs.get("mp_pair_fallback", 0.0), fb)
        if ops is None:
            W1 = tuple(x.detach() for x in plain.model.gnn_0.weights())
            layer = (*fwd_args[(128, 16)][:6], W1)
            ops = [("mp_pair_fwd", fwd_args[(128, 16)]),
                   ("mp_pair_bwd", bwd_args[128]),
                   ("mp_layer_fwd", layer),
                   ("mp_layer_bwd", (*layer, bwd_args[128][-1])),
                   ("mp_pair_fwd_stash", stash[0])]
    return errs, ops


def ks_eval_phase(data_dir, work_dir, ckpt, dev):
    """Phase 25, the eval CLI with --ks_spectrum on the KS checkpoint
    (``eval_phase``'s checks): its diagnostics, computed on the card,
    against the same functions on the CPU from its rollout (1e-9 of each
    array's scale); the plain path's rollout store: its truth equal to
    eval's, and so the truth's diagnostics on the card; the prediction's
    diagnostics' distance from the plain path's printed."""
    import types

    import numpy as np

    from msmp_pde_torch.training import eval as evaluate
    from msmp_pde_torch.training import metrics, train
    from msmp_pde_torch.training.setup import (
        pde_for_experiment,
        setup_experiment,
    )
    from msmp_pde_torch.utils.checkpoint import restore_params

    out = eval_phase(data_dir, work_dir, "KS", "MSMP-PDE", ckpt,
                     extra=("--ks_spectrum",))
    diag = out["ks_spectrum"]
    pde = pde_for_experiment("KS", (250, 100))
    cpu = evaluate.ks_spectrum(pde, out["preds"], out["trues"], 2.0, "cpu")
    check(set(diag) == set(cpu) and (Path(work_dir) / "plots"
                                     / "ks_spectrum.npz").is_file(),
          f"eval --ks_spectrum: {sorted(diag)}")
    rel = lambda a, b: float(np.abs(a - b).max()) / max(
        float(np.abs(b).max()), 1e-30)
    e = max(rel(diag[k], cpu[k]) for k in cpu)
    print(f"eval --ks_spectrum: {len(diag)} arrays, card vs CPU at most "
          f"{e:.3e} of an array's scale")
    check(e <= 1e-9, f"eval --ks_spectrum: card vs CPU {e:.3e}")
    args = train.build_parser().parse_args([
        "--experiment=KS", "--model=MSMP-PDE", "--device=cuda",
        f"--data_dir={data_dir}"])
    exp = setup_experiment(args, modes=("test",), data_dir=data_dir)
    tr = exp.trainer
    tr.model.load_state_dict(restore_params(ckpt), strict=True)
    u, _, var = train.device_arrays(exp.datasets["test"], dev)
    plain = types.SimpleNamespace(tw=tr.tw, d=tr.d,
                                  forward=plain_forward(tr))
    preds, trues = metrics.rollout_store(plain, u, var, TRAIN_BATCH,
                                         args.nr_gt_steps,
                                         exp.datasets["test"].nt)
    ref = evaluate.ks_spectrum(pde, preds, trues, 2.0, dev)
    check(np.array_equal(trues, out["trues"]) and all(
        np.array_equal(ref[k], diag[k]) for k in diag
        if k.endswith("_true")), "eval --ks_spectrum: the truth's "
          "diagnostics differ from the plain path's")
    print("eval --ks_spectrum, the prediction's diagnostics, kernel path vs "
          "plain path (float32 rollouts of 8 windows), relative to each "
          "array's scale: " + ", ".join(
              f"{k} {rel(diag[k], ref[k]):.3e}" for k in sorted(diag)
              if k.endswith("_pred")))


def interpolated_phase(data_dir, work_dir, on, dev):
    """Phase 26, RPU's interpolated route: the interpolate CLI on the card
    writes AD_RPU_I (every array within TOL_INTERP of the CPU's
    interpolation of the same file); ``fit --data_suffix _I`` of FNO2DP
    one epoch, which must train on the uniform grid (its radius stencil),
    resumed and served with ``--data_suffix _I``; eval_interpolated on the
    checkpoint prints the interp-back L2 and rel-L2, which must equal a
    direct reduction of ``interp_rollout_to_unstructured``'s output
    against the unstructured test set."""
    import numpy as np

    from msmp_pde_torch.data import interpolate
    from msmp_pde_torch.data.dataset import PDEDataset
    from msmp_pde_torch.datagen import hdf5_io
    from msmp_pde_torch.training import eval_interpolated, metrics
    from msmp_pde_torch.training.setup import pde_for_experiment

    t0 = time.perf_counter()
    npz, _ = interpolate.main(interpolate.build_parser().parse_args(
        [f"--data_dir={data_dir}", "--device=cuda"]))
    took = time.perf_counter() - t0
    cpu, _ = interpolate.interpolate_file(
        str(Path(data_dir) / "AD_RPU.npz"), str(Path(work_dir) / "cpu_I"),
        device="cpu")
    worst = 0.0
    with hdf5_io.open_dataset(npz) as a, hdf5_io.open_dataset(cpu) as b:
        check(sorted(a.names()) == sorted(b.names()), "the _I files' names")
        for name in a.names():
            worst = max(worst, float(np.abs(a.array(name)
                                            - b.array(name)).max()))
    print(f"interpolate CLI on the card: {npz} in {took:.3f} s, max |card - "
          f"CPU| = {worst:.3e} ({on})")
    check(worst <= TOL_INTERP, f"interpolate: card vs CPU {worst:.3e} > "
          f"{TOL_INTERP}")
    counts = fit_phase(data_dir, work_dir, on, "RPU", "FNO2DP", epochs=1,
                       suffix="_I")
    check(not any(counts.values()), f"FNO2DP _I fit: launches "
          f"{nonzero(counts)}")
    ckpt = str(Path(work_dir) / "models" / "FNO2DP_RPU.pt")
    args = eval_interpolated.build_parser().parse_args([
        "--experiment=RPU", "--model=FNO2DP", f"--model_to_test={ckpt}",
        f"--data_dir={data_dir}", "--batch_size=16", "--device=cuda"])
    t0 = time.perf_counter()
    with contextlib.chdir(work_dir):
        out = eval_interpolated.main(args)
    took = time.perf_counter() - t0
    ds_r = PDEDataset(str(Path(data_dir) / "AD_RPU.npz"),
                      pde_for_experiment("RPU", (250, 100)), "test")
    ds_u_pde = pde_for_experiment("RPU", (250, 100))
    ds_u_pde.unstructured_grid = False
    ds_u = PDEDataset(npz, ds_u_pde, "test")
    T = out["preds_interp_back"].shape[1]
    back = metrics.interp_rollout_to_unstructured(out["preds"][:, :T],
                                                  ds_u.x, ds_r.x, dev)
    trues = ds_r.u_super[:, 50:50 + T]
    l2 = float(np.sqrt(np.mean(np.sum((back - trues) ** 2, axis=2),
                               axis=(1, 2))).mean())
    m = float(np.sqrt(np.mean(np.sum(trues ** 2, axis=2),
                              axis=(1, 2))).mean())
    check(bool(np.isfinite(out["interp_L2"])) and (
        out["interp_L2"], out["interp_rel_L2"]) == (l2, l2 / m),
          f"compute_l2_norms_u {out['interp_L2']}, {out['interp_rel_L2']} "
          f"vs the direct reduction {l2}, {l2 / m}")
    print(f"eval_interpolated on FNO2DP's _I checkpoint: interp-back L2 "
          f"{out['interp_L2']:.6f}, rel-L2 {100 * out['interp_rel_L2']:.4f} "
          f"% on the unstructured grid (equal to the direct reduction of "
          f"interp_rollout_to_unstructured's output), uniform-grid rel-L2 "
          f"{100 * out['test_rel_L2']:.4f} %; figures "
          f"{'written' if out['figures'] else 'skipped (no matplotlib)'}; "
          f"{took:.3f} s ({on})")


# ---- phase 27: the bf16 precision modes -------------------------------------
BF16_MODES = ("bfloat16", "bfloat16s")
BF16_TAGS = {"bfloat16": "bf16", "bfloat16s": "bf16s"}
# Phase 27 holds a bf16 kernel three ways, each on the same inputs as its
# plain version in the same mode (P) and in float32 (P32), and as the plain
# version in the same mode run in float64 (X: the same rounding sites, its
# sums exact to float32's eye, a second sound implementation):
# * a forward output: ||kernel - P|| <= BF16_FWD_RATIO ||P - P32|| (the
#   Frobenius norm over the output), with ||P - P32|| > 0 (the cast is live);
# * a backward output: ||kernel - X|| <= BF16_WITNESS_RHO times the
#   spread of four sound versions (P, X and P summed in two other orders),
#   at least BF16_WITNESS_FLOOR ||P - P32|| (``witness_rhos``; a step's
#   gradient likewise, within BF16_STEP_RHO). Two sound versions whose float32 sums differ in
#   order round a value near a bf16 boundary differently, and the
#   recomputed forward carries each such flip down the backward, so that
#   P and X lie up to 0.7 of ||P - P32|| apart (the pair's dw_dx most). The
#   kernel is held to that spread, measured in the same run. Not the b4
#   gradients of a LayerLin (analytically zero, roundoff on every side;
#   their sites hold them);
# * every rounding site on the kernel's own operands (``bf16_sites``): the
#   kernel leaves its intermediates in its workspace (``workspace_layers``)
#   and the plain versions' site functions recompute each site from the
#   kernel's own inputs to it. A site's distance from that, over the
#   distance the site's rounding moves it, <= BF16_SITE_RATIO: only the
#   float32 order of that one site differs, no flip chain.
# Phase 27 also plants faults in the plain site functions (``BF16_FAULTS``)
# and fails unless each is caught by its site.
BF16_FWD_RATIO = 0.1
BF16_WITNESS_RHO = 2.0
BF16_WITNESS_FLOOR = 0.1
BF16_SITE_RATIO = 0.1
# A step's gradients pass six pairs of kernels, whose swish, sigmoid and
# norm sums (not varied among the plain versions) add flips: over five
# (weights, data) seeds of MSMP-PDE and MP-PDE, both modes, unrolled 0 and
# 1, the card read rho up to 2.242 (NVIDIA H100 80GB HBM3, 700.00 W);
# twice that. The float32 kernel path must read above it at unrolled 0.
BF16_STEP_RHO = 4.5
# a served window: ||served - P|| <= BF16_MODEL_RATIO ||P - P32||
BF16_MODEL_RATIO = 0.5


def flat(x):
    """The tensors of a kernel's output, nested tuples flattened."""
    import torch

    return [x] if torch.is_tensor(x) else [t for y in x for t in flat(y)]


def fro(a, b):
    return (a.double() - b.double()).norm().item()


def to64(x):
    """``x`` with every floating tensor (in nested tuples) in float64."""
    import torch

    if torch.is_tensor(x):
        return x.double() if x.is_floating_point() else x
    return type(x)(to64(y) for y in x)


def bf16_ratios(got, plain, plain32, b4=()):
    """||got - plain|| over ||plain - plain32|| per output, which must be
    above zero (the cast is live); the indices ``b4`` (a LayerLin's
    analytically zero b4 gradient) take the largest of their own distance
    and that of the w4 gradient one before them."""
    dist = [fro(p, q) for p, q in zip(plain, plain32)]
    out = []
    for k, (a, p) in enumerate(zip(got, plain)):
        d = max(dist[k], dist[k - 1]) if k in b4 else dist[k]
        check(d > 0, f"output {k}: the plain bf16 version equals float32")
        out.append(fro(a, p) / d)
    return out


def witness_rhos(got, sound, plain32, skip=()):
    """Per output, ||got - X|| over the spread of the sound versions
    ``sound`` = [P, X, Q...] (P the plain version, X the same in float64,
    each Q the same summed in another order: ``sound_versions``): the
    largest distance between two of them, or BF16_WITNESS_FLOOR of ||P -
    P32|| (``plain32``) where that is larger (where they agree but for a
    flip or two, another sound version may flip others, and at batch 1 one
    flip moves a weight gradient, a sum over 100 rows, ~0.1-0.3 of ||P -
    P32||); None at the indices ``skip``."""
    out = []
    for k, (a, f, *vs) in enumerate(zip(got, plain32, *sound)):
        d = max([fro(p, q) for i, p in enumerate(vs) for q in vs[i + 1:]]
                + [BF16_WITNESS_FLOOR * fro(vs[0], f)])
        out.append(None if k in skip else fro(a, vs[1]) / max(d, 1e-300))
    return out


def sound_versions(fn, extra=()):
    """[P, X, Q16, Q8, ...] of ``witness_rhos`` from ``fn(order)``, which
    runs the plain version in float32 with ``order`` None (P) or an int (Q:
    ``reordered(order)``), or in float64 with ``order`` "float64" (X); then
    ``fn(o)`` for each of ``extra``."""
    out = [fn(None), fn("float64")]
    for chunk in (16, 8):
        with reordered(chunk):
            out.append(fn(chunk))
    return out + [fn(o) for o in extra]


@contextlib.contextmanager
def lem_kernels_in_plain():
    """``reference_apply`` (the plain path) with the LEM kernels in place
    of ``lem_scan_plain``: a sound version of a step whose LEM sums in the
    kernel path's order."""
    import torch

    from msmp_pde_torch.ops import lem_scan

    keep = lem_scan.lem_scan_plain

    def kernels(gx, zx, y0, z0, wy, wzz, *, dt=1.0):
        if torch.is_grad_enabled():
            return lem_scan.LemScan.apply(gx, zx, y0, z0, wy, wzz, float(dt))
        return lem_scan.lem_scan_kernel(gx, zx, y0, z0, wy, wzz, dt=dt)

    lem_scan.lem_scan_plain = kernels
    try:
        yield
    finally:
        lem_scan.lem_scan_plain = keep


@contextlib.contextmanager
def reordered(chunk=16):
    """The plain versions' products and weight gradients (ops/mp_layer.py's
    ``_mm`` and ``_outer``) summed in chunks of ``chunk`` (of 4 ``chunk``
    rows) along their sum: the same rounding sites with float32 sums in
    another order, a second sound version."""
    from msmp_pde_torch.ops import mp_layer as ml

    keep = ml._mm, ml._outer

    def mm(a, b, r):
        a, b = r(a), r(b)
        return sum(a[..., s:s + chunk] @ b[s:s + chunk]
                   for s in range(0, b.shape[0], chunk))

    def outer(a, b, r):
        a, b, n = r(ml._rows(a)), r(ml._rows(b)), 4 * chunk
        return sum(a[s:s + n].T @ b[s:s + n] for s in range(0, a.shape[0], n))

    ml._mm, ml._outer = mm, outer
    try:
        yield
    finally:
        ml._mm, ml._outer = keep


def b4_indices(name):
    """The outputs of a backward that are a LayerLin's b4 gradient."""
    return (12, 24) if name == "mp_pair_bwd" else ()


def workspace_layers(name, ws, B, nx, H, K):
    """The intermediates kernel ``name`` leaves in its workspace ``ws``
    (csrc/mp_phases.cuh::layer_bufs), a dict per layer: the forward's si,
    sj, agg, z3, z4 [B, nx, H], m0 and z2 [B, nx, K, H]; a backward, which
    recomputes the forward, also dz4, dz3, dsi, dsj [B, nx, H] and dz2 [B,
    nx, K, H], and dm0 where z2 stood."""
    R = B * nx
    RH, EH = R * H, R * K * H
    bwd = name.endswith("_bwd")
    per = 5 * RH + 2 * EH + ((5 * RH + EH + 6 * H * H) if bwd else 0)
    node, edge = (B, nx, H), (B, nx, K, H)
    out = []
    for layer in range(2 if name.startswith("mp_pair") else 1):
        b = ws[layer * per:(layer + 1) * per]

        def at(off, shape, b=b):
            return b[off:off + math.prod(shape)].view(shape)

        d = {"si": at(0, node), "sj": at(RH, node), "agg": at(2 * RH, node),
             "z3": at(3 * RH, node), "z4": at(4 * RH, node),
             "m0": at(5 * RH, edge),
             ("dm0" if bwd else "z2"): at(5 * RH + EH, edge)}
        if bwd:
            o = 5 * RH + 2 * EH
            d.update(dz4=at(o, node), dz3=at(o + RH, node),
                     dsi=at(o + 2 * RH, node), dsj=at(o + 3 * RH, node),
                     dz2=at(o + 4 * RH, edge))
        out.append(d)
    return out


def bf16_sites(name, args, mode, out, layers, act=True):
    """The rounding sites of kernel ``name`` in ``mode`` (ops/mp_layer.py's
    table, mp_pallas.py:110-137 and :185-225), each recomputed by the plain
    versions' site functions from the kernel's own operands of that site
    (its inputs in the mode, the intermediates ``layers`` of
    ``workspace_layers``, its outputs ``out``): [(site, got, want,
    other)], ``other`` the same site without its rounding (for a bias
    gradient: the column sum of the rounded cotangent, the rule it must not
    take; for the storage mode's A: the same from the caller's float32
    operands). A backward's z2 (dm0 took its place) is recomputed from the
    kernel's m0, and the first term of dh (the residual's dxo, the pair's
    g (1 - tau)) from its z4. A single layer is GNN_Layer with ``act``
    (final activation and residual), else GNN_LayerLin."""
    import torch

    from msmp_pde_torch.models.common import swish
    from msmp_pde_torch.ops import mp_layer as ml

    m = ml.mode_of(mode)
    n_l = len(layers)
    raw, idx, mask = args[:4], args[4], args[5]
    h, u, px, v, *Ws = ml.plain_inputs(m, *raw, *args[6:6 + n_l])
    H = h.shape[-1]
    same = lambda x: x  # noqa: E731
    colsum = lambda x: x.reshape(-1, H).sum(0)  # noqa: E731
    sites = []

    def site(label, got, f):
        """``f(r, mode)`` recomputes the site, rounded as r and mode say."""
        sites.append((label, got, f(ml._rounding(m), m), f(same, 0)))

    def bias(label, got, dy):
        sites.append((label, got, colsum(dy), colsum(ml._bf16(dy))))

    for k, (L, W) in enumerate(zip(layers, Ws)):
        w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4 = W
        t = f"layer {k} " if n_l == 2 else ""
        x3 = torch.cat([h, L["agg"], v], -1)
        # the storage mode's operands of A are bf16 already: its rounding is
        # the cast, from the caller's float32 inputs
        site(t + "A s_i|s_j", torch.cat([L["si"], L["sj"]], -1),
             lambda r, mm, W=W, k=k: torch.cat(ml._sides(
                 *((h, u, px, v, W) if mm else (*raw, args[6 + k])), r), -1))
        site(t + "A2 m0", L["m0"],
             lambda r, _: ml._edge_in(L["si"], L["sj"], idx, r))
        if "z2" in L:
            site(t + "B z2", L["z2"],
                 lambda r, _: ml._mm(swish(L["m0"]), w2, r) + b2)
            site(t + "B2 agg", L["agg"],
                 lambda r, mm: ml._aggregate(L["z2"], mask, mm))
        site(t + "C z3", L["z3"], lambda r, _: ml._mm(x3, w3, r) + b3)
        site(t + "D z4", L["z4"],
             lambda r, _: ml._mm(swish(L["z3"]), w4, r) + b4)
    bwd = name.endswith("_bwd")
    g = args[6 + n_l] if bwd else None
    if m == 2:  # the storage mode's h where no product rounds it
        sites.extend(storage_h_sites(n_l, act, layers, flat(out)[0], g, h,
                                     raw[0]))
    if not bwd:
        return sites
    dh, *dws = out
    if n_l == 1 and act:  # GNN_Layer: the residual's dxo
        xh, rs = ml._instnorm(h + swish(layers[0]["z4"]))
        dh_in = ml._instnorm_bwd(g, xh, rs)
    elif n_l == 1:  # GNN_LayerLin
        dh_in = torch.zeros_like(g)
    else:  # the gated pair: the combine's g (1 - sigmoid(gn))
        dh_in = g * (1.0 - torch.sigmoid(ml._instnorm(layers[0]["z4"])[0]))
    dh_terms = []
    for k, (L, W, dw) in enumerate(zip(layers, Ws, dws)):
        w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4 = W
        t = f"layer {k} " if n_l == 2 else ""
        z2 = ml._mm(swish(L["m0"]), w2, ml._rounding(m)) + b2
        x3 = torch.cat([h, L["agg"], v], -1)
        dz4, dsi, dsj = L["dz4"], L["dsi"], L["dsj"]
        site(t + "B2 agg", L["agg"],
             lambda r, mm: ml._aggregate(z2, mask, mm))
        site(t + "F dz3", L["dz3"],
             lambda r, _: ml._mm(dz4, w4.T, r) * ml._dswish(L["z3"]))
        site(t + "G dz2", L["dz2"], lambda r, mm: ml._aggregate_bwd(
            ml._mm(L["dz3"], w3[H:2 * H].T, r), mask, z2, mm))
        site(t + "H dm0", L["dm0"],
             lambda r, _: ml._mm(L["dz2"], w2.T, r) * ml._dswish(L["m0"]))
        site(t + "I ds_i|ds_j", torch.cat([dsi, dsj], -1),
             lambda r, _: torch.cat(ml._gather_bwd(L["dm0"], idx, mask, r),
                                    -1))
        site(t + "J dw_hi|dw_hj", torch.cat([dw[0], dw[1]]),
             lambda r, _: torch.cat([ml._outer(h, dsi, r),
                                     ml._outer(h, dsj, r)]))
        site(t + "J dw_du|dw_dx", torch.cat([dw[2], dw[3]]),
             lambda r, _: torch.cat(ml._mix_grads(u, px, dsi, dsj, r)))
        site(t + "J dw_v", dw[4], lambda r, _: ml._outer(v, dsi, r))
        site(t + "H dw2", dw[6], lambda r, _: ml._outer(swish(L["m0"]),
                                                        L["dz2"], r))
        site(t + "G dw3", dw[8], lambda r, _: ml._outer(x3, L["dz3"], r))
        site(t + "F dw4", dw[10],
             lambda r, _: ml._outer(swish(L["z3"]), dz4, r))
        for label, got, dy in (("db1", dw[5], dsi), ("db2", dw[7], L["dz2"]),
                               ("db3", dw[9], L["dz3"]),
                               ("db4", dw[11], dz4)):
            bias(t + label, got, dy)
        dh_terms.append(lambda r, L=L, W=W: (
            ml._mm(L["dz3"], W[8][:H].T, r) + ml._mm(L["dsi"], W[0].T, r)
            + ml._mm(L["dsj"], W[1].T, r)))
    site("J dh", dh, lambda r, _: dh_in + sum(f(r) for f in dh_terms))
    return sites


def storage_h_sites(n_l, act, layers, out, g, h, h32):
    """The storage mode's terms in which h enters outside a product, which
    take the cast h (mp_pallas.py:527, :652, :327) where the float32 mode
    takes the caller's: a forward's out (GNN_Layer's residual, the pair's
    (1 - tau) h) or a backward's dz4 (GNN_Layer's norm of h + o, the
    pair's dgn = g (swish(ln) - h) tau (1 - tau)), from the kernel's z4:
    [(site, got, want (``h``), other (``h32``))]. GNN_LayerLin has none."""
    import torch

    from msmp_pde_torch.models.common import swish
    from msmp_pde_torch.ops import mp_layer as ml

    if n_l == 2:
        (gn, rs_g), (ln, _) = (ml._instnorm(L["z4"]) for L in layers)
        tau = torch.sigmoid(gn)
        if g is None:
            label, got = "E out", out
            f = lambda hh: (1.0 - tau) * hh + tau * swish(ln)  # noqa: E731
        else:
            label, got = "layer 0 E dz4", layers[0]["dz4"]
            f = lambda hh: ml._instnorm_bwd(  # noqa: E731
                g * (swish(ln) - hh) * tau * (1.0 - tau), gn, rs_g)
    elif act:
        z4 = layers[0]["z4"]
        if g is None:
            label, got = "E out", out
            f = lambda hh: ml._instnorm(hh + swish(z4))[0]  # noqa: E731
        else:
            label, got = "E dz4", layers[0]["dz4"]

            def f(hh):
                xh, rs = ml._instnorm(hh + swish(z4))
                return ml._instnorm_bwd(g, xh, rs) * ml._dswish(z4)
    else:
        return []
    return [(label, got, f(h), f(h32))]


def bf16_site_ratios(sites, live=True):
    """{site: ||got - want|| over ||want - other||}; with ``live`` each
    ``other`` must lie apart from ``want`` (the site rounds), else such a
    site reads infinity where got and want differ."""
    out = {}
    for label, got, want, other in sites:
        d, e = fro(want, other), fro(got, want)
        check(d > 0 or not live, f"site {label}: its rounding moves nothing")
        out[label] = e / d if d > 0 else (math.inf if e > 0 else 0.0)
    return out


# Faults planted in the plain site functions: each must fail its site on a
# sound kernel's workspace (run in phase 27 at E1's batch 16, bfloat16).
def _fault_j_split(u, px, ds_i, ds_j, r):
    from msmp_pde_torch.ops.mp_layer import _outer

    return (_outer(u, r(ds_i) - r(ds_j), r), _outer(px, r(ds_i) - r(ds_j), r))


def _fault_inverse_degree(mask, r, keep):
    return keep(mask, lambda x: x)


def _fault_dm0(dm0, idx, mask, r, keep):
    return keep(dm0, idx, mask, lambda x: x)


def _fault_edge_in(s_i, s_j, idx, r, keep):
    return r(keep(s_i, s_j, idx, lambda x: x))


BF16_FAULTS = {
    # fault: (site function, replacement, (kernel, site it must fail))
    "J: bf16(ds_i) - bf16(ds_j)": ("_mix_grads", _fault_j_split,
                                   ("mp_pair_bwd", "J dw_du|dw_dx")),
    "G: 1/deg unrounded": ("_a_entries", _fault_inverse_degree,
                           ("mp_layer_bwd", "G dz2")),
    "B2: 1/deg unrounded": ("_a_entries", _fault_inverse_degree,
                            ("mp_layer_fwd", "B2 agg")),
    "I: dm0 unrounded": ("_gather_bwd", _fault_dm0,
                         ("mp_pair_bwd", "I ds_i|ds_j")),
    "A2: bf16(s_i + s_j)": ("_edge_in", _fault_edge_in,
                            ("mp_layer_fwd", "A2 m0")),
}


@contextlib.contextmanager
def planted(fault):
    """The plain site function of ``fault`` (BF16_FAULTS) replaced."""
    import functools

    from msmp_pde_torch.ops import mp_layer as ml

    attr, fn, _ = BF16_FAULTS[fault]
    keep = getattr(ml, attr)
    if "keep" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn = functools.partial(fn, keep=keep)
    setattr(ml, attr, fn)
    try:
        yield
    finally:
        setattr(ml, attr, keep)


def kernel_workspace(name, args):
    """A float32 workspace for kernel ``name`` at ``args``' shape."""
    import torch

    from msmp_pde_torch.ops import mp_layer

    lib = name.replace("_stash", "")
    h, u, _, v, idx = args[:5]
    n = getattr(mp_layer._lib(lib), f"{lib}_scratch_floats")(
        *h.shape, u.shape[-1], v.shape[-1], idx.shape[1])
    return torch.empty(n, device=h.device, dtype=torch.float32)


def bf16_kernel_run(name, args, mode):
    """Kernel ``name`` in ``mode`` on ``args`` with its workspace kept:
    (outputs as returned, its intermediates by ``workspace_layers``)."""
    import torch

    kern = mp_calls(name, mode)[0]
    ws = kernel_workspace(name, args)
    with torch.no_grad():
        out = kern(*args, workspace=ws)
    B, nx, H = args[0].shape
    return out, workspace_layers(name, ws, B, nx, H, args[4].shape[1])


_KERNEL_FNS = (("mp_pair", "fused_gated_pair_kernel", "mp_pair_fwd"),
               ("mp_pair", "fused_gated_pair_bwd_kernel", "mp_pair_bwd"),
               ("mp_layer", "fused_mp_layer_kernel", "mp_layer_fwd"),
               ("mp_layer", "fused_mp_layer_bwd_kernel", "mp_layer_bwd"))


@contextlib.contextmanager
def kept_launches():
    """Every message-passing kernel launch in the block run with a
    workspace of its own, kept: yields a list that fills with (kernel
    name, operands as ``mp_calls`` takes them, mode, GNN_Layer or not,
    outputs, ``workspace_layers``)."""
    import importlib
    import inspect

    records, keep = [], []
    for mod_name, fn_name, name in _KERNEL_FNS:
        mod = importlib.import_module(f"msmp_pde_torch.ops.{mod_name}")
        fn = getattr(mod, fn_name)
        sig = inspect.signature(fn)
        n_ops = len([p for p in sig.parameters if p not in (
            "stash", "final_act", "residual", "mp_precision", "workspace")])

        def rec(*a, fn=fn, sig=sig, n_ops=n_ops, name=name, **k):
            b = sig.bind(*a, **k)
            b.apply_defaults()
            ops = tuple(b.args[:n_ops])
            kname = f"{name}_stash" if b.arguments.get("stash") else name
            ws = kernel_workspace(kname, ops)
            out = fn(*a, workspace=ws, **k)
            B, nx, H = ops[0].shape
            records.append((kname, ops, b.arguments["mp_precision"],
                            bool(b.arguments.get("final_act", False)), out,
                            workspace_layers(kname, ws, B, nx, H,
                                             ops[4].shape[1])))
            return out

        keep.append((mod, fn_name, fn))
        setattr(mod, fn_name, rec)
    try:
        yield records
    finally:
        for mod, fn_name, fn in keep:
            setattr(mod, fn_name, fn)


def launch_sites(records):
    """The largest site ratio over the launches ``records``
    (``kept_launches``) and where: (ratio, "kernel site")."""
    import torch

    worst = (0.0, "")
    with torch.no_grad():
        for name, ops, mode, act, out, layers in records:
            r = bf16_site_ratios(bf16_sites(name, ops, mode, out, layers,
                                            act))
            site = max(r, key=r.get)
            worst = max(worst, (r[site], f"{name} {site}"))
    return worst


def bf16_kernel_held(name, args, mode, out, layers):
    """Phase 27's hold of kernel ``name``'s run in ``mode`` (``out``,
    ``layers``): (passed, the largest output ratio (forward) or witness
    rho (backward), the largest site ratio and its site, max |kernel -
    P|, the text of the bounds)."""
    import torch

    plain, plain32 = mp_calls(name, mode)[1], mp_calls(name)[1]
    with torch.no_grad():
        k, p, p32 = flat(out), flat(plain(*args)), flat(plain32(*args))
        sites = bf16_site_ratios(bf16_sites(name, args, mode, out, layers))
        if name.endswith("_bwd"):
            b4 = b4_indices(name)
            sound = sound_versions(lambda o: p if o is None else flat(
                plain(*(to64(args) if o == "float64" else args))))
            bf16_ratios(k, p, p32, b4)  # the cast is live
            rs = [r for r in witness_rhos(k, sound, p32, b4)
                  if r is not None]
            held, lim = f"each rho <= {BF16_WITNESS_RHO}", BF16_WITNESS_RHO
        else:
            rs = bf16_ratios(k, p, p32)
            held, lim = f"each <= {BF16_FWD_RATIO}", BF16_FWD_RATIO
    worst = max(sites, key=sites.get)
    e = max((a - b).abs().max().item() for a, b in zip(k, p))
    ok = max(rs) <= lim and sites[worst] <= BF16_SITE_RATIO
    return ok, max(rs), sites[worst], worst, e, (
        f"{held}; sites each <= {BF16_SITE_RATIO}")


def bf16_kernel_check(label, name, args, mode):
    """One message-passing kernel in ``mode`` held by ``bf16_kernel_held``,
    two runs bitwise equal; returns (the largest ratio or rho, max |kernel
    - plain|)."""
    import torch

    out, layers = bf16_kernel_run(name, args, mode)
    with torch.no_grad():
        again = flat(mp_calls(name, mode)[0](*args))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(flat(out), again)),
          f"{label}: two runs differ")
    ok, r, s, site, e, held = bf16_kernel_held(name, args, mode, out, layers)
    what = "rho" if name.endswith("_bwd") else "||kernel - P|| / ||P - P32||"
    print(f"{label}: {what} {r:.4f} (the largest output), sites {s:.2e} "
          f"(the largest, {site}) ({held}), max |kernel - plain| {e:.3e}; "
          "two runs bitwise equal")
    check(ok, f"{label}: {what} {r:.4f}, site {site} {s:.3e}")
    return r, e


def bf16_fault_check(cases):
    """Each planted fault (BF16_FAULTS) in the plain site functions must
    fail its site on the sound kernel's run: ``cases`` {kernel name:
    operands}, in bfloat16."""
    runs = {}
    for fault, (_, _, (name, want)) in BF16_FAULTS.items():
        if name not in runs:
            runs[name] = bf16_kernel_run(name, cases[name], "bfloat16")
        out, layers = runs[name]
        with planted(fault):
            r = fault_site(bf16_site_ratios(bf16_sites(
                name, cases[name], "bfloat16", out, layers), False), want)
        print(f"planted fault {fault}: {name}'s site {want} reads {r:.3f} "
              f"(> {BF16_SITE_RATIO} fails it)")
        check(r > BF16_SITE_RATIO, f"planted fault {fault}: site {want} "
              f"{r:.3e} passed")


def fault_site(ratios, site):
    """The largest ratio of ``site`` over the layers (a pair's sites are
    "layer k <site>")."""
    return max(r for label, r in ratios.items()
               if label == site or label.endswith(" " + site))


def bf16_cases(rand, T, dev, spec, rp_spec, rpu_spec):
    """Phase 27's kernel shapes: (label, [(kernel name, operands)]): E1's
    (K 6, D 25, V 1, hidden 128) at batches 1, 16 and 48 (the stash at
    48), hidden 164, D = 50 with V = 3 on RP's grid, RPU's k-NN graph
    (nodes of in-degree 0)."""
    import torch

    from msmp_pde_torch.models.gnn import GNNLayer

    def weights(H, D, V, seed):
        return [tuple(w.detach() for w in GNNLayer(
            H, D, V, torch.Generator().manual_seed(seed + i)).to(
            dev).weights()) for i in range(3)]

    out = []
    for label, sp, B, H, D, V, seed in (
            ("E1", spec, 1, 128, T, 1, 70), ("E1", spec, 16, 128, T, 1, 70),
            ("E1", spec, 48, 128, T, 1, 70), ("hidden 164", spec, 16, 164, T,
                                              1, 73),
            ("D=50 V=3", rp_spec, 16, 128, 2 * T, 3, 76),
            ("RPU k-NN", rpu_spec, 16, 128, 2 * T, 3, 79)):
        nx = sp.nx
        wg, wl, w1 = weights(H, D, V, seed)
        px = sp.x.expand(B, nx)[..., None] / sp.L
        base = (rand(B, nx, H), rand(B, nx, D), px, rand(B, nx, V, scale=.5),
                sp.idx, sp.mask)
        g = rand(B, nx, H)
        ops = [("mp_pair_fwd", (*base, wg, wl)),
               ("mp_pair_bwd", (*base, wg, wl, g)),
               ("mp_layer_fwd", (*base, w1)),
               ("mp_layer_bwd", (*base, w1, g))]
        if B == 48:
            ops.append(("mp_pair_fwd_stash", (*base, wg, wl)))
        out.append((f"{label} B={B} H={H}", ops))
    return out


def pushed_forward(trainer, plain_precision, kernel=False):
    """A forward for ``Trainer.step_loss`` whose pushforward (no grad) runs
    the kernel path in the model's precision and whose step's forward runs
    the plain path (with ``kernel`` the kernel path) in
    ``plain_precision``."""
    import torch

    model = trainer.model
    plain = trainer.forward if kernel else plain_forward(trainer)

    def forward(window, steps, variables, lem_state=None):
        if not torch.is_grad_enabled():
            return trainer.forward(window, steps, variables,
                                   lem_state=lem_state)
        keep, model.mp_precision = model.mp_precision, plain_precision
        try:
            return plain(window, steps, variables, lem_state=lem_state)
        finally:
            model.mp_precision = keep

    return forward


def roundoff_grads(model):
    """The parameters whose gradient is analytically zero, roundoff on
    every path: a sigmoid-gated pair's LayerLin b4 (InstanceNorm removes
    it)."""
    return {n for n, _ in model.named_parameters()
            if model.gate == "sigmoid" and n.startswith(("gnn_", "gate_"))
            and n.endswith("TorchDense_2.bias")}


def bf16_step_check(trainer, u_all, name):
    """One step at batch 16, unrolled 0 and 1, in the model's bf16 mode,
    the plain steps from the kernel path's pushed window (``kernel_push``),
    held per gradient: each parameter's gradient on the kernel path within
    BF16_STEP_RHO of the spread of the plain path's step in the mode (P),
    the same summed in two other orders (``reordered``), in float64 (X,
    ``f64_step_grads``) and, with a LEM encoder, with the LEM's kernels
    (``lem_kernels_in_plain``), as the backward kernels are held, and at
    unrolled 0 the float32 kernel path's step beyond it on some gradient;
    every kernel launch of the kernel path's step in the mode, and its
    rounding sites on its own operands (``kept_launches``), each within
    BF16_SITE_RATIO; and P apart from the plain float32 step on every
    gradient (the cast is live). Also printed: over all parameters, each
    over its scale in P, the kernel path's and X's distance from the
    float32 step over P's."""
    import numpy as np
    import torch

    mode = trainer.model.mp_precision
    params = list(trainer.model.parameters())
    names = [n for n, _ in trainer.model.named_parameters()]
    skip = roundoff_grads(trainer.model)
    lem = trainer.model.encoder == "lem"
    rng = np.random.default_rng(27)
    for unrolled in (0, 1):
        idx, steps = step_batch(rng, len(u_all), unrolled, trainer.device)
        grads = {}
        with kept_launches() as launches:
            grads["kernel"] = torch.autograd.grad(trainer.step_loss(
                u_all, {}, idx, steps, unrolled), params)
        check(all(r[2] == mode for r in launches), f"{name}: a launch not "
              f"in {mode}")
        site, where = launch_sites(launches)
        n_launches = len(launches)
        del launches
        for path, fwd in (("plain", kernel_push(trainer)),
                          ("plain32", pushed_forward(trainer, "float32"))):
            loss = trainer.step_loss(u_all, {}, idx, steps, unrolled,
                                     forward=fwd)
            grads[path] = torch.autograd.grad(loss, params)
            check(bool(torch.isfinite(loss)), f"{name}: loss not finite")
        def plain_step(order):
            if order is None:
                return grads["plain"]
            if order == "float64":
                return f64_step_grads(trainer, u_all, {}, idx, steps,
                                      unrolled)[1]
            with (lem_kernels_in_plain() if order == "lem"
                  else contextlib.nullcontext()):
                return torch.autograd.grad(trainer.step_loss(
                    u_all, {}, idx, steps, unrolled,
                    forward=kernel_push(trainer)), params)

        sound = sound_versions(plain_step, ("lem",) if lem else ())
        for g in grads["kernel"]:
            check(bool(torch.isfinite(g).all()), f"{name}: grad not finite")
        P, P32 = grads["plain"], grads["plain32"]
        check(all(fro(a, b) > 0 for a, b in zip(P, P32)),
              f"{name}@{mode}: a plain bf16 gradient equals float32's")
        # the float32 kernel path's step from the same pushed window, which
        # the witness must tell apart
        k32 = torch.autograd.grad(trainer.step_loss(
            u_all, {}, idx, steps, unrolled,
            forward=pushed_forward(trainer, "float32", kernel=True)), params)
        sk = {k for k, n in enumerate(names) if n in skip}
        rhos = witness_rhos(grads["kernel"], sound, P32, sk)
        rho, worst = max((r, n) for r, n in zip(rhos, names) if r is not None)
        rho32 = max(r for r in witness_rhos(k32, sound, P32, sk)
                    if r is not None)
        scale = [max(p.abs().max().item(), 1e-30) for p in P]

        def apart(a):
            return math.sqrt(sum((fro(x, y) / c) ** 2
                                 for x, y, c in zip(a, P32, scale)))

        d = apart(P)
        print(f"{name}@{BF16_TAGS[mode]} train step B={TRAIN_BATCH} unrolled="
              f"{unrolled} (the plain steps from the kernel path's "
              f"pushforward): the largest rho {rho:.3f} ({worst}; each <= "
              f"{BF16_STEP_RHO}, {len(skip)} roundoff b4 gradients aside; "
              f"the float32 kernel path {rho32:.3f}); from the plain "
              f"float32 step, over all parameters, "
              f"the kernel path {apart(grads['kernel']) / d:.3f} and the "
              f"float64 plain path {apart(sound[1]) / d:.3f} of the "
              f"plain path's distance; the sites of its {n_launches} kernel "
              f"launches on their own operands: the largest {site:.2e} "
              f"({where}; each <= {BF16_SITE_RATIO})")
        check(rho <= BF16_STEP_RHO, f"{name}@{mode} step: rho {rho:.3f} "
              f"on {worst}")
        # at unrolled 1 the pushed window's flips can leave the sound
        # versions as far apart as bf16 from float32 (after MSMP-PDE's
        # bfloat16s fit phase 27 read 3.279 on an NVIDIA H100 80GB HBM3 at
        # 700 W): there the sites alone tell float32
        check(unrolled or rho32 > BF16_STEP_RHO, f"{name}@{mode} step: the "
              f"float32 kernel path reads rho {rho32:.3f}")
        check(site <= BF16_SITE_RATIO, f"{name}@{mode} step: site {where} "
              f"{site:.3e}")


def bf16_windows_held(trainer, window, steps, got, variables=None):
    """A served bf16 rollout ``got`` [B, S, nx, tw] held window by window:
    each within BF16_MODEL_RATIO of the plain path's bf16-to-float32
    distance from the plain bf16 forward of the same window
    (``plain_rollout`` following ``got``). Returns the largest ratio."""
    model = trainer.model
    mode = model.mp_precision
    plain = plain_rollout(trainer, window, steps, got.shape[1], follow=got,
                          variables=variables)
    model.mp_precision = "float32"
    try:
        plain32 = plain_rollout(trainer, window, steps, got.shape[1],
                                follow=got, variables=variables)
    finally:
        model.mp_precision = mode
    import numpy as np

    r = [float(np.linalg.norm(got[:, i] - plain[:, i])
               / np.linalg.norm(plain[:, i] - plain32[:, i]))
         for i in range(got.shape[1])]
    check(max(r) <= BF16_MODEL_RATIO, f"bf16 rollout windows "
          f"{['%.3f' % x for x in r]} > {BF16_MODEL_RATIO}")
    return max(r)


def bf16_serve(ckpt, mode, data_dir, data, name="MSMP-PDE"):
    """The HTTP server on ``ckpt`` with --mp_precision ``mode``: one
    request of 4 test samples at N_WINDOWS windows, equal to
    RolloutEngine.rollout, with the expected launches, held window by
    window against the plain path. Returns the launch counts."""
    import urllib.request

    import torch

    from msmp_pde_torch.data.graph import slice_windows
    from msmp_pde_torch.serving import serve

    sargs = serve.build_parser().parse_args([
        "--experiment=E1", f"--model={name}", f"--checkpoint={ckpt}",
        f"--data_dir={data_dir}", "--port=0", "--warmup_windows=0",
        "--device=cuda", f"--mp_precision={mode}"])
    srv, engine = serve.build_server(sargs)
    trainer = engine.trainer
    check(trainer.model.mp_precision == mode, "served precision")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    u_t = data["test"][0]
    steps = torch.full((4,), trainer.tw, dtype=torch.int64,
                       device=trainer.device)
    w = slice_windows(u_t[:4], steps, trainer.tw)[0]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        reset_counts()
        got = serve.request_rollout("127.0.0.1", port, w.cpu().numpy(),
                                    n_windows=N_WINDOWS)
        counts = launch_counts()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    check(health["mp_precision"] == mode, f"healthz {health}")
    check(counts == expected_launches(trainer.model, N_WINDOWS),
          f"served {mode}: launches {nonzero(counts)}")
    import numpy as np

    check(np.array_equal(got, engine.rollout(w.cpu().numpy(),
                                             n_windows=N_WINDOWS)),
          f"served {mode}: differs from engine.rollout")
    r = bf16_windows_held(trainer, w, steps, got)
    print(f"served {Path(ckpt).name} with --mp_precision={mode}: B=4, "
          f"{N_WINDOWS} windows, equal to engine.rollout, launches "
          f"{nonzero(counts)}; each window within {r:.3f} of the plain "
          f"path's bf16-to-float32 distance from its plain bf16 forward")
    rollout_replay_check(engine, f"{name} served in {mode}")
    return counts


def bf16_fit(data_dir, work_dir, on, mode):
    """The train CLI's fit of MSMP-PDE at full width one epoch on phase
    17's E1 data with --mp_precision ``mode``: every step's launches as the
    float32 fit's (``counted_fit``), a step held against the plain bf16
    step. Returns (the launch counts, the checkpoint)."""
    from msmp_pde_torch.training import train
    from msmp_pde_torch.training.setup import setup_experiment

    args = train.build_parser().parse_args([
        "--experiment=E1", "--model=MSMP-PDE", "--num_epochs=1",
        "--batch_size=16", "--unrolling=1", "--lr=1e-4",
        "--print_interval=100", "--device=cuda", f"--data_dir={data_dir}",
        f"--mp_precision={mode}"])
    exp = setup_experiment(args, data_dir=data_dir)
    model = exp.trainer.model
    check(model.mp_precision == mode and model.hidden == 128
          and model.layers == 6, f"fit: not MSMP-PDE at full width in {mode}")
    data = {m: train.device_arrays(exp.datasets[m], exp.trainer.device)
            for m in E1_SAMPLES}
    ckpt = str(Path(work_dir) / "models" / f"MSMP-PDE_E1_{mode}.pt")
    _, totals, _ = counted_fit(args, exp, data, ckpt, on)
    bf16_step_check(exp.trainer, data["train"][0][:TRAIN_BATCH], "MSMP-PDE")
    return totals, ckpt, data


def full_float32():
    """TF32 off for matmuls and cuDNN's convolutions, as every comparison
    of this script runs (its worker processes too)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- phase 28: the exported rollouts ----------------------------------
EXPORT_BUCKET = 16
EXPORT_REQUESTS = 30


def _export_inputs(trainer, B, seed):
    """A request of B windows, start steps of which some windows cross
    nt - tw, and the model's variables (U(0.1, 1))."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nx, dtw = trainer.spec.nx, trainer.d * trainer.tw
    nt = int(trainer.spec.t_grid.shape[0])
    window = rng.normal(size=(B, nx, dtw)).astype(np.float32)
    steps = rng.integers(trainer.tw, nt - trainer.tw + 1, size=B)
    var = {k: rng.uniform(0.1, 1.0, B).astype(np.float32)
           for k in trainer.eq_norms}
    return window, steps, var


def replay_worker(task_path):
    """``chip_smoke.py --replay <task.json>``, the fresh process of phase
    28: with the msmp ops registered (``msmp_pde_torch.ops``) and no model
    built, each artifact loaded with torch.export.load and run on its
    request, the launches counted around each run; writes the outputs and
    prints {name: launches} and the package's modules it imported."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import msmp_pde_torch.ops  # noqa: F401  (the msmp ops)

    full_float32()
    task = json.loads(Path(task_path).read_text())
    dev = torch.device("cuda")
    report = {}
    for name, art in task["artifacts"].items():
        prog = torch.export.load(art["path"]).module()
        z = np.load(art["inputs"])
        var = {k[4:]: torch.as_tensor(z[k], device=dev) for k in z.files
               if k.startswith("var/")}
        args = (torch.as_tensor(z["window"], device=dev),
                torch.as_tensor(z["steps"], device=dev), var)
        with torch.no_grad():
            prog(*args)  # a first run, uncounted
            torch.cuda.synchronize()
            reset_counts()
            out = prog(*args)
            torch.cuda.synchronize()
        report[name] = launch_counts()
        np.save(art["out"], out.cpu().numpy())
    mods = sorted(m for m in sys.modules if m.startswith("msmp_pde_torch"))
    print(json.dumps({"launches": report, "modules": mods}))


def export_phase(engines, work_dir, on):
    """Phase 28: each engine's rollout at bucket EXPORT_BUCKET and
    N_WINDOWS windows exported on the card (serving/export.py), replayed in
    a fresh process (``replay_worker``) bitwise equal to the engine's
    rollout of the same request with the same launches (the expected ones);
    the first engine's artifact also loaded here at buckets 1, 4 and 16 and
    its rollout p50 timed beside the engine's, in turns; the same model
    exported on the CPU and moved to the card at load time
    (``move_to_device_pass``), bitwise the card's rollout; the op layer's
    host time a launch."""
    import numpy as np
    import torch

    from msmp_pde_torch.serving.engine import (
        RolloutEngine,
        build_serving_trainer,
    )
    from msmp_pde_torch.serving.export import export_rollout, load_exported

    work = Path(work_dir)
    task = {"artifacts": {}}
    want = {}
    for i, (name, engine) in enumerate(engines.items()):
        tr = engine.trainer
        t0 = time.perf_counter()
        path = work / f"{name}.pt2"
        blob = export_rollout(engine, EXPORT_BUCKET, N_WINDOWS,
                              path=str(path))
        took = time.perf_counter() - t0
        window, steps, var = _export_inputs(tr, EXPORT_BUCKET, 80 + i)
        reset_counts()
        ref = engine.rollout(window, var or None, start_step=steps,
                             n_windows=N_WINDOWS)
        launches = launch_counts()
        expect = expected_launches(tr.model, N_WINDOWS)
        check(launches == expect, f"export {name}: the engine's launches "
              f"{nonzero(launches)}, expected {nonzero(expect)}")
        want[name] = (ref, launches)
        inputs = work / f"{name}.in.npz"
        np.savez(inputs, window=window, steps=steps,
                 **{f"var/{k}": v for k, v in var.items()})
        task["artifacts"][name] = {"path": str(path), "inputs": str(inputs),
                                   "out": str(work / f"{name}.out.npy")}
        print(f"export {name} @bucket {EXPORT_BUCKET} x {N_WINDOWS} "
              f"windows: {took:.3f} s, {len(blob)} bytes")
    (work / "replay.json").write_text(json.dumps(task))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--replay", str(work / "replay.json")],
                         capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"the replay process failed:\n"
          f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    report = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"replay process: {time.perf_counter() - t0:.3f} s; the "
          f"package's modules it imported: {', '.join(report['modules'])}")
    built = [m for m in report["modules"] if m.startswith((
        "msmp_pde_torch.models.gnn", "msmp_pde_torch.models.registry",
        "msmp_pde_torch.serving", "msmp_pde_torch.training",
        "msmp_pde_torch.utils"))]
    check(not built, f"the replay process imported {built}")
    for name, (ref, launches) in want.items():
        got = np.load(task["artifacts"][name]["out"])
        check(np.array_equal(got, ref), f"export {name}: the replay differs "
              f"from the engine by {np.abs(got - ref).max():.3e} (max "
              f"|engine| {np.abs(ref).max():.3e})")
        check(report["launches"][name] == launches,
              f"export {name}: replay launches "
              f"{nonzero(report['launches'][name])}, the engine's "
              f"{nonzero(launches)}")
        print(f"export {name}: the fresh process's replay is bitwise the "
              f"engine's rollout; launches {nonzero(launches)} each")

    # the exported program and the engine, timed in turns in this process
    name, engine = next(iter(engines.items()))
    tr = engine.trainer
    for B in BUCKETS:
        art = load_exported(str(work / f"{name}.pt2")
                            if B == EXPORT_BUCKET else
                            export_rollout(engine, B, N_WINDOWS))
        window, steps, var = _export_inputs(tr, B, 90 + B)
        ref = engine.rollout(window, var or None, start_step=steps,
                             n_windows=N_WINDOWS)
        check(np.array_equal(art(window, steps, var), ref),
              f"export {name} @bucket {B}: differs from the engine")
        lats = {"exported": [], "engine": []}
        runs = {"exported": lambda: art(window, steps, var),
                "engine": lambda: engine.rollout(
                    window, var or None, start_step=steps,
                    n_windows=N_WINDOWS)}
        for i in range(EXPORT_REQUESTS):
            for k in (("exported", "engine") if i % 2 == 0
                      else ("engine", "exported")):
                t0 = time.perf_counter()
                runs[k]()
                lats[k].append((time.perf_counter() - t0) * 1e3)
        p50 = {k: float(np.percentile(v, 50)) for k, v in lats.items()}
        print(f"{name} @bucket {B} x {N_WINDOWS} windows, {EXPORT_REQUESTS} "
              f"requests each in turns: exported p50 "
              f"{p50['exported']:.3f} ms, engine p50 {p50['engine']:.3f} ms "
              f"({on})")

    # exported on the CPU, moved to the card at load time
    cpu_tr = build_serving_trainer("E1", name, device="cpu")
    cpu_engine = RolloutEngine(cpu_tr, {k: v.detach().cpu() for k, v in
                                        tr.model.state_dict().items()},
                               batch_buckets=(EXPORT_BUCKET,))
    moved = load_exported(export_rollout(cpu_engine, EXPORT_BUCKET,
                                         N_WINDOWS), device="cuda")
    window, steps, var = _export_inputs(tr, EXPORT_BUCKET, 99)
    ref = engine.rollout(window, var or None, start_step=steps,
                         n_windows=N_WINDOWS)
    reset_counts()
    got = moved(window, steps, var)
    moved_launches = launch_counts()
    check(moved.device.type == "cuda" and moved_launches == expected_launches(
        tr.model, N_WINDOWS), f"the CPU export moved to the card launched "
        f"{nonzero(moved_launches)}")
    check(np.array_equal(got, ref), f"the CPU export moved to the card "
          f"differs from the engine by {np.abs(got - ref).max():.3e}")
    print(f"{name} exported on the CPU, moved to the card "
          f"(move_to_device_pass): bitwise the engine's rollout, launches "
          f"{nonzero(moved_launches)}")

    # the op layer's host time a launch: the pair's forward at bucket 1
    # through msmp::pair_fwd and through its kernel function
    from msmp_pde_torch.ops import mp_pair

    spec, model = tr.spec, tr.model
    g = torch.Generator(device="cuda").manual_seed(28)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa: E731
    Wg, Wl = model.gate_0.weights(), model.gnn_0.weights()
    args = (rand(1, spec.nx, Wg[0].shape[0]), rand(1, spec.nx, tr.tw),
            rand(1, spec.nx, 1), rand(1, spec.nx, Wg[4].shape[0]), spec.idx,
            spec.mask)
    with torch.no_grad():
        op_ms = host_ms(lambda: torch.ops.msmp.pair_fwd(
            *args, list(Wg), list(Wl), False, "float32"), reps=200)
        fn_ms = host_ms(lambda: mp_pair.fused_gated_pair_kernel(
            *args, Wg, Wl), reps=200)
    print(f"host time a launch of mp_pair_fwd @bucket 1: msmp::pair_fwd "
          f"{op_ms * 1e3:.1f} us, the kernel function "
          f"{fn_ms * 1e3:.1f} us ({on})")


# ---- phase 29: data parallelism ----------------------------------------
DDP_UNROLLED = (0, 1)
DDP_TIMED_STEPS = 20


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms in the block: phase 29 compares
    steps bit for bit, and cuDNN may otherwise pick a convolution backward
    that sums in another order from one call to the next."""
    import torch

    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            was


def _step_grads(trainer, u_all, batch, unrolled):
    """(loss, {name: gradient}) of one eager AdamW step of ``trainer`` at
    ``unrolled`` on ``batch`` = (idx, steps), from its current weights (the
    eager step, ``Trainer._one_step``, leaves its gradients on the
    parameters, where the graphed step keeps them in its graph; the card's
    tests hold the two steps bitwise alike)."""
    tx = trainer.make_optimizer(1e-4, 0.4, [1, 5, 10, 15], 250)
    loss = trainer._one_step(tx, unrolled)(u_all, {}, *batch)
    return loss.detach().clone(), {n: p.grad.detach().clone() for n, p in
                                   trainer.model.named_parameters()}


def _step_ms(trainer, u_all, batch):
    """Median CUDA-event time of a step at unrolled 0 over
    DDP_TIMED_STEPS steps, after three."""
    import torch

    step = trainer.train_step_fn(trainer.make_optimizer(
        1e-4, 0.4, [1, 5, 10, 15], 250), 0)
    for _ in range(3):
        step(u_all, {}, *batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(DDP_TIMED_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(u_all, {}, *batch)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ddp_worker(task_path):
    """``chip_smoke.py --ddp <task.json>``, a rank of phase 29 (torchrun's
    environment set by the caller): joins the group with the task's
    backend, runs one step a depth from the task's weights on its slice of
    the batch, and rank 0 saves the loss, the gradients, the launches of
    each step and the step's time."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from msmp_pde_torch.parallel import mesh
    from msmp_pde_torch.training.setup import build_trainer

    full_float32()
    task = json.loads(Path(task_path).read_text())
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    z = torch.load(task["inputs"], weights_only=True)
    u_all = z["u"].to(dev)
    state = torch.load(task["state"], weights_only=True)
    batch0 = (z["idx0"].to(dev), z["steps0"].to(dev))

    def trainer():
        tr = build_trainer("E1", "MSMP-PDE", device=dev)
        tr.model.load_state_dict(state, strict=True)
        return tr

    # the step without a group first, in this process, for its time
    plain_ms = _step_ms(trainer(), u_all, batch0)
    check(mesh.init_distributed("cuda", backend=task["backend"] or None),
          "no torchrun environment")
    res = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "plain_step_ms": plain_ms}
    for unrolled in DDP_UNROLLED:
        tr = trainer()
        batch = (z[f"idx{unrolled}"].to(dev), z[f"steps{unrolled}"].to(dev))
        reset_counts()
        with cudnn_deterministic():
            loss, grads = _step_grads(tr, u_all, batch, unrolled)
        res[f"launches{unrolled}"] = launch_counts()
        res[f"loss{unrolled}"] = loss.cpu()
        res[f"grads{unrolled}"] = {n: g.cpu() for n, g in grads.items()}
    res["step_ms"] = _step_ms(tr, u_all, batch0)
    # the gradients' all-reduce alone (sum_grads), by CUDA events
    params = list(tr.model.parameters())
    times = []
    for _ in range(DDP_TIMED_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        mesh.sum_grads(params)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    res["sum_grads_ms"] = statistics.median(times)
    if mesh.rank() == 0:
        torch.save(res, task["out"])
    dist.barrier()
    dist.destroy_process_group()


def _ranks(task, work, world):
    """Start ``world`` ranks of ``ddp_worker`` on the card (every rank
    LOCAL_RANK 0: one card) and wait for them; fails on any rank's
    error."""
    path = Path(work) / f"ddp_{task['backend'] or 'nccl'}_{world}.json"
    path.write_text(json.dumps(task))
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ddp", str(path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    backend = task["backend"] or "nccl"
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{world} rank(s), {backend}: rank {r} "
              f"failed ({p.returncode}):\n{o[-2000:]}\n{e[-4000:]}")


def ddp_phase(params, u_all, work_dir, on):
    """Phase 29: MSMP-PDE's step (batch 16, unrolled 0 and 1, weights from
    phase 4) in a process group against the step without one: at world
    size 1 under NCCL (the default backend on the card) its loss and every
    gradient bitwise equal; at two ranks on the one card with gloo (NCCL
    takes one rank a card), each rank its 8 samples, each gradient within
    ``scale_aware`` of the plain step's; each rank's launches those of a
    step; the step's time in each."""
    import numpy as np
    import torch

    from msmp_pde_torch.training.setup import build_trainer

    dev = torch.device("cuda")
    work = Path(work_dir)
    rng = np.random.default_rng(29)
    nt = u_all.shape[1]
    inputs = {"u": u_all.cpu()}
    for unrolled in DDP_UNROLLED:
        inputs[f"idx{unrolled}"] = torch.as_tensor(
            rng.permutation(u_all.shape[0])[:TRAIN_BATCH])
        inputs[f"steps{unrolled}"] = torch.as_tensor(rng.integers(
            25, nt - 25 * (unrolled + 1) + 1, size=TRAIN_BATCH))
    torch.save(inputs, work / "ddp_inputs.pt")
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               work / "ddp_state.pt")
    plain = {}
    for unrolled in DDP_UNROLLED:
        batch = (inputs[f"idx{unrolled}"].to(dev),
                 inputs[f"steps{unrolled}"].to(dev))
        runs = []
        for _ in range(2):  # the plain step, twice: it must repeat bitwise
            tr = build_trainer("E1", "MSMP-PDE", device=dev)
            tr.model.load_state_dict(params, strict=True)
            with cudnn_deterministic():
                runs.append(_step_grads(tr, u_all, batch, unrolled))
        (l1, g1), (l2, g2) = runs
        check(torch.equal(l1, l2) and all(torch.equal(g1[n], g2[n])
                                          for n in g1),
              f"the plain step at unrolled {unrolled} does not repeat "
              "bitwise")
        plain[unrolled] = runs[0]
    plain_ms = _step_ms(tr, u_all, (inputs["idx0"].to(dev),
                                    inputs["steps0"].to(dev)))
    model = tr.model
    for backend, world in ((None, 1), ("gloo", 2)):
        out = work / f"ddp_{backend or 'nccl'}_{world}.pt"
        t0 = time.perf_counter()
        _ranks({"backend": backend, "inputs": str(work / "ddp_inputs.pt"),
                "state": str(work / "ddp_state.pt"), "out": str(out)},
               work, world)
        took = time.perf_counter() - t0
        res = torch.load(out, weights_only=False)
        label = f"{res['backend']} at world size {res['world']}"
        check(res["world"] == world and res["backend"] == (backend or "nccl"),
              f"phase 29: ran {label}")
        for unrolled in DDP_UNROLLED:
            loss, grads = plain[unrolled]
            want = expected_launches(model, unrolled + 1, 1)
            check(res[f"launches{unrolled}"] == want,
                  f"{label}, unrolled {unrolled}: a rank's launches "
                  f"{nonzero(res[f'launches{unrolled}'])}, expected "
                  f"{nonzero(want)}")
            got_loss = res[f"loss{unrolled}"].to(dev)
            got = {n: g.to(dev) for n, g in res[f"grads{unrolled}"].items()}
            if world == 1:
                same = torch.equal(got_loss, loss) and all(
                    torch.equal(got[n], g) for n, g in grads.items())
                check(same, f"{label}, unrolled {unrolled}: the step is not "
                      "bitwise the step without a group")
                print(f"DDP {label}, unrolled {unrolled}: loss and every "
                      "gradient bitwise the plain step's; launches "
                      f"{nonzero(want)}")
                continue
            scales = grad_scales(grads.items())
            worst = 0.0
            for n, g in grads.items():
                ok, e = scale_aware(got[n], g, scales[n])
                check(ok, f"{label}, unrolled {unrolled}: {n} differs by "
                      f"{e:.3e} (scale {scales[n]:.3e})")
                worst = max(worst, e / max(scales[n], 1e-30))
            le = abs(got_loss.item() - loss.item()) / abs(loss.item())
            check(le <= TRAIN_LOSS_RTOL, f"{label}: loss off by {le:.3e}")
            print(f"DDP {label} on one card, unrolled {unrolled}: loss "
                  f"rel {le:.3e}, every gradient within scale_aware (largest "
                  f"|diff| / scale {worst:.3e}); launches a rank "
                  f"{nonzero(want)}")
        print(f"DDP {label}: {took:.3f} s of ranks; on rank 0 a step at "
              f"unrolled 0 {res['step_ms']:.4f} ms in the group, "
              f"{res['plain_step_ms']:.4f} ms before it joined (the "
              f"gradients' all-reduce alone {res['sum_grads_ms']:.4f} ms); "
              f"the plain step in this process {plain_ms:.4f} ms ({on})")


CUDA_CACHE_PROBE = """
import json, os
os.environ["CUDA_VISIBLE_DEVICES"] = ""
import torch
first = torch.cuda.is_available()
os.environ["CUDA_VISIBLE_DEVICES"] = "0"
again = torch.cuda.is_available()
try:
    torch.cuda.init()
    init = "ok"
except Exception as e:
    init = type(e).__name__
print(json.dumps([first, again, torch.cuda.device_count(), init]))
"""


def cuda_failure_cached():
    """Whether torch keeps a failed CUDA initialisation for the rest of
    its process (parallel/mesh.py::wait_for_backend probes in a child
    for that reason): a child that sees no card first, then the card."""
    run = subprocess.run([sys.executable, "-c", CUDA_CACHE_PROBE],
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, f"the CUDA probe failed: {run.stderr}")
    first, again, count, init = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"a process whose first CUDA call saw no card: is_available "
          f"{first}, then with the card visible {again}, device_count "
          f"{count}, torch.cuda.init {init}")
    return not again


def main():
    import tempfile

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "msmp_pde_torch" / "csrc").is_dir():
        fail(f"no msmp_pde_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from msmp_pde_torch.data.dataset import PDEDataset
    from msmp_pde_torch.data.graph import build_neighbors_radius
    from msmp_pde_torch.models.gnn import GNNLayer
    from msmp_pde_torch.ops import _build, lem_scan, mp_layer, mp_pair
    from msmp_pde_torch.serving.engine import (
        RolloutEngine,
        build_serving_trainer,
        grid_from_h5,
    )
    from msmp_pde_torch.tools.lem_times import lem_args
    from msmp_pde_torch.tools.model_times import (
        smooth,
        time_rollouts,
        time_train_steps,
        train_data,
    )
    from msmp_pde_torch.training.setup import (
        build_trainer,
        pde_for_experiment,
    )
    from msmp_pde_torch.training.train import device_arrays
    from msmp_pde_torch.utils.convert import params_from_flax

    full_float32()
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
        for kernel, lines in _build.resources(text):
            print(f"  {name}: {kernel}: {'; '.join(lines)}")
    for H in (128, 96, GLU_H):
        fwd = {N: lem_scan.lem_launch_shape(N, H) for N in (100, 1600)}
        bwd = lem_scan.lem_launch_shape(1600, H, backward=True)
        print(f"  LEM grid at hidden {H} (rows a cluster, CTAs a cluster, "
              f"CTAs, dynamic shared bytes a CTA): lem_fwd N=100 {fwd[100]}, "
              f"N=1600 {fwd[1600]}; lem_bwd N=1600 {bwd}")

    # 2. LEM-scan kernel vs plain ----------------------------------------
    T = 25
    err = {"lem_fwd": {}, "mp_pair_fwd": {}}  # {hidden: max error}
    for H, N in LEM_CASES:
        args = lem_args(rand, T, N, H)
        yk, zk = lem_scan.lem_scan(*args)
        again = lem_scan.lem_scan(*args)
        yp, zp = lem_scan.lem_scan_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(yk, again[0]) and torch.equal(zk, again[1]),
              f"lem_fwd N={N} H={H}: two runs differ")
        e = max((yk - yp).abs().max().item(), (zk - zp).abs().max().item())
        err["lem_fwd"][H] = max(err["lem_fwd"].get(H, 0.0), e)
        print(f"lem_fwd N={N} H={H} (y0, z0 non-zero): max |kernel - plain| "
              f"= {e:.3e}; two runs bitwise equal")
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
    nx = spec.nx
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
    # MSGMP-PDE's width, 164: 36 columns in a 64-column tile's last
    W164 = [GNNLayer(GLU_H, T, V, torch.Generator().manual_seed(5 + i)).to(
        dev).weights() for i in range(2)]
    cases += [(B, nx, GLU_H, V, spec.idx, spec.mask, *W164)
              for B in (1, 16, 48)]
    with torch.no_grad():
        for B, n, h, v, idx, mask, wg, wl in cases:
            px = (spec.x.expand(B, nx)[..., None] / spec.L if n == nx else
                  torch.linspace(0, 1, n, device=dev).expand(B, n)[..., None])
            args = (rand(B, n, h), rand(B, n, T), px,
                    rand(B, n, v, scale=.5), idx, mask, wg, wl)
            if n == nx:
                pair_args[B if h == H else (h, B)] = args
            ok = mp_pair.fused_gated_pair(*args)
            again = mp_pair.fused_gated_pair(*args)
            op = mp_pair.fused_gated_pair_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(ok, again),
                  f"mp_pair_fwd B={B} H={h}: two runs differ")
            e = (ok - op).abs().max().item()
            err["mp_pair_fwd"][h] = max(err["mp_pair_fwd"].get(h, 0.0), e)
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

    print(f"lem_fwd @bucket 16: kernel {lem_ms:.4f} ms, plain "
          f"{lem_plain_ms:.4f} ms (CUDA graph; {lem_eager_ms:.4f} ms eager), "
          f"bound {lem_bound:.4f} ms ({lem_by})")
    # bucket: (kernel, plain, eager, bound ms, bound by)
    pair_times = dict(zip((1, 16), mp_kernel_times(
        [("mp_pair_fwd", pair_args[B]) for B in (1, 16)])))
    pair_ms, pair_plain_ms, _, pair_bound, pair_by = pair_times[16]

    time_forwards(trainer, window, steps, "MSMP-PDE", {
        B: f"pairs 6 x {pair_times[B][0]:.4f}" + (
            f", LEM 1 x {lem_ms:.4f}" if B == 16 else "") for B in (1, 16)})
    time_rollouts(engine, "MSMP-PDE")

    # 7-10. training: kernels vs plain, one step, the main path ----------
    e_stash, e_lbwd, e_wgrad = check_lem_training_kernels(rand, T)
    train_tr = build_trainer("E1", "MSMP-PDE", device=dev)
    train_tr.model.load_state_dict(params, strict=True)
    e_pbwd, pbwd_all = check_pair_bwd(rand, train_tr.model, train_tr.spec, T,
                                      H, V, W164)
    pbwd_args = pbwd_all[H]
    u_all = torch.as_tensor(smooth(
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
    (pbwd_ms, pbwd_plain_ms, _, pbwd_bound, pbwd_by), = mp_kernel_times(
        [("mp_pair_bwd", pbwd_args)])
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
             lbwd_by)):
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
    u48 = torch.as_tensor(smooth(
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
    largs16 = (*pair_args[16][:6], W1)
    g16 = rand(16, nx, H)
    # one layer as the pair counts one (plus the residual's read of h and
    # final swish, elementwise); the backward as the pair's, for one layer;
    # the pair forward at batch 48 with gn and ln written too
    (lf1_ms, *_), (lf_ms, lf_plain_ms, _, lf_bound, lf_by), \
        (lb_ms, lb_plain_ms, _, lb_bound, lb_by), \
        (st_ms, st_plain_ms, _, st_bound, st_by) = mp_kernel_times([
            ("mp_layer_fwd", (*pair_args[1][:6], W1)),
            ("mp_layer_fwd", largs16), ("mp_layer_bwd", (*largs16, g16)),
            ("mp_pair_fwd_stash", args48)])
    with torch.no_grad():
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

    # 17-18. E1 datagen on the card, fit, resume and serve --------------
    # 19. the five models of this slice at full width
    # 20. the slice's main path: fit MSGMP-PDE on the E1 data; serve
    #     SaveMSMP-PDE and MSSMP-PDE across the data horizon
    on = card()
    # E1's data and phase 18's checkpoint stay for phase 24; each directory
    # is removed after it, or at exit where a phase fails
    e1_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    work = e1_dir.name
    data_dir = str(Path(work) / "data")
    t0 = time.perf_counter()
    datagen_phase(data_dir, on)
    t1 = time.perf_counter()
    fit_counts = fit_phase(data_dir, work, on)
    t2 = time.perf_counter()
    print(f"phases 17 and 18: {t1 - t0:.3f} s and {t2 - t1:.3f} s")
    print(f"fit main path launches: {nonzero(fit_counts)}")
    variant_trs = variants_phase(rand, u_all, T)
    t3 = time.perf_counter()
    msgmp_tr, msgmp_counts, msgmp_fit_s = msgmp_fit_phase(data_dir, work, on)
    variant_params = {n: {k: v.detach() for k, v in
                          tr.model.state_dict().items()}
                      for n, tr in variant_trs.items()}
    for name in ("SaveMSMP-PDE", "MSSMP-PDE"):
        eng = RolloutEngine(build_serving_trainer("E1", name, device=dev),
                            variant_params[name], batch_buckets=BUCKETS)
        serve_stateful(eng, name)
    print(f"phases 19 and 20: {t3 - t2:.3f} s and "
          f"{time.perf_counter() - t3:.3f} s")
    print(f"MSGMP-PDE fit main path launches (hidden {GLU_H}): "
          f"{nonzero(msgmp_counts)}")

    # 20 (timings). MSGMP-PDE's step and rollouts; the 164 kernels ------
    Hg, N = GLU_H, 16 * nx
    fused_limit(spec, Hg, T, V)
    gargs = lem_args(rand, T, N, Hg)
    glem = {}  # kernel: (ms, plain ms, eager ms)
    _, _, gys, gzs = lem_scan.lem_scan_plain(*gargs, stash=True)
    gbargs = (*gargs, gys, gzs, rand(N, Hg), rand(N, Hg))
    for name, kern, plain in (
            ("lem_fwd", lambda: lem_scan.lem_scan_kernel(*gargs),
             lambda: lem_scan.lem_scan_plain(*gargs)),
            ("lem_fwd_stash",
             lambda: lem_scan.lem_scan_kernel(*gargs, stash=True),
             lambda: lem_scan.lem_scan_plain(*gargs, stash=True)),
            ("lem_bwd", lambda: lem_scan.lem_scan_bwd_kernel(*gbargs),
             lambda: lem_scan.lem_scan_bwd_plain(*gbargs))):
        glem[name] = (timed(kern), timed_graph(plain), timed(plain))
    # every product of the hidden-164 route runs in 3xTF32 on the tensor
    # cores: the forward's two, the sweep's four and the weight gradients
    g_bytes = 4 * (T * N * 4 * Hg + 4 * N * Hg + 4 * Hg * Hg)
    g_bounds = {
        "lem_fwd": bound(g_bytes, 0, T * N * 8 * Hg * Hg),
        "lem_fwd_stash": bound(g_bytes + 4 * 2 * T * N * Hg, 0,
                               T * N * 8 * Hg * Hg),
        "lem_bwd": bound(4 * (10 * T * N * Hg + 6 * N * Hg + 8 * Hg * Hg),
                         0, 24 * T * N * Hg * Hg)}
    # lem_bwd's weight-gradient launch alone, lem_bwd_wgrad: dWy = sum_t
    # y_prev^T dg and dWzz = sum_t z_t^T da over the T N rows, 8 T N H^2
    # FLOP in 3xTF32; its card time from the profiler, its plain version
    # the plain backward's per-step products, torch.matmul of the stacked
    # rows its yardstick (never called by the port)
    gdgx, gdzx = lem_scan.lem_scan_bwd_plain(*gbargs)[:2]
    yprev = torch.cat([gargs[2][None], gys[:-1]])

    def wgrad_plain():
        dwy = torch.zeros_like(gargs[4])
        dwzz = torch.zeros_like(gargs[5])
        for t in range(T):
            dwzz = dwzz + gzs[t].T @ gdzx[t]
            dwy = dwy + yprev[t].T @ gdgx[t]
        return dwy, dwzz

    wgrad_ops = (yprev.reshape(T * N, Hg).T.contiguous(),
                 gdgx.reshape(T * N, 3 * Hg),
                 gzs.reshape(T * N, Hg).T.contiguous(),
                 gdzx.reshape(T * N, Hg))
    wgrad_lib_ms = timed(lambda: (torch.matmul(*wgrad_ops[:2]),
                                  torch.matmul(*wgrad_ops[2:])))
    wgrad_plain_ms = timed_graph(wgrad_plain)
    bwd_launch_ms = lem_card_times164(gargs, gbargs)
    check("lem_bwd_wgrad" in bwd_launch_ms,
          "torch.profiler shows no card time of lem_bwd_wgrad")
    wgrad_ms = bwd_launch_ms["lem_bwd_wgrad"]
    wgrad_bound = bound(4 * (6 * T * N * Hg + 4 * Hg * Hg), 0,
                        8 * T * N * Hg * Hg)
    print(f"lem_bwd_wgrad @hidden {Hg}, N={N}: kernel {wgrad_ms:.4f} ms "
          f"(torch.profiler), plain {wgrad_plain_ms:.4f} ms (CUDA graph), "
          f"torch.matmul {wgrad_lib_ms:.4f} ms (two calls; a yardstick, "
          f"not the port's), bound {wgrad_bound[0]:.4f} ms "
          f"({wgrad_bound[1]}); one launch a lem_bwd call")
    g_times = {name: (*t, *g_bounds[name]) for name, t in glem.items()}
    for name, (ms, pms, ems, bms, by) in g_times.items():
        print(f"{name} @hidden {Hg}, N={N}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms (CUDA graph; {ems:.4f} ms eager), bound "
              f"{bms:.4f} ms ({by})")
    g_times.update(zip(("mp_pair_fwd", "mp_pair_bwd"), mp_kernel_times(
        [("mp_pair_fwd", pair_args[(Hg, 16)]),
         ("mp_pair_bwd", pbwd_all[Hg])])))
    print("hidden-164 launches in the MSGMP-PDE fit: " + ", ".join(
        f"{name} {msgmp_counts[name]}" for name in g_times))
    time_train_steps(msgmp_tr, u_all, "MSGMP-PDE")
    print(f"MSGMP-PDE fit epoch (500 steps and its metrics): "
          f"{msgmp_fit_s:.3f} s")
    msgmp_engine = RolloutEngine(
        build_serving_trainer("E1", "MSGMP-PDE", device=dev),
        variant_params["MSGMP-PDE"], batch_buckets=BUCKETS)
    time_rollouts(msgmp_engine, "MSGMP-PDE")

    # 21. the message-passing kernels at D = 50, V = 3 -------------------
    t21 = time.perf_counter()
    d50_err, d50_ops = d50_phase(rand, T, dev)
    t22 = time.perf_counter()

    # 22. the ten 2-D models at full width on RP's grid ------------------
    u2, var2 = train_data(build_trainer("RP", "MSMP-PDE2D", device=dev),
                          TRAIN_BATCH, seed=3)
    trs2d = variants_phase(rand, u2, T, MODELS_2D, "RP", var2, seed=40,
                           f64_models=("MSG2-PDE2D",))
    f64_seed_readings(u2, var2, "MSG2-PDE2D", (60, 61, 62))
    t23 = time.perf_counter()

    # 23. RP on the card, fit and serve; the 2-D main paths' launches ----
    rp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_rp_")
    rp_work = rp_dir.name
    rp_data = str(Path(rp_work) / "data")
    rp_datagen_phase(rp_data, on)
    fit2d_counts = fit_phase(rp_data, rp_work, on, "RP", "MSMP-PDE2D",
                             epochs=1, per_window=True)
    print(f"MSMP-PDE2D fit main path launches: {nonzero(fit2d_counts)}")
    msg2_counts, msg2_epoch_s = train_main_path(
        trs2d["MSG2-PDE2D"], u2, "MSG2-PDE2D", var2)
    print(f"MSG2-PDE2D train_epoch (250 steps): {msg2_epoch_s:.3f} s")
    u48, var48 = train_data(trs2d["MSMP-PDE2D"], 48, seed=5)
    fb2d_counts = fallback_step(trs2d["MSMP-PDE2D"], u48, "MSMP-PDE2D",
                                var48)
    del u48
    engines2d = {
        name: RolloutEngine(build_serving_trainer("RP", name, device=dev),
                            {k: v.detach() for k, v in
                             trs2d[name].model.state_dict().items()},
                            batch_buckets=BUCKETS)
        for name in ("MSMP-PDE2D", "MSG2-PDE2D", "GLEMGated2D")}
    served2d = {name: serve_path(engines2d[name], name, "RP")
                for name in ("MSG2-PDE2D", "GLEMGated2D")}
    d50_t = dict(zip((name for name, _ in d50_ops),
                     mp_kernel_times(d50_ops)))
    time_rollouts(engines2d["MSMP-PDE2D"], "MSMP-PDE2D")
    time_train_steps(trs2d["MSMP-PDE2D"], u2, "MSMP-PDE2D", var2)
    print(f"MSMP-PDE2D and MSMP-PDE timings on {on}")
    t24 = time.perf_counter()
    print(f"phases 21, 22 and 23: {t22 - t21:.3f} s, {t23 - t22:.3f} s and "
          f"{t24 - t23:.3f} s")

    # 24. the grid models: full width against float64, fit, resume, serve,
    #     eval (also of phase 18's MSMP-PDE) and cv --------------------------
    grid_models_phase(rand, dev, on)
    for experiment, name, ddir, wdir in (("E1", "BaseCNN", data_dir, work),
                                         ("RP", "FNO2DP", rp_data, rp_work)):
        counts = fit_phase(ddir, wdir, on, experiment, name, epochs=1)
        check(not any(counts.values()), f"{name} fit: launches "
              f"{nonzero(counts)}")
    eval_phase(rp_data, rp_work, "RP", "FNO2DP",
               str(Path(rp_work) / "models" / "FNO2DP_RP.pt"))
    eval_phase(data_dir, work, "E1", "MSMP-PDE",
               str(Path(work) / "models" / "MSMP-PDE_E1.pt"))
    cv_phase(data_dir, work)
    rp_dir.cleanup()
    print(f"phase 24: {time.perf_counter() - t24:.3f} s")

    # 25. the wave equation, KF and KS: datagen on the card, the kernels
    #     on the k-NN graph, fit, serve and eval --ks_spectrum ------------
    t25 = time.perf_counter()
    fam_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_fam_")
    fam_work = fam_dir.name
    fam_data = str(Path(fam_work) / "data")
    ks_proc, ks_out = ks_cpu_reference(fam_work)
    try:
        fam_s = {e: family_datagen_phase(fam_data, on, e) for e in FAMILIES}
        t_ks = time.perf_counter()
        ks_datagen_phase(fam_data, on)
        t_knn = time.perf_counter()
        we3_npz = str(Path(fam_data) / "WE_WE3.npz")
        we_pde = pde_for_experiment("WE3", (250, 100))
        we_grid = grid_from_h5(we3_npz, we_pde, "test", (250, 100),
                               (250, 200))
        knn_err, knn_ops = knn_phase(rand, T, dev, we_grid)
        t_fit = time.perf_counter()
        knn_fit = fit_phase(fam_data, fam_work, on, "WE3", "MSMP-PDE",
                            epochs=1, per_window=True)
        print(f"MSMP-PDE WE3 fit main path launches: {nonzero(knn_fit)}")
        fit_phase(fam_data, fam_work, on, "KS", "MSMP-PDE", epochs=1,
                  per_window=True, extra=("--short_horizon_windows=2",))
        ks_eval_phase(fam_data, fam_work,
                      str(Path(fam_work) / "models" / "MSMP-PDE_KS.pt"), dev)
        u_we, _, var_we = device_arrays(PDEDataset(we3_npz, we_pde, "train"),
                                        dev)
        mp_we = weighted_trainer("WE3", "MP-PDE", 53, dev, we_grid)
        knn_layer, we_epoch_s = train_main_path(
            mp_we, u_we[:TRAIN_BATCH], "MP-PDE (WE3)",
            {k: v[:TRAIN_BATCH] for k, v in var_we.items()})
        msmp_we = weighted_trainer("WE3", "MSMP-PDE", 54, dev, we_grid)
        u48, var48 = train_data(msmp_we, 48, seed=8)
        knn_fb = fallback_step(msmp_we, u48, "MSMP-PDE (WE3)", var48)
        del u48
        knn_t = dict(zip((name for name, _ in knn_ops),
                         mp_kernel_times(knn_ops)))
        time_train_steps(msmp_we, u_we, "MSMP-PDE (WE3)", var_we)
        ks_full_horizon(ks_proc, ks_out, fam_data, on)
    finally:
        if ks_proc.poll() is None:
            ks_proc.kill()
            ks_proc.wait()
    fam_dir.cleanup()
    print(f"phase 25: {time.perf_counter() - t25:.3f} s (WE1-3 and KF "
          f"datagen {t_ks - t25:.3f} s, KS datagen and its checks "
          f"{t_knn - t_ks:.3f} s, the k-NN kernels {t_fit - t_knn:.3f} s, "
          f"the fits, eval, train_epoch, timings and the CPU's KS "
          f"{time.perf_counter() - t_fit:.3f} s) ({on})")

    # 26. RPU: datagen on the card, the kernels on its k-NN graph (nodes of
    #     in-degree 0), fit and serve MSMP-PDE2D and FNO2DPU, the
    #     interpolated route (interpolate, fit --data_suffix _I,
    #     eval_interpolated) --------------------------------------------
    t26 = time.perf_counter()
    rpu_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_rpu_")
    rpu_work = rpu_dir.name
    rpu_data = str(Path(rpu_work) / "data")
    rp_datagen_phase(rpu_data, on, "RPU")
    rpu_npz = str(Path(rpu_data) / "AD_RPU.npz")
    rpu_pde = pde_for_experiment("RPU", (250, 100))
    rpu_grid = grid_from_h5(rpu_npz, rpu_pde, "test", (250, 100), (250, 200))
    t_rknn = time.perf_counter()
    rpu_err, rpu_ops = knn_phase(rand, T, dev, rpu_grid, ("RPU",))
    t_rfit = time.perf_counter()
    rpu_fit = fit_phase(rpu_data, rpu_work, on, "RPU", "MSMP-PDE2D",
                        epochs=1, per_window=True)
    print(f"MSMP-PDE2D RPU fit main path launches: {nonzero(rpu_fit)}")
    u_rpu, _, var_rpu = device_arrays(PDEDataset(rpu_npz, rpu_pde, "train"),
                                      dev)
    mp_rpu = weighted_trainer("RPU", "MP-PDE2D", 55, dev, rpu_grid)
    rpu_layer, rpu_epoch_s = train_main_path(
        mp_rpu, u_rpu[:TRAIN_BATCH], "MP-PDE2D (RPU)",
        {k: v[:TRAIN_BATCH] for k, v in var_rpu.items()})
    msmp_rpu = weighted_trainer("RPU", "MSMP-PDE2D", 56, dev, rpu_grid)
    u48, var48 = train_data(msmp_rpu, 48, seed=9)
    rpu_fb = fallback_step(msmp_rpu, u48, "MSMP-PDE2D (RPU)", var48)
    del u48
    rpu_t = dict(zip((name for name, _ in rpu_ops),
                     mp_kernel_times(rpu_ops)))
    t_rgrid = time.perf_counter()
    grid_models_phase(rand, dev, on, ("FNO2DPU",), "RPU", rpu_grid)
    fno_counts = fit_phase(rpu_data, rpu_work, on, "RPU", "FNO2DPU",
                           epochs=1)
    check(not any(fno_counts.values()), f"FNO2DPU fit: launches "
          f"{nonzero(fno_counts)}")
    t_interp = time.perf_counter()
    interpolated_phase(rpu_data, rpu_work, on, dev)
    rpu_dir.cleanup()
    t_end = time.perf_counter()
    print(f"phase 26: {t_end - t26:.3f} s (RPU datagen {t_rknn - t26:.3f} "
          f"s, the k-NN kernels {t_rfit - t_rknn:.3f} s, MSMP-PDE2D's fit, "
          f"MP-PDE2D's train_epoch, the fallback step and the kernels' "
          f"times {t_rgrid - t_rfit:.3f} s, FNO2DPU {t_interp - t_rgrid:.3f} "
          f"s, the interpolated route {t_end - t_interp:.3f} s) ({on})")

    # 27. the bf16 precision modes: the four message-passing kernels in
    #     both modes at the slice's shapes, fit of MSMP-PDE and its server,
    #     MP-PDE's train_epoch, the stash's fallback step -------------------
    t27 = time.perf_counter()
    rp_spec = build_trainer("RP", "MSMP-PDE2D", device=dev).spec
    rpu_spec = build_trainer("RPU", "MSMP-PDE2D", device=dev,
                             grid=rpu_grid).spec
    indeg = torch.bincount(rpu_spec.idx.reshape(-1).long(),
                           minlength=rpu_spec.nx)
    check(int(indeg.min()) == 0, "RPU's graph has no node of in-degree 0")
    bf16_err = {}  # (kernel, mode): (largest ratio, max |kernel - plain|)
    cases27 = bf16_cases(rand, T, dev, spec, rp_spec, rpu_spec)
    for mode in BF16_MODES:
        for label, ops in cases27:
            for name, args in ops:
                r = bf16_kernel_check(f"{name}@{BF16_TAGS[mode]} {label}",
                                      name, args, mode)
                old = bf16_err.get((name, mode), (0.0, 0.0))
                bf16_err[name, mode] = (max(old[0], r[0]), max(old[1], r[1]))
    # the holds' teeth: faults planted in the plain site functions
    bf16_fault_check(dict(cases27[1][1]))
    # each kernel timed in the three modes in this call, at E1's batch 16
    # (the stash at 48)
    at16 = dict(cases27[1][1])
    at16["mp_pair_fwd_stash"] = dict(cases27[2][1])["mp_pair_fwd_stash"]
    modes3 = ("float32",) + BF16_MODES
    t27k = dict(zip([(n, m) for n in at16 for m in modes3], mp_kernel_times(
        [(n, args, m) for n, args in at16.items() for m in modes3])))
    grid = mp_layer.grid_blocks
    print("cooperative grid (blocks) in float32 / bfloat16 / bfloat16s: "
          + ", ".join(f"{n} " + " / ".join(
              str(grid(n, n.startswith("mp_layer"), m)) for m in modes3)
              for n in ("mp_pair_fwd", "mp_pair_bwd", "mp_layer_fwd",
                        "mp_layer_bwd")))
    fit27, ckpt27 = {}, {}
    for mode in BF16_MODES:
        fit27[mode], ckpt27[mode], e1data = bf16_fit(data_dir, work, on,
                                                     mode)
        print(f"MSMP-PDE fit@{BF16_TAGS[mode]} main path launches: "
              f"{nonzero(fit27[mode])} (phase 18's float32 fit of two "
              f"epochs: {nonzero(fit_counts)})")
    # the bf16 fit's checkpoint served in bfloat16s, phase 18's float32
    # checkpoint served in bfloat16
    bf16_serve(ckpt27["bfloat16"], "bfloat16s", data_dir, e1data)
    bf16_serve(str(Path(work) / "models" / "MSMP-PDE_E1.pt"), "bfloat16",
               data_dir, e1data)
    u48 = torch.as_tensor(smooth(
        48, spec.t_grid.cpu().numpy(), spec.x.cpu().numpy(), spec.L, seed=1),
        device=dev)
    mp27, stash27 = {}, {}
    for mode in BF16_MODES:
        tag = BF16_TAGS[mode]
        tr = build_trainer("E1", "MP-PDE", device=dev, mp_precision=mode)
        tr.model.load_state_dict(mp_params, strict=True)
        bf16_step_check(tr, u_all, "MP-PDE")
        mp27[mode], _ = train_main_path(tr, u_all, f"MP-PDE@{tag}")
        trm = build_trainer("E1", "MSMP-PDE", device=dev, mp_precision=mode)
        trm.model.load_state_dict(params, strict=True)
        stash27[mode] = fallback_step(trm, u48, f"MSMP-PDE@{tag}")
    del u48
    e1_dir.cleanup()
    print(f"phase 27: {time.perf_counter() - t27:.3f} s ({on})")

    # 28. the exported rollouts: MSMP-PDE, MP-PDE, MSGMP-PDE at hidden 164
    #     and MSMP-PDE in bfloat16s, replayed in a fresh process; timed ---
    t28 = time.perf_counter()
    x_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_export_")
    bf16_engine = RolloutEngine(
        build_serving_trainer("E1", "MSMP-PDE", device=dev,
                              mp_precision="bfloat16s"),
        params, batch_buckets=BUCKETS)
    export_phase(
        {"MSMP-PDE": engine, "MP-PDE": mp_engine,
         f"MSGMP-PDE@hidden{GLU_H}": msgmp_engine,
         "MSMP-PDE@bf16s": bf16_engine}, x_dir.name, on)
    t29 = time.perf_counter()
    print(f"phase 28: {t29 - t28:.3f} s ({on})")

    # 29. data parallelism: MSMP-PDE's step at world size 1 under NCCL and
    #     at two gloo ranks on the card, against the plain step -----------
    cuda_failure_cached()
    ddp_phase(params, u_all, x_dir.name, on)
    x_dir.cleanup()
    print(f"phase 29: {time.perf_counter() - t29:.3f} s ({on})")

    kernels = [
        {"name": "lem_fwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/lem_fwd.cu",
         "replaces": REPLACES["lem_fwd"],
         "launches": main_lem, "max_abs_err": by_route(err["lem_fwd"])[0],
         "ms": lem_ms, "plain_ms": lem_plain_ms, "bound_ms": lem_bound,
         "bound_by": lem_by, "library_ms": None},
        {"name": "mp_pair_fwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_pair_fwd.cu",
         "replaces": REPLACES["mp_pair_fwd"],
         "launches": main_pair,
         "max_abs_err": by_route(err["mp_pair_fwd"])[0],
         "ms": pair_ms, "plain_ms": pair_plain_ms, "bound_ms": pair_bound,
         "bound_by": pair_by, "library_ms": None},
        {"name": "lem_fwd_stash", "route": "cuda",
         "source": "msmp_pde_torch/csrc/lem_fwd.cu",
         "replaces": REPLACES["lem_fwd_stash"],
         "launches": train_launches["lem_fwd_stash"],
         "max_abs_err": by_route(e_stash)[0],
         "ms": stash_ms, "plain_ms": stash_plain_ms, "bound_ms": stash_bound,
         "bound_by": stash_by, "library_ms": None},
        {"name": "lem_bwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/lem_bwd.cu",
         "replaces": REPLACES["lem_bwd"],
         "launches": train_launches["lem_bwd"],
         "max_abs_err": by_route(e_lbwd)[0],
         "ms": lbwd_ms, "plain_ms": lbwd_plain_ms, "bound_ms": lbwd_bound,
         "bound_by": lbwd_by, "library_ms": None},
        {"name": "mp_pair_bwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_pair_bwd.cu",
         "replaces": REPLACES["mp_pair_bwd"],
         "launches": train_launches["mp_pair_bwd"],
         "max_abs_err": by_route(e_pbwd)[0],
         "ms": pbwd_ms, "plain_ms": pbwd_plain_ms, "bound_ms": pbwd_bound,
         "bound_by": pbwd_by, "library_ms": None},
        {"name": "mp_layer_fwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_layer_fwd.cu",
         "replaces": REPLACES["mp_layer_fwd"],
         "launches": mp_counts["mp_layer_fwd"], "max_abs_err": e_lfwd,
         "ms": lf_ms, "plain_ms": lf_plain_ms, "bound_ms": lf_bound,
         "bound_by": lf_by, "library_ms": None},
        {"name": "mp_layer_bwd", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_layer_bwd.cu",
         "replaces": REPLACES["mp_layer_bwd"],
         "launches": mp_train_counts["mp_layer_bwd"],
         "max_abs_err": e_lbwd_layer, "ms": lb_ms, "plain_ms": lb_plain_ms,
         "bound_ms": lb_bound, "bound_by": lb_by, "library_ms": None},
        {"name": "mp_pair_fwd_stash", "route": "cuda",
         "source": "msmp_pde_torch/csrc/mp_pair_fwd.cu",
         "replaces": REPLACES["mp_pair_fwd_stash"],
         "launches": fb_counts["mp_pair_fwd_stash"], "max_abs_err": e_pstash,
         "ms": st_ms, "plain_ms": st_plain_ms, "bound_ms": st_bound,
         "bound_by": st_by, "library_ms": None},
    ]
    # the hidden-164 launches (MSGMP-PDE): the LEM's hidden-164 route
    # (lem_fwd_ring; lem_bwd, whose five launches are the two transposes,
    # lem_bwd_ring, lem_bwd_wgrad and the ordered sum, and lem_bwd_wgrad's
    # own row), the pairs at 164; launches in phase 20's fit
    g_errs = {"lem_fwd": by_route(err["lem_fwd"])[1],
              "lem_fwd_stash": by_route(e_stash)[1],
              "lem_bwd": by_route(e_lbwd)[1],
              "mp_pair_fwd": by_route(err["mp_pair_fwd"])[1],
              "mp_pair_bwd": by_route(e_pbwd)[1]}
    ring_names = {"lem_fwd": "lem_fwd_ring", "lem_fwd_stash":
                  "lem_fwd_ring_stash"}
    for name, (ms, pms, _, bms, by) in g_times.items():
        src = name.replace("_stash", "")
        kernels.append({
            "name": f"{ring_names.get(name, name)}@hidden{Hg}",
            "route": "cuda", "source": f"msmp_pde_torch/csrc/{src}.cu",
            "replaces": REPLACES[name], "launches": msgmp_counts[name],
            "max_abs_err": g_errs[name], "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    kernels.append({
        "name": f"lem_bwd_wgrad@hidden{Hg}", "route": "cuda",
        "source": "msmp_pde_torch/csrc/lem_bwd.cu",
        "replaces": REPLACES["lem_bwd"], "launches": msgmp_counts["lem_bwd"],
        "max_abs_err": e_wgrad[Hg], "ms": wgrad_ms,
        "plain_ms": wgrad_plain_ms, "bound_ms": wgrad_bound[0],
        "bound_by": wgrad_bound[1], "library_ms": wgrad_lib_ms})
    # the message-passing kernels at the 2-D models' D = 50, V = 3, hidden
    # 128: launches in phase 23's main paths (the pair in the MSMP-PDE2D
    # fit, the single layer in the served MSG2-PDE2D requests and its
    # train_epoch, the stash in the forced-fallback step)
    d50_launches = {
        "mp_pair_fwd": fit2d_counts["mp_pair_fwd"],
        "mp_pair_bwd": fit2d_counts["mp_pair_bwd"],
        "mp_layer_fwd": served2d["MSG2-PDE2D"]["mp_layer_fwd"],
        "mp_layer_bwd": msg2_counts["mp_layer_bwd"],
        "mp_pair_fwd_stash": fb2d_counts["mp_pair_fwd_stash"]}
    for name, (ms, pms, _, bms, by) in d50_t.items():
        src = name.replace("_stash", "")
        kernels.append({
            "name": f"{name}@D50", "route": "cuda",
            "source": f"msmp_pde_torch/csrc/{src}.cu",
            "replaces": REPLACES[name], "launches": d50_launches[name],
            "max_abs_err": d50_err[name], "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    # the message-passing kernels on the wave equation's k-NN graph (K =
    # 3, V = 3, hidden 128): launches in phase 25's main paths (the pair
    # in the WE3 fit of MSMP-PDE, the single layer in MP-PDE's WE3
    # train_epoch, the stash in the forced-fallback step)
    knn_launches = {
        "mp_pair_fwd": knn_fit["mp_pair_fwd"],
        "mp_pair_bwd": knn_fit["mp_pair_bwd"],
        "mp_layer_fwd": knn_layer["mp_layer_fwd"],
        "mp_layer_bwd": knn_layer["mp_layer_bwd"],
        "mp_pair_fwd_stash": knn_fb["mp_pair_fwd_stash"]}
    for name, (ms, pms, _, bms, by) in knn_t.items():
        src = name.replace("_stash", "")
        kernels.append({
            "name": f"{name}@knn", "route": "cuda",
            "source": f"msmp_pde_torch/csrc/{src}.cu",
            "replaces": REPLACES[name], "launches": knn_launches[name],
            "max_abs_err": knn_err[name], "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    # the message-passing kernels on RPU's k-NN graph (K = 3, in-degrees
    # from 0, D = 50, V = 3, hidden 128): launches in phase 26's main paths
    # (the pair in the RPU fit of MSMP-PDE2D, the single layer in MP-PDE2D's
    # RPU train_epoch, the stash in the forced-fallback step)
    rpu_launches = {
        "mp_pair_fwd": rpu_fit["mp_pair_fwd"],
        "mp_pair_bwd": rpu_fit["mp_pair_bwd"],
        "mp_layer_fwd": rpu_layer["mp_layer_fwd"],
        "mp_layer_bwd": rpu_layer["mp_layer_bwd"],
        "mp_pair_fwd_stash": rpu_fb["mp_pair_fwd_stash"]}
    for name, (ms, pms, _, bms, by) in rpu_t.items():
        src = name.replace("_stash", "")
        kernels.append({
            "name": f"{name}@rpu", "route": "cuda",
            "source": f"msmp_pde_torch/csrc/{src}.cu",
            "replaces": REPLACES[name], "launches": rpu_launches[name],
            "max_abs_err": rpu_err[name], "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    # the bf16 modes (phase 27, E1's shapes, hidden 128): launches in the
    # modes' main paths (the pair in the MSMP-PDE fit, the single layer in
    # MP-PDE's train_epoch, the stash in the forced-fallback step)
    for mode in BF16_MODES:
        launches27 = {
            "mp_pair_fwd": fit27[mode]["mp_pair_fwd"],
            "mp_pair_bwd": fit27[mode]["mp_pair_bwd"],
            "mp_layer_fwd": mp27[mode]["mp_layer_fwd"],
            "mp_layer_bwd": mp27[mode]["mp_layer_bwd"],
            "mp_pair_fwd_stash": stash27[mode]["mp_pair_fwd_stash"]}
        for name, n in launches27.items():
            ms, pms, _, bms, by = t27k[name, mode]
            kernels.append({
                "name": f"{name}@{BF16_TAGS[mode]}", "route": "cuda",
                "source": f"msmp_pde_torch/csrc/"
                          f"{name.replace('_stash', '')}.cu",
                "replaces": REPLACES[name], "launches": n,
                "max_abs_err": bf16_err[name, mode][1], "ms": ms,
                "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(on)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


WORKERS = {"--replay": replay_worker, "--ddp": ddp_worker}

if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in WORKERS:
        WORKERS[sys.argv[1]](sys.argv[2])
    else:
        main()
