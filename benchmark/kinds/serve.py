"""A serving cell: one client in a closed loop, no think time, each
request an ensemble of initial windows rolled out through
``RolloutEngine.rollout`` (msmp_pde_torch/serving/engine.py).

Set-up builds the engine on the configuration's grid with the benchmark's
weights, makes the pool of test trajectories on the device and keeps
their initial windows on the host, and warms the one bucket the requests
use. A request's latency is the host clock around ``rollout``, which ends
once the predictions are on the host. After the window the program's
state is freed and the plain reference checks a sample of the answers,
drawn from the seed: each window of a sampled answer against the
reference's forward from the program's own window before it (a free
float32 rollout amplifies rounding on either side, so no longer stretch
is compared), the first from the request's own input.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import traffic
from benchmark.harness import span
from benchmark.counts.mpsolver import call_shape
from benchmark.reference.mpsolver import Precision

PROGRAM = ("engine", "feed")


def build(cfg, tr, weights, device):
    from msmp_pde_torch.serving.engine import (
        RolloutEngine,
        build_serving_trainer,
    )

    trainer = build_serving_trainer(
        cfg["experiment"], cfg["model"],
        base_resolution=(cfg["nt"], cfg["nx"]), neighbors=cfg["neighbors"],
        time_window=cfg["tw"], n_graph_layers=cfg["layers"],
        mp_precision=cfg["mp_precision"], device=device)
    return RolloutEngine(trainer, params=weights,
                         batch_buckets=tr["buckets"])


def pool_windows(cfg, tr, seed, device, arch):
    """The pool's initial windows [pool, nx, tw] on the host: the tw steps
    before ``start_step`` of each of ``pool`` trajectories."""
    x = torch.linspace(0.0, cfg["L"], cfg["nx"], dtype=torch.float64).to(
        device=device, dtype=torch.float32)
    u = traffic.smooth(tr["pool"], arch.time_grid(cfg, device), x,
                       cfg["L"], traffic.generator(seed, "data", device))
    s, tw = tr["start_step"], cfg["tw"]
    return u[:, s - tw:s].transpose(1, 2).contiguous().cpu().numpy()


def setup(cell, seed, device, plant=None):
    cfg, tr, arch = cell.config, cell.traffic, cell.arch
    stamps = [("setup", time.perf_counter())]
    weights = arch.make_weights(cfg, traffic.generator(seed, "weights",
                                                       device), device)
    engine = build(cfg, tr, weights, device)
    stamps.append(("model", time.perf_counter()))
    pool = pool_windows(cfg, tr, seed, device, arch)
    stamps.append(("data", time.perf_counter()))
    feed = traffic.ServeFeed(pool, tr["members"], np.random.default_rng(
        traffic.stream_seed(seed, "feed")))
    state = {"cell": cell, "device": device, "seed": seed,
             "weights": weights, "engine": engine, "feed": feed, "pool": pool,
             "stamps": stamps}
    if plant is not None:
        plant(state)
    for _ in range(tr["warmup_requests"]):
        request(state, pool[:tr["members"]])
    stamps.append(("warm-up", time.perf_counter()))
    return state


def request(state, window):
    tr = state["cell"].traffic
    return state["engine"].rollout(window, start_step=tr["start_step"],
                                   n_windows=tr["n_windows"])


def _mark_program(state, marks):
    """The traced run's wrapper around the engine's ``RolloutProgram``:
    appends the host clock at its return (the last launch enqueued, before
    the copy to the host) to ``marks``."""
    engine, tr = state["engine"], state["cell"].traffic
    prog = engine.program(tr["n_windows"])
    inner = prog.forward

    def forward(*a, **k):
        out = inner(*a, **k)
        marks.append(time.perf_counter())
        return out

    prog.forward = forward


def window(state, seconds, spans, trace):
    cfg, tr = state["cell"].config, state["cell"].traffic
    feed, marks = state["feed"], []
    if trace:
        _mark_program(state, marks)
    sample = traffic.Reservoir(tr["checked_requests"], np.random.default_rng(
        traffic.stream_seed(state["seed"], "sample")))
    lat, bad = [], 0
    t0 = time.perf_counter()
    while True:
        idx, win = feed.next()
        a = time.perf_counter()
        with span(trace, "serve.rollout"):
            out = request(state, win)
        b = time.perf_counter()
        lat.append(b - a)
        if marks:
            spans.add("serve.enqueue", a, marks[-1])
        if not np.isfinite(out).all():
            bad += 1
        sample.offer((idx, out))
        if b - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    state["sampled"] = sample.items
    ms = np.asarray(lat) * 1e3
    bucket = min(b for b in tr["buckets"] if b >= tr["members"])
    return {"attempted": len(lat), "failed": bad, "elapsed_s": elapsed,
            "latencies_s": lat, "shape": call_shape(cfg, bucket),
            "end_to_end": {"rollout_p50_ms": float(np.percentile(ms, 50)),
                           "rollout_p95_ms": float(np.percentile(ms, 95))}}


def window_gaps(arch, cfg, weights, graph, t_grid, inputs, answers, start,
                p):
    """Each window's widest gap of an answer [B, n_windows, nx, tw]: max
    |answer - reference| over max |reference - the input's last step|,
    the reference taken from the answer's own window before (the request's
    input for the first). Returns the largest."""
    tw = cfg["tw"]
    win = torch.as_tensor(inputs, device=graph.x.device)
    ans = torch.as_tensor(answers, device=graph.x.device)
    B = win.shape[0]
    worst = 0.0
    for k in range(ans.shape[1]):
        if k:
            win = torch.cat([win, ans[:, k - 1]], -1)[..., tw:]
        t = t_grid[start + k * tw].expand(B)
        ref = arch.forward(cfg, weights, graph, win, t, p)
        step = (ref - win[..., -1:]).abs().max()
        gap = float((ans[:, k] - ref).abs().max() / step)
        worst = max(worst, gap if np.isfinite(gap) else np.inf)
    return worst


def control_answers(arch, cfg, weights, graph, t_grid, inputs, n_windows,
                    start, p):
    """The reference's own free rollout of ``inputs`` in precision ``p``:
    the answers the control puts in the program's place."""
    tw = cfg["tw"]
    win = torch.as_tensor(inputs, device=graph.x.device)
    outs = []
    for k in range(n_windows):
        t = t_grid[start + k * tw].expand(win.shape[0])
        pred = arch.forward(cfg, weights, graph, win, t, p)
        outs.append(pred)
        win = torch.cat([win, pred], -1)[..., tw:]
    return torch.stack(outs, 1).cpu().numpy()


def check(state, win):
    for k in PROGRAM:
        state.pop(k, None)
    if state["device"] == "cuda":
        torch.cuda.empty_cache()
    cell = state["cell"]
    cfg, tr, arch = cell.config, cell.traffic, cell.arch
    graph = arch.Graph(cfg, state["device"])
    t_grid = arch.time_grid(cfg, state["device"])
    p = Precision("float32")
    gap = 0.0
    with torch.no_grad():
        for idx, out in state["sampled"]:
            gap = max(gap, window_gaps(arch, cfg, state["weights"], graph,
                                       t_grid, state["pool"][idx], out,
                                       tr["start_step"], p))
    return {"window_gap": gap}
