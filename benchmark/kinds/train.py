"""A training cell: the program's ``Trainer.train_step_fn`` steps in
``train_epoch``'s order over trajectories held on the device, for the whole
window (msmp_pde_torch/training/loop.py).

Set-up builds one trainer (model, AdamW, schedule), loads the benchmark's
weights into it, makes the training split on the device and drives the
first ``check_steps`` steps through the window's own call and feed, on rows
that all differ (one pass's permutation); it keeps each step's loss, the
first gradient as AdamW holds it (its first moment after one step over
1 - beta1) and the parameters after the last of them. It warms both
pushforward depths on further steps of the same feed, and the window goes
on from there with the same objects. After the window the program's state
is freed and the plain reference (benchmark/reference/training.py) runs
the same steps from the same weights and rows.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import traffic
from benchmark.counts.mpsolver import call_shape
from benchmark.harness import span
from benchmark.reference import training as ref_training
from benchmark.reference.mpsolver import Precision

PROGRAM = ("trainer", "opt", "u_all", "feed", "fns")


def build(cfg, device):
    """The program's trainer for ``cfg`` (its own initial weights, which
    the benchmark's replace)."""
    from msmp_pde_torch.training.setup import build_trainer

    return build_trainer(cfg["experiment"], cfg["model"],
                         base_resolution=(cfg["nt"], cfg["nx"]),
                         neighbors=cfg["neighbors"], time_window=cfg["tw"],
                         n_graph_layers=cfg["layers"],
                         mp_precision=cfg["mp_precision"], device=device)


def hyper(cfg, tr):
    """AdamW's rate and schedule as the train CLI sets them: steps_per_epoch
    = nt passes of n // batch batches."""
    return {"lr": tr["lr"], "lr_decay": tr["lr_decay"],
            "milestones": tr["milestones"],
            "steps_per_epoch": cfg["nt"] * (tr["trajectories"]
                                            // tr["batch"])}


def first_gradient(opt, named):
    """{name: the gradient of the first step} from AdamW's first moment
    (beta1 m0 + (1 - beta1) g with m0 = 0); zeros where AdamW holds no
    state (a step that did not update)."""
    b1 = opt.param_groups[0]["betas"][0]
    out = {}
    for n, p in named:
        st = opt.state.get(p, {})
        out[n] = (st["exp_avg"] / (1 - b1) if "exp_avg" in st
                  else torch.zeros_like(p)).detach().clone()
    return out


def setup(cell, seed, device, plant=None):
    cfg, tr, arch = cell.config, cell.traffic, cell.arch
    stamps = [("setup", time.perf_counter())]
    trainer = build(cfg, device)
    weights = arch.make_weights(cfg, traffic.generator(seed, "weights",
                                                       device), device)
    trainer.model.load_state_dict(weights, strict=True)
    stamps.append(("model", time.perf_counter()))
    x = torch.linspace(0.0, cfg["L"], cfg["nx"], dtype=torch.float64).to(
        device=device, dtype=torch.float32)
    u_all = traffic.smooth(tr["trajectories"], arch.time_grid(cfg, device),
                           x, cfg["L"], traffic.generator(seed, "data",
                                                          device))
    h = hyper(cfg, tr)
    opt, sched = tx = trainer.make_optimizer(h["lr"], h["lr_decay"],
                                             h["milestones"],
                                             h["steps_per_epoch"])
    feed = traffic.TrainFeed(tr["trajectories"], tr["batch"], cfg["nt"],
                             cfg["tw"], tr["epoch"], tr["unrolling"],
                             np.random.default_rng(
                                 traffic.stream_seed(seed, "feed")), device)
    fns = {f: trainer.train_step_fn(tx, f) for f in feed.choices}
    stamps.append(("data", time.perf_counter()))
    state = {"cell": cell, "device": device, "weights": weights,
             "trainer": trainer, "opt": opt, "u_all": u_all, "feed": feed,
             "fns": fns, "stamps": stamps}
    if plant is not None:
        plant(state)
        fns = state["fns"]
    named = list(trainer.model.named_parameters())
    losses, rows, g1, seen = [], [], None, set()
    for k in range(tr["check_steps"]):
        idx, st, f = feed.next()
        losses.append(fns[f](u_all, {}, idx, st))
        rows.append((u_all[idx].clone(), st.clone(), f))
        seen.add(f)
        if k == 0:
            g1 = first_gradient(opt, named)
    after = {n: p.detach().clone() for n, p in named}
    stamps.append(("check steps", time.perf_counter()))
    n = tr["check_steps"]
    while n < tr["warmup_steps"] or seen != set(feed.choices):
        idx, st, f = feed.next()
        fns[f](u_all, {}, idx, st)
        seen.add(f)
        n += 1
    stamps.append(("warm-up", time.perf_counter()))
    state.update(losses=losses, rows=rows, g1=g1, after=after)
    return state


def window(state, seconds, spans, trace):
    fns, feed, u_all = state["fns"], state["feed"], state["u_all"]
    losses, flags = [], []
    t0 = time.perf_counter()
    while True:
        idx, st, f = feed.next()
        a = time.perf_counter()
        with span(trace, "train.step"):
            losses.append(fns[f](u_all, {}, idx, st))
        b = time.perf_counter()
        spans.add("train.step", a, b)
        flags.append(f)
        if b - t0 >= seconds:
            break
    if u_all.is_cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    tr = state["cell"].traffic
    bad = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"attempted": len(losses), "failed": bad, "elapsed_s": elapsed,
            "flags": flags,
            "shape": call_shape(state["cell"].config, tr["batch"]),
            "end_to_end": {
                "train_samples_per_s": tr["batch"] * len(losses) / elapsed}}


def readings(losses, g1, change):
    return {"losses": [float(x) for x in losses], "g1": g1,
            "change": change}


def program_readings(state):
    """The program's losses, first gradient and change after the check
    steps, then its state freed."""
    out = readings(state["losses"], state["g1"],
                   {n: state["after"][n] - state["weights"][n]
                    for n in state["after"]})
    for k in PROGRAM:
        state.pop(k, None)
    if state["device"] == "cuda":
        torch.cuda.empty_cache()
    return out


def reference_readings(state, precision="float32"):
    """The plain reference's losses, first gradient and change over the
    same steps from the same weights and rows."""
    cell = state["cell"]
    arch, cfg = cell.arch, cell.config
    graph = arch.Graph(cfg, state["device"])
    losses, g1, change = ref_training.train_steps(
        arch, cfg, state["weights"], graph, state["rows"],
        hyper(cfg, cell.traffic), Precision(precision))
    return readings(losses, g1, change)


def numbers(got, ref, detail=False):
    """The numbers compared, over the leaves that the reference's first
    gradient moves (a bias that an InstanceNorm follows gets a gradient of
    rounding alone): the worst step's loss gap; the worst leaf's gap of
    the first gradient's norm; the median leaf's gap of the change's norm
    after the check steps (AdamW's normalised steps carry the rounding of
    an element whose gradient sign flips into the next steps, so the worst
    leaf's change swings from seed to seed; PERF.md section 2).
    With ``detail`` also each step's gap and the worst leaves, for
    calibrate.py."""
    moving = ref_training.moving_leaves(ref["g1"])
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  ref["losses"])]
    grads = ref_training.leaf_gaps(got["g1"], ref["g1"], moving)
    changes = ref_training.leaf_gaps(got["change"], ref["change"], moving)
    out = {"loss_gap": max(losses),
           "grad_gap": ref_training.worst(grads)[0],
           "change_gap": ref_training.median(changes)}
    if detail:
        norms = {n: float(torch.linalg.vector_norm(g))
                 for n, g in ref["g1"].items()}
        med = sorted(norms.values())[len(norms) // 2]
        out.update(loss_gaps=losses, grad_leaf=ref_training.worst(grads)[1],
                   change_worst=ref_training.worst(changes),
                   left_out=sorted((n, norms[n] / med) for n in norms
                                   if n not in moving),
                   least_kept=min((norms[n] / med, n) for n in moving))
    return out


def check(state, win):
    got = program_readings(state)
    return numbers(got, reference_readings(state))
