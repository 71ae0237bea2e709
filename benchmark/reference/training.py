"""Plain PyTorch reference of the training step: the pushforward trick and
temporal bundling of MP-PDE (arXiv:2202.03376, section 2.3), the loss
sqrt(sum((pred - labels)^2)), autograd, and AdamW (Loshchilov and Hutter,
arXiv:1711.05101) with decoupled weight decay and a step-wise schedule. It
imports torch and the architecture's reference module alone.
"""
from __future__ import annotations

import math

import torch


def windows(u_rows, steps, tw: int):
    """u_rows [B, nt, nx], steps [B] -> (the tw steps before each step,
    the tw steps from it), each [B, nx, tw]."""
    B = u_rows.shape[0]
    rows = torch.arange(B, device=u_rows.device)[:, None]
    ar = torch.arange(tw, device=u_rows.device)[None, :]
    before = u_rows[rows, steps[:, None] - tw + ar].transpose(1, 2)
    after = u_rows[rows, steps[:, None] + ar].transpose(1, 2)
    return before, after


def loss_of(arch, cfg, w, graph, t_grid, u_rows, steps, unrolled, p):
    """One batch's loss after ``unrolled`` pushforward windows, which take
    no gradient."""
    tw = cfg["tw"]
    window, _ = windows(u_rows, steps, tw)
    with torch.no_grad():
        for _ in range(unrolled):
            pred = arch.forward(cfg, w, graph, window, t_grid[steps], p)
            window = torch.cat([window, pred], -1)[..., tw:]
            steps = steps + tw
    _, labels = windows(u_rows, steps, tw)
    pred = arch.forward(cfg, w, graph, window, t_grid[steps], p)
    return torch.sqrt(torch.sum((pred - labels) ** 2))


def adamw(params, grads, state, lr, step, betas=(0.9, 0.999), eps=1e-8,
          weight_decay=0.01):
    """One AdamW update of ``params`` in place (``step`` counts from 1):
    p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps)."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p),
                                       torch.zeros_like(p)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state[name] = (m, v)
        m_hat = m / (1 - b1 ** step)
        v_hat = v / (1 - b2 ** step)
        p.mul_(1 - lr * weight_decay).sub_(lr * m_hat
                                          / (torch.sqrt(v_hat) + eps))


def learning_rate(hyper, count: int) -> float:
    """The rate at update ``count`` (from 0): lr times lr_decay once for
    each milestone epoch that ``count`` has reached."""
    bounds = {m * hyper["steps_per_epoch"] for m in hyper["milestones"]}
    return hyper["lr"] * hyper["lr_decay"] ** sum(count >= b for b in bounds)


def train_steps(arch, cfg, weights, graph, batches, hyper, p):
    """Runs len(batches) steps from ``weights`` (left unchanged); each
    batch is (u_rows [B, nt, nx], steps [B], unrolled). Returns (each
    step's loss, the first step's gradients {name: tensor}, the change of
    every parameter after the last step {name: tensor})."""
    t_grid = torch.linspace(0.0, cfg["tmax"], cfg["nt"],
                            device=graph.x.device)
    params = {k: v.detach().clone() for k, v in weights.items()}
    state, losses, first = {}, [], None
    for k, (u_rows, steps, unrolled) in enumerate(batches):
        leaves = {n: t.requires_grad_(True) for n, t in params.items()}
        loss = loss_of(arch, cfg, leaves, graph, t_grid, u_rows, steps,
                       unrolled, p)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        with torch.no_grad():
            params = {n: t.detach() for n, t in leaves.items()}
            adamw(params, grads, state, learning_rate(hyper, k), k + 1)
    change = {n: params[n] - weights[n] for n in params}
    return losses, first, change


def leaf_gaps(program, reference, keep=None):
    """{leaf: the gap between its two norms}: |‖a‖ - ‖b‖| over the larger
    of ‖b‖ and the median leaf's ‖b‖, for the leaves in ``keep`` (default
    all); inf where a norm is not finite."""
    names = [n for n in reference if keep is None or n in keep]
    ref = {n: float(torch.linalg.vector_norm(reference[n])) for n in names}
    med = sorted(ref.values())[len(ref) // 2]
    gaps = {}
    for n in names:
        got = float(torch.linalg.vector_norm(program[n]))
        gap = abs(got - ref[n]) / max(ref[n], med)
        gaps[n] = gap if math.isfinite(gap) else math.inf
    return gaps


def worst(gaps):
    """(the largest gap, its leaf)."""
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def median(gaps):
    """The median leaf's gap (the upper one of an even count)."""
    return sorted(gaps.values())[len(gaps) // 2]


def moving_leaves(first_grads, share=1e-3):
    """The leaves whose first gradient's norm is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {n: float(torch.linalg.vector_norm(g))
             for n, g in first_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {n for n, v in norms.items() if v >= share * med}
