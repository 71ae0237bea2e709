"""Faults planted in the program under the benchmark's check, to show that
``correct`` comes out false for each (benchmark/tests and calibrate.py;
the benchmark's own runs plant none). Each takes the state that a kind's
``setup`` built, before its first step or request.
"""
from __future__ import annotations

import math

import torch


def train_unchanged(state):
    """Every step leaves the model's state as it was: AdamW's update does
    nothing."""
    state["opt"].step = lambda *a, **k: None


def train_half_batch(state):
    """Each step takes the first half of its batch and scales the loss to
    the whole batch's size (the mean taken over the rest)."""
    trainer = state["trainer"]
    inner = trainer.step_loss

    def step_loss(u_all, var_all, idx, steps, unrolled, forward=None):
        h = idx.shape[0] // 2
        return math.sqrt(2.0) * inner(u_all, var_all, idx[:h], steps[:h],
                                      unrolled, forward)

    trainer.step_loss = step_loss


def _wrap_program(state, wrap):
    engine, tr = state["engine"], state["cell"].traffic
    prog = engine.program(tr["n_windows"])
    prog.forward = wrap(prog, prog.forward)


def serve_answer_altered(state):
    """One value of every answer is off by 0.01 where it is produced."""

    def wrap(prog, inner):
        def forward(window, steps, variables):
            out = inner(window, steps, variables).clone()
            out[0, -1, 0, -1] += 0.01
            return out
        return forward

    _wrap_program(state, wrap)


def serve_half_batch(state):
    """Half of each request's ensemble is rolled out; the rows of the
    other half repeat it."""

    def wrap(prog, inner):
        def forward(window, steps, variables):
            h = window.shape[0] // 2
            out = inner(window[:h], steps[:h],
                        {k: v[:h] for k, v in variables.items()})
            return torch.cat([out, out[:window.shape[0] - h]])
        return forward

    _wrap_program(state, wrap)


def serve_unchanged(state):
    """The rollout's window never advances: every window's prediction is
    the first's."""

    def wrap(prog, inner):
        def forward(window, steps, variables):
            first = prog.trainer.forward(window, steps, variables)[0]
            return torch.stack([first] * prog.n_windows, dim=1)
        return forward

    _wrap_program(state, wrap)


TRAIN = {"unchanged": train_unchanged, "half_batch": train_half_batch}
SERVE = {"answer_altered": serve_answer_altered,
         "half_batch": serve_half_batch, "unchanged": serve_unchanged}
