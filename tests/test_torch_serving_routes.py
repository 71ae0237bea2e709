"""PyTorch port, the rollout engine's routes on the CPU (serving/engine.py):

* a CPU engine calls its ``RolloutProgram`` eagerly: it captures no graph,
  counts no capture or replay, and its traced request opens no
  ``serve.capture`` or ``serve.replay`` span;
* ``engine.program(n)`` is still the ``RolloutProgram`` (one a horizon and
  replica), and ``export_rollout`` exports it as before;
* the graphed route, taken here by a stand-in for ``GraphedRollout`` that
  runs the program eagerly (a CUDA graph has no CPU mode): one graph a
  (bucket, n_windows, replica), captured from the program of that horizon
  and replica on the first request and replayed on each later one, the
  graphs of one replica sharing its first graph's pool, the answers equal
  to the eager route's with pad rows dropped.

MP-PDE at one layer on E1's grid cut to nx 40. The graphs themselves are
held on the card (tests/test_torch_serving_graphs_gpu.py)."""
import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msmp_pde_torch.serving import engine as engine_mod
from msmp_pde_torch.serving.engine import (
    RolloutEngine,
    RolloutProgram,
    build_serving_trainer,
)
from msmp_pde_torch.serving.export import export_rollout, load_exported
from msmp_pde_torch import tracing

from _torch_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NX, TW = 40, 25
BUCKETS = (1, 4)


@pytest.fixture(scope="module")
def trainer():
    return build_serving_trainer("E1", "MP-PDE", base_resolution=(250, NX),
                                 n_graph_layers=1, device="cpu")


def _window(B, seed=0):
    return np.random.default_rng(seed).normal(size=(B, NX, TW)).astype(
        np.float32)


class EagerGraph(engine_mod.GraphedRollout):
    """A ``GraphedRollout`` with its capture and replay run eagerly on the
    CPU: records the program and inputs it was made from and its peer."""

    def __init__(self, program, window, steps, variables, peer=None):
        self.program, self.peer, self.rows = program, peer, window.shape[0]
        self.done = types.SimpleNamespace(synchronize=lambda: None)
        self.replayed = 0

    def replay(self, window, steps, variables):
        self.replayed += 1
        self.out = self.program(
            torch.as_tensor(window),
            torch.as_tensor(steps, dtype=torch.int64),
            {k: torch.as_tensor(v) for k, v in variables.items()})

    def fetch(self):
        return self.out


def test_a_cpu_engine_stays_eager(trainer):
    eng = RolloutEngine(trainer, batch_buckets=BUCKETS)
    before = engine_mod.captures, engine_mod.replays
    assert not eng.graphed(0)
    for B, n in ((1, 1), (3, 2), (4, 2)):
        out = eng.rollout(_window(B), start_step=50, n_windows=n)
        assert out.shape == (B, n, NX, TW) and np.isfinite(out).all()
    assert eng.graphs == {}
    assert (engine_mod.captures, engine_mod.replays) == before
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        eng.rollout(_window(2), start_step=50, n_windows=2)
    finally:
        prof.stop()
    counts = Counter(s.name for s in tracing.spans())
    assert counts["serve.program"] == counts["serve.answer"] == 1
    assert counts["model.forward"] == 2
    assert counts["serve.replay"] == counts["serve.capture"] == 0


def test_the_program_is_the_rollout_program_and_exports(trainer):
    eng = RolloutEngine(trainer, batch_buckets=BUCKETS)
    prog = eng.program(3)
    assert type(prog) is RolloutProgram and prog.n_windows == 3
    assert eng.program(3) is prog and eng.program(2) is not prog
    window = _window(4, seed=1)
    steps = np.array([30, 60, 200, 240], np.int32)
    art = load_exported(export_rollout(eng, 4, 3))
    var = eng.default_variables(4)
    np.testing.assert_array_equal(
        art(window, steps, var),
        eng.rollout(window, var, start_step=steps, n_windows=3))
    assert eng.graphs == {}


def test_the_graph_key_follows_bucket_horizon_and_replica(trainer,
                                                          monkeypatch):
    monkeypatch.setattr(engine_mod, "GraphedRollout", EagerGraph)
    monkeypatch.setattr(RolloutEngine, "graphed", lambda self, part: True)
    eager = RolloutEngine(trainer, batch_buckets=BUCKETS)
    eng = RolloutEngine(trainer, batch_buckets=BUCKETS,
                        devices=["cpu", "cpu"])
    monkeypatch.setattr(eager, "graphed", lambda part: False)
    # (members, n_windows): bucket 1 on replica 0 alone, bucket 4 split in
    # two, each at two horizons, then the same again
    requests = [(1, 2), (3, 2), (4, 2), (3, 1), (1, 2), (2, 1), (1, 1)]
    for i, (B, n) in enumerate(requests):
        window = _window(B, seed=10 + i)
        steps = np.arange(B) * 40 + 30
        np.testing.assert_array_equal(
            eng.rollout(window, start_step=steps, n_windows=n),
            eager.rollout(window, start_step=steps, n_windows=n))
    assert eager.graphs == {}
    assert set(eng.graphs) == {(1, 2, 0), (4, 2, 0), (4, 2, 1), (4, 1, 0),
                               (4, 1, 1), (1, 1, 0)}
    for (bucket, n, part), g in eng.graphs.items():
        assert g.program is eng.program(n, part)
        assert g.rows == (bucket // 2 if bucket % 2 == 0 else bucket)
    replayed = {k: g.replayed for k, g in eng.graphs.items()}
    assert replayed == {(1, 2, 0): 2, (4, 2, 0): 2, (4, 2, 1): 2,
                        (4, 1, 0): 2, (4, 1, 1): 2, (1, 1, 0): 1}
    # a replica's first graph has no peer; its later graphs share its pool
    firsts = {0: eng.graphs[(1, 2, 0)], 1: eng.graphs[(4, 2, 1)]}
    for (_, _, part), g in eng.graphs.items():
        assert g.peer is (None if g is firsts[part] else firsts[part])
