"""PyTorch port, served rollouts as CUDA graphs (serving/engine.py::
``GraphedRollout``) against the engine's eager ``RolloutProgram`` on the
card, at the models' full widths on E1's grid, TF32 off and cuDNN's
deterministic algorithms on:

* MP-PDE and MSMP-PDE at buckets 1, 4, 16 and 64 (members 1, 3, 16 and
  50, so pad rows are dropped) and 1 or 8 windows, SaveMSMP-PDE from
  start steps whose windows cross nt - tw (its state reset inside the
  graph), and FNO (cuFFT): each answer bitwise ``engine.program(n)``
  called eagerly on the same padded inputs, its pad rows dropped;
* a new bucket or horizon captures anew and a repeated one replays
  (``captures``, ``replays``);
* two requests in a row return arrays of their own: the first answer is
  unchanged by the second;
* each replay advances the launch counters by what the eager program's
  call does;
* a wrapper of ``program.forward`` installed before the first request
  (as benchmark/faults.py plants one) is in the replayed answers; one
  installed after the capture is not.

Skipped without a card. This file imports no JAX:

    python -m pytest tests/test_torch_serving_graphs_gpu.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

from msmp_pde_torch import ops
from msmp_pde_torch.serving import engine as engine_mod
from msmp_pde_torch.serving.engine import RolloutEngine, build_serving_trainer

from _torch_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.gpu

NX, TW, NT = 100, 25, 250
BUCKETS = (1, 4, 16, 64)
MEMBERS = (1, 3, 16, 50)  # one request a bucket, pad rows in two


@pytest.fixture
def deterministic(cuda_device):
    """cuDNN's deterministic algorithms and TF32 off, for the block."""
    was = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark,
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = was


def _engine(model, dev, buckets=BUCKETS):
    return RolloutEngine(build_serving_trainer("E1", model, device=dev),
                         batch_buckets=buckets)


def _request(B, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, NX, TW)).astype(np.float32),
            rng.integers(TW, NT - TW, B).astype(np.int32))


def _eager(eng, window, steps, n_windows):
    """``engine.program(n_windows)`` called eagerly on the request padded
    to its bucket, the pad rows dropped, and the launches it made."""
    B = window.shape[0]
    pad = eng._bucket_for(B) - B
    dev = eng.trainer.device
    w = np.concatenate([window, np.zeros((pad, NX, TW), np.float32)])
    s = np.concatenate([steps, np.full((pad,), TW, np.int32)])
    before = ops.launch_counts()
    with torch.inference_mode():
        out = eng.program(n_windows)(
            torch.as_tensor(w, device=dev),
            torch.as_tensor(s, device=dev, dtype=torch.int64),
            {k: torch.zeros(B + pad, device=dev)
             for k in eng.trainer.eq_norms})
        out = out.cpu().numpy()[:B]
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def _graphed(eng, window, steps, n_windows):
    before = ops.launch_counts()
    out = eng.rollout(window, start_step=steps, n_windows=n_windows)
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("n_windows", [1, 8])
@pytest.mark.parametrize("model", ["MP-PDE", "MSMP-PDE"])
def test_replays_are_the_eager_program(model, n_windows, deterministic):
    eng = _engine(model, deterministic)
    assert eng.graphed(0)
    for B in MEMBERS:
        window, steps = _request(B, seed=B)
        for _ in range(2):  # the capture's request, then a replay
            got, moved = _graphed(eng, window, steps, n_windows)
            want, eager_moved = _eager(eng, window, steps, n_windows)
            assert got.shape == (B, n_windows, NX, TW)
            assert np.array_equal(got, want), (model, B, n_windows)
            assert moved == eager_moved and any(moved.values())
    assert set(eng.graphs) == {(b, n_windows, 0) for b in BUCKETS}


def test_the_stateful_model_across_the_horizon(deterministic):
    eng = _engine("SaveMSMP-PDE", deterministic, buckets=(4, 16))
    window = _request(12, seed=7)[0]
    # nt - tw = 225: windows from these starts cross it within 8 windows
    steps = np.array([25, 60, 110, 150, 170, 190, 200, 210, 215, 220, 224,
                      225], np.int32)
    for _ in range(2):
        got, moved = _graphed(eng, window, steps, 8)
        want, eager_moved = _eager(eng, window, steps, 8)
        assert np.array_equal(got, want)
        assert moved == eager_moved and moved["lem_fwd"] == 8
    assert set(eng.graphs) == {(16, 8, 0)}


def test_a_grid_model(deterministic):
    eng = _engine("FNO", deterministic, buckets=(16,))
    window, steps = _request(9, seed=3)
    for _ in range(2):
        got, moved = _graphed(eng, window, steps, 8)
        want, _ = _eager(eng, window, steps, 8)
        assert np.array_equal(got, want)
        assert not any(moved.values())


def test_captures_per_bucket_and_horizon(deterministic):
    eng = _engine("MP-PDE", deterministic, buckets=(4, 16))
    window, steps = _request(16, seed=1)
    c0, r0 = engine_mod.captures, engine_mod.replays
    plan = [(16, 2, True), (16, 2, False), (3, 2, True), (16, 3, True),
            (4, 2, False), (16, 3, False), (12, 2, False)]
    for i, (B, n, new) in enumerate(plan):
        c = engine_mod.captures
        eng.rollout(window[:B], start_step=steps[:B], n_windows=n)
        assert engine_mod.captures == c + new, (i, B, n)
        assert engine_mod.replays == r0 + i + 1
    assert engine_mod.captures == c0 + 3
    assert set(eng.graphs) == {(16, 2, 0), (4, 2, 0), (16, 3, 0)}
    # one pool and one capture stream for the replica's graphs
    first = eng.graphs[(16, 2, 0)]
    for g in eng.graphs.values():
        assert g.stream is first.stream


def test_answers_do_not_alias(deterministic):
    eng = _engine("MP-PDE", deterministic, buckets=(16,))
    a_in, s = _request(16, seed=2)
    b_in = _request(16, seed=3)[0]
    a = eng.rollout(a_in, start_step=s, n_windows=2)
    kept = a.copy()
    b = eng.rollout(b_in, start_step=s, n_windows=2)
    assert np.array_equal(a, kept) and not np.array_equal(a, b)
    assert not np.shares_memory(a, b)
    g = eng.graphs[(16, 2, 0)]
    assert not np.shares_memory(b, g.host.numpy())


def test_a_wrapper_before_the_capture_is_replayed(deterministic):
    eng = _engine("MP-PDE", deterministic, buckets=(16,))
    window, steps = _request(16, seed=4)
    plain, _ = _eager(eng, window, steps, 2)
    prog = eng.program(2)
    inner = prog.forward

    def altered(window, steps, variables):
        out = inner(window, steps, variables).clone()
        out[0, -1, 0, -1] += 0.01
        return out

    prog.forward = altered
    want, _ = _eager(eng, window, steps, 2)
    for _ in range(2):
        got, _ = _graphed(eng, window, steps, 2)
        assert np.array_equal(got, want) and not np.array_equal(got, plain)
    assert got[0, -1, 0, -1] != plain[0, -1, 0, -1]
    # a wrapper installed after the capture is not seen
    prog.forward = inner
    got, _ = _graphed(eng, window, steps, 2)
    assert np.array_equal(got, want)
