"""PyTorch port, the spans of msmp_pde_torch/tracing.py on the CPU:
nothing is recorded while no profiler records; under a CPU torch.profiler
a training step and a rollout record their layers' spans, nested and
grouped by id, one op span a kernel call (chip_smoke.py's
``expected_launches``), on the profiler's clock, session by session. The
plain versions run on the CPU, so no ``launch.*`` span opens here
(tests/test_torch_tracing_gpu.py holds those on the card). MSMP-PDE and
MP-PDE at one layer on E1's grid cut to nx 40."""
from collections import Counter

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from msmp_pde_torch.serving.engine import RolloutEngine
from msmp_pde_torch.training.setup import build_trainer
from msmp_pde_torch import tracing

from _torch_helpers import one_thread  # noqa: F401
from chip_smoke import expected_launches

pytestmark = pytest.mark.usefixtures("one_thread")

NX = 40
OPS = {"op.pair_fwd": "mp_pair_fwd", "op.pair_bwd": "mp_pair_bwd",
       "op.layer_fwd": "mp_layer_fwd", "op.layer_bwd": "mp_layer_bwd",
       "op.lem_fwd": "lem_fwd", "op.lem_bwd": "lem_bwd"}


def _trainer(model):
    return build_trainer("E1", model, base_resolution=(250, NX),
                         n_graph_layers=1, device="cpu")


@pytest.fixture(scope="module")
def msmp():
    tr = _trainer("MSMP-PDE")
    tx = tr.make_optimizer(1e-4, 0.4, [1], 10)
    u_all = torch.randn(4, 250, NX,
                        generator=torch.Generator().manual_seed(0))
    step = tr.train_step_fn(tx, 1)

    def run():
        return step(u_all, {}, torch.tensor([0, 2]),
                    torch.tensor([30, 60]))

    run()  # warm
    return tr, run


@pytest.fixture(scope="module")
def mppde():
    eng = RolloutEngine(_trainer("MP-PDE"), batch_buckets=(2,))
    window = np.random.default_rng(0).normal(size=(3, NX, 25)).astype(
        np.float32)

    def run(members=2, n_windows=3):
        return eng.rollout(window[:members], start_step=50,
                           n_windows=n_windows)

    run()  # warm
    return eng, run


def _traced(*fns):
    """Runs ``fns`` under a CPU profiler; (its spans, the profile)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        for fn in fns:
            fn()
    finally:
        prof.stop()
    return tracing.spans(), prof


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _ancestors(spans, s):
    out = []
    while s.parent >= 0:
        s = spans[s.parent]
        out.append(s.name)
    return out


def test_the_private_attributes_a_span_reads():
    """The profiler's module flag is set exactly while it records, and a
    ``_RecordFunctionFast`` range lands in its trace by name."""
    assert not autograd_profiler._is_profiler_enabled
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
        with torch._C._profiler._RecordFunctionFast("probe.range"):
            pass
    finally:
        prof.stop()
    assert not autograd_profiler._is_profiler_enabled
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("probe.range") == 1


def test_off_a_span_is_the_shared_noop_and_records_nothing(msmp, mppde):
    assert tracing.span("train.step") is tracing.NOOP
    assert tracing.span("x", id=tracing.NEW) is tracing.NOOP
    before = tracing.spans()
    msmp[1]()
    mppde[1]()
    assert tracing.spans() == before


def test_a_training_step_records_its_phases(msmp):
    tr, run = msmp
    spans, _ = _traced(run)
    assert all(s.end_ns is not None for s in spans)
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["train.step"]
    step = roots[0]
    sid = spans[step].id
    assert sid is not None and all(s.id == sid for s in spans)
    names = Counter(s.name for s in _children(spans, step))
    assert names == {"train.pushforward": 1, "train.loss": 1,
                     "train.backward": 1, "train.optimizer": 2}
    fwd = [s for s in spans if s.name == "model.forward"]
    assert sorted(spans[s.parent].name for s in fwd) == [
        "train.loss", "train.pushforward"]
    counts = Counter(s.name for s in spans)
    want = expected_launches(tr.model, 2, 1)
    for op, kernel in OPS.items():
        assert counts[op] == want[kernel], op
    assert counts["op.pair_fwd"] and counts["op.lem_bwd"]
    for s in spans:
        if s.name.startswith("op."):
            parent = spans[s.parent].name
            assert parent == ("train.backward" if s.name.endswith("_bwd")
                              else "model.forward"), s
    assert not [s for s in spans if s.name.startswith("launch.")]
    assert "op.inverse_lists" not in counts and "op.build" not in counts
    assert tracing.dropped() == 0


def test_a_rollout_records_its_program_and_answer(mppde):
    eng, run = mppde
    spans, _ = _traced(run)
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["serve.rollout"]
    rid = spans[roots[0]].id
    assert rid is not None and all(s.id == rid for s in spans)
    assert [s.name for s in _children(spans, roots[0])] == [
        "serve.program", "serve.answer"]
    program = [i for i, s in enumerate(spans) if s.name == "serve.program"]
    assert [s.name for s in _children(spans, program[0])] == [
        "model.forward"] * 3
    counts = Counter(s.name for s in spans)
    want = expected_launches(eng.trainer.model, 3)
    for op, kernel in OPS.items():
        assert counts[op] == want[kernel], op
    assert counts["op.layer_fwd"] == 3
    assert all(spans[s.parent].name == "model.forward" for s in spans
               if s.name.startswith("op."))


def test_a_chunked_request_nests_its_chunks_under_one_id(mppde):
    _, run = mppde
    spans, _ = _traced(lambda: run(members=3, n_windows=1), run)
    rollouts = [(i, s) for i, s in enumerate(spans)
                if s.name == "serve.rollout"]
    first, second = [s for _, s in rollouts if s.parent < 0]
    assert first.id != second.id
    top = next(i for i, s in rollouts if s.parent < 0)
    chunks = _children(spans, top)
    assert [s.name for s in chunks] == ["serve.rollout"] * 2
    mine = [s for s in spans if s.id == first.id]
    assert Counter(s.name for s in mine)["serve.program"] == 2
    assert all(s.id == first.id for s in chunks)


def _gaps(spans, prof):
    """Each span's (start - its range's start, its range's end - end), in
    ns, against the range of the same name that opened last before it."""
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    out = []
    for s in spans:
        lo, hi = max(r for r in ranges[s.name] if r[0] <= s.start_ns)
        out.append((s.start_ns - lo, hi - s.end_ns))
    return out


def test_spans_lie_on_the_profilers_clock(mppde):
    """Every span lies inside its range; in one of three traced requests
    (each after a warm one) every end lies within 100 us of its range's:
    a collection or a preemption between the two stamps can stretch one
    gap now and then, a clock other than the profiler's puts every span
    outside its range."""
    _, run = mppde

    def one():
        run(n_windows=1)

    close = []
    for _ in range(3):
        spans, prof = _traced(one, one)  # the first call warms the ranges
        gaps = _gaps([s for s in spans if s.id == spans[-1].id], prof)
        assert len(gaps) == 5  # rollout, program, forward, op, answer
        assert all(a >= 0 and b >= 0 for a, b in gaps), gaps
        close.append(max(max(g) for g in gaps) <= 100_000)
    assert any(close)


def test_a_session_returns_its_own_spans_only(msmp, mppde):
    _traced(msmp[1])
    msmp[1]()  # untraced: the session ends
    spans, _ = _traced(mppde[1])
    assert {s.name for s in spans} >= {"serve.rollout", "op.layer_fwd"}
    assert not [s for s in spans if s.name.startswith("train.")]
    tracing.spans()  # a reading after the session also ends it
    spans, _ = _traced(lambda: mppde[1](n_windows=1))
    assert Counter(s.name for s in spans)["model.forward"] == 1


def test_a_backward_on_another_thread_nests_under_the_waiting_span():
    """Autograd runs a CUDA backward on its device thread: a span opened
    on a thread with none of its own open takes the innermost span open
    in the process as its parent."""
    import threading

    def worker():
        with tracing.span("op.pair_bwd"):
            pass

    def run():
        with tracing.span("train.step", id=tracing.NEW):
            with tracing.span("train.backward"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()

    spans, _ = _traced(run)
    bwd = next(s for s in spans if s.name == "op.pair_bwd")
    assert _ancestors(spans, bwd) == ["train.backward", "train.step"]
    assert bwd.id == spans[0].id
