"""PyTorch port, the spans of msmp_pde_torch/tracing.py on the card:
under torch.profiler with CUDA activity, a training step of MSMP-PDE and a
rollout of MP-PDE at E1's full widths open one ``launch.<k>`` span a
kernel launch (each count the delta of its launch counter), each inside
its ``op.<k>``; the backward's op spans, run on autograd's device thread,
sit under the step's ``train.backward``; the spans lie inside their
profiler ranges; the inverse lists are not recomputed and nothing is
built. The eager step (``Trainer._one_step``, the route of a process
group) and the engine's ``RolloutProgram`` called directly open those
spans; the graphed step that ``train_step_fn`` gives on the card opens
``train.step`` and its ``train.replay`` alone, and a request to the
engine, replayed from its graph, ``serve.rollout`` and its
``serve.program`` (holding ``serve.replay``) and ``serve.answer``; both
advance the launch counters as the eager route does, and the profiler
still records the replayed kernels by name. Skipped without a card. This
file imports no JAX:

    python -m pytest tests/test_torch_tracing_gpu.py -m gpu --noconftest -q
"""
from collections import Counter

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from msmp_pde_torch.ops import lem_scan, mp_layer, mp_pair
from msmp_pde_torch.serving.engine import RolloutEngine, build_serving_trainer
from msmp_pde_torch.training.setup import build_trainer
from msmp_pde_torch import tracing

from _torch_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.gpu

# launch.<k> -> (module, its launch counter)
COUNTERS = {"pair_fwd": (mp_pair, "launches"),
            "pair_bwd": (mp_pair, "bwd_launches"),
            "layer_fwd": (mp_layer, "launches"),
            "layer_bwd": (mp_layer, "bwd_launches"),
            "lem_fwd": (lem_scan, "launches"),
            "lem_bwd": (lem_scan, "bwd_launches")}


def _counts():
    return {k: getattr(m, a) for k, (m, a) in COUNTERS.items()}


def _traced(fn):
    """``fn`` under torch.profiler with CUDA activity: (its spans, the
    launch counters' deltas, the profile)."""
    before = _counts()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    after = _counts()
    return (tracing.spans(), {k: after[k] - before[k] for k in after},
            prof)


def _ancestors(spans, s):
    out = []
    while s.parent >= 0:
        s = spans[s.parent]
        out.append(s.name)
    return out


def _check_launches(spans, deltas):
    counts = Counter(s.name for s in spans)
    for k, d in deltas.items():
        assert counts["launch." + k] == d, (k, counts["launch." + k], d)
        assert counts["op." + k] == d, k
    for s in spans:
        if s.name.startswith("launch."):
            assert spans[s.parent].name == "op." + s.name[len("launch."):]
    assert "op.inverse_lists" not in counts and "op.build" not in counts


def _check_inside_ranges(spans, prof):
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for s in spans:
        lo, hi = max(r for r in ranges[s.name] if r[0] <= s.start_ns)
        assert lo <= s.start_ns <= s.end_ns <= hi, s


def test_the_private_attributes_a_span_reads(cuda_device):
    assert not autograd_profiler._is_profiler_enabled
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled
        with torch._C._profiler._RecordFunctionFast("probe.range"):
            pass
    finally:
        prof.stop()
    assert not autograd_profiler._is_profiler_enabled
    assert tracing.span("x") is tracing.NOOP
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("probe.range") == 1


def test_a_traced_training_step(cuda_device):
    tr = build_trainer("E1", "MSMP-PDE", base_resolution=(250, 100),
                       device=cuda_device)
    tx = tr.make_optimizer(1e-4, 0.4, [1], 100)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    u_all = torch.randn(32, 250, 100, device=cuda_device, generator=g)
    idx = torch.arange(16, device=cuda_device)
    steps = torch.full((16,), 50, device=cuda_device)
    step = tr._one_step(tx, 1)
    step(u_all, {}, idx, steps)  # warm
    spans, deltas, prof = _traced(lambda: step(u_all, {}, idx, steps))
    assert deltas["pair_bwd"] == 6 and deltas["lem_bwd"] == 1
    _check_launches(spans, deltas)
    assert [s.name for s in spans if s.parent < 0] == ["train.step"]
    assert len({s.id for s in spans}) == 1
    bwd = [s for s in spans if s.name in ("op.pair_bwd", "op.lem_bwd")]
    assert len(bwd) == 7
    for s in bwd:
        assert _ancestors(spans, s)[:2] == ["train.backward", "train.step"]
    _check_inside_ranges(spans, prof)


def test_a_traced_replayed_step(cuda_device):
    tr = build_trainer("E1", "MSMP-PDE", base_resolution=(250, 100),
                       device=cuda_device)
    tx = tr.make_optimizer(1e-4, 0.4, [1], 100)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    u_all = torch.randn(32, 250, 100, device=cuda_device, generator=g)
    idx = torch.arange(16, device=cuda_device)
    steps = torch.full((16,), 50, device=cuda_device)
    step = tr.train_step_fn(tx, 1)
    step(u_all, {}, idx, steps)  # captures
    spans, deltas, prof = _traced(lambda: step(u_all, {}, idx, steps))
    assert deltas["pair_fwd"] == 12 and deltas["pair_bwd"] == 6
    assert deltas["lem_fwd"] == 2 and deltas["lem_bwd"] == 1
    assert [s.name for s in spans] == ["train.step", "train.replay"]
    assert spans[1].parent == 0
    _check_inside_ranges(spans, prof)
    kernels = Counter(e.name() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA)
    for name, n in (("mp_pair_bwd_kernel", 6), ("mp_pair_fwd_kernel", 12),
                    ("lem_bwd_sweep", 1)):
        assert sum(c for k, c in kernels.items() if name in k) == n, (
            name, sorted(kernels.items())[:40])


def _mppde_engine(dev):
    tr = build_serving_trainer("E1", "MP-PDE", base_resolution=(250, 100),
                               device=dev)
    eng = RolloutEngine(tr, batch_buckets=(16,))
    window = np.random.default_rng(0).normal(size=(16, 100, 25)).astype(
        np.float32)
    return eng, window


def test_a_traced_request(cuda_device):
    eng, window = _mppde_engine(cuda_device)

    def run():
        eng.rollout(window, start_step=50, n_windows=8)

    run()  # captures
    spans, deltas, prof = _traced(run)
    assert deltas["layer_fwd"] == 48
    counts = Counter(s.name for s in spans)
    assert counts == Counter(["serve.rollout", "serve.program",
                              "serve.replay", "serve.answer"])
    assert [s.name for s in spans if s.parent < 0] == ["serve.rollout"]
    replay = next(s for s in spans if s.name == "serve.replay")
    assert spans[replay.parent].name == "serve.program"
    assert len({s.id for s in spans}) == 1
    _check_inside_ranges(spans, prof)
    kernels = Counter(e.name() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA)
    assert sum(c for k, c in kernels.items()
               if "mp_layer_fwd_kernel" in k) == 48, sorted(kernels.items())


def test_a_traced_eager_request(cuda_device):
    eng, window = _mppde_engine(cuda_device)
    prog = eng.program(8)
    args = (torch.as_tensor(window, device=cuda_device),
            torch.full((16,), 50, dtype=torch.int64, device=cuda_device),
            {})

    def run():
        with torch.inference_mode():
            prog(*args)

    run()  # warm
    spans, deltas, prof = _traced(run)
    assert deltas["layer_fwd"] == 48
    _check_launches(spans, deltas)
    counts = Counter(s.name for s in spans)
    assert counts["model.forward"] == 8
    assert [s.name for s in spans if s.parent < 0] == ["model.forward"] * 8
    _check_inside_ranges(spans, prof)
