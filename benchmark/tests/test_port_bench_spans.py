"""The readers of the ``program_span`` metrics (benchmark/metrics/, over
benchmark/program_spans.py) on made-up spans: each gives the mean it
documents, and None where the window holds no such span or the program
has no spans at all. Then a traced run of each cell on the CPU reports
them, the program's step and program spans inside the benchmark's own."""
import sys

import pytest

from benchmark import harness
from msmp_pde_torch import tracing
from msmp_pde_torch.tracing import Span

MS = 1_000_000  # ns
TRAIN = ("host_step_ms.train", "host_backward_ms.train",
         "host_optimizer_ms.train", "op_host_us.train")
SERVE = ("host_program_ms.serve", "host_wait_ms.serve", "op_host_us.serve")


def steps():
    """Two steps (ids 0 and 1) of 10 and 14 ms: backward 4 and 6 ms,
    the optimizer 1 + 2 and 1 + 3 ms; op calls of 300 us (a 100 us launch
    in it), 500 us (a 200 us launch) and 400 us (no launch)."""
    return [
        Span("train.step", 0, 10 * MS, -1, 0),                # 0
        Span("train.optimizer", 1 * MS, 2 * MS, 0, 0),        # 1
        Span("train.backward", 2 * MS, 6 * MS, 0, 0),         # 2
        Span("op.pair_bwd", 3 * MS, 3 * MS + 300_000, 2, 0),  # 3
        Span("launch.pair_bwd", 3 * MS + 100_000,
             3 * MS + 200_000, 3, 0),                         # 4
        Span("train.optimizer", 7 * MS, 9 * MS, 0, 0),        # 5
        Span("train.step", 20 * MS, 34 * MS, -1, 1),          # 6
        Span("train.optimizer", 20 * MS, 21 * MS, 6, 1),      # 7
        Span("train.backward", 22 * MS, 28 * MS, 6, 1),       # 8
        Span("op.lem_bwd", 22 * MS, 22 * MS + 500_000, 8, 1),  # 9
        Span("launch.lem_bwd", 22 * MS, 22 * MS + 200_000, 9, 1),
        Span("op.lem_fwd", 29 * MS, 29 * MS + 400_000, 6, 1),
        Span("train.optimizer", 30 * MS, 33 * MS, 6, 1),
    ]


def requests():
    """Two requests: one of 20 ms (program 16 ms, answer 3 ms) and one
    chunked in two (programs 10 and 12 ms, answers 1 and 2 ms), its
    chunks nested under it with its id; op calls of 250 us with a 50 us
    launch and 150 us with a 100 us one."""
    return [
        Span("serve.rollout", 0, 20 * MS, -1, 5),             # 0
        Span("serve.program", 1 * MS, 17 * MS, 0, 5),         # 1
        Span("op.layer_fwd", 2 * MS, 2 * MS + 250_000, 1, 5),  # 2
        Span("launch.layer_fwd", 2 * MS + 100_000,
             2 * MS + 150_000, 2, 5),                         # 3
        Span("serve.answer", 17 * MS, 20 * MS, 0, 5),         # 4
        Span("serve.rollout", 30 * MS, 60 * MS, -1, 6),       # 5
        Span("serve.rollout", 30 * MS, 44 * MS, 5, 6),        # 6
        Span("serve.program", 31 * MS, 41 * MS, 6, 6),        # 7
        Span("serve.answer", 41 * MS, 42 * MS, 6, 6),         # 8
        Span("serve.rollout", 45 * MS, 60 * MS, 5, 6),        # 9
        Span("serve.program", 45 * MS, 57 * MS, 9, 6),        # 10
        Span("op.layer_fwd", 46 * MS, 46 * MS + 150_000, 10, 6),
        Span("launch.layer_fwd", 46 * MS, 46 * MS + 100_000, 11, 6),
        Span("serve.answer", 57 * MS, 59 * MS, 9, 6),
    ]


WANT = {
    "host_step_ms.train": 12.0,               # (10 + 14) / 2
    "host_backward_ms.train": 5.0,            # (4 + 6) / 2
    "host_optimizer_ms.train": 3.5,           # (1 + 2 + 1 + 3) / 2
    "op_host_us.train": 300.0,                # (200 + 300 + 400) / 3
    "host_program_ms.serve": 19.0,            # (16 + 10 + 12) / 2
    "host_wait_ms.serve": 3.0,                # (3 + 1 + 2) / 2
    "op_host_us.serve": 125.0,                # (200 + 50) / 2
}


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_reader_gives_its_mean(name, monkeypatch):
    made = steps() if name in TRAIN else requests()
    monkeypatch.setattr(tracing, "spans", lambda: made)
    assert harness.metric_reader(name)(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_reader_without_its_spans_gives_none(name, monkeypatch):
    other = requests() if name in TRAIN else steps()
    other = [s for s in other if not s.name.startswith(("op.", "launch."))]
    for made in ([], other):
        monkeypatch.setattr(tracing, "spans", lambda: made)
        assert harness.metric_reader(name)(None) is None


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_program_without_spans_gives_none(name, monkeypatch):
    import msmp_pde_torch

    monkeypatch.delattr(msmp_pde_torch, "tracing")
    monkeypatch.setitem(sys.modules, "msmp_pde_torch.tracing", None)
    assert harness.metric_reader(name)(None) is None


def test_an_open_span_is_left_out(monkeypatch):
    made = steps() + [Span("train.step", 40 * MS, None, -1, 2)]
    monkeypatch.setattr(tracing, "spans", lambda: made)
    assert harness.metric_reader("host_step_ms.train")(None) == \
        pytest.approx(12.0)


@pytest.mark.parametrize("cell,twin,names", [
    ("msmp_e1.train_b16", "host_enqueue_ms.train",
     ("host_step_ms.train",)),
    ("mppde_e1.serve_b64", "host_enqueue_ms.serve",
     ("host_program_ms.serve",)),
])
def test_a_traced_run_reports_the_spans(cell, twin, names):
    from test_port_bench_checks import run

    result, _ = run(cell, trace=True)
    metrics = result["metrics"]
    mine = [m["name"] for m in harness.cell(cell).per_layer
            if m["source"] == "program_span"]
    assert sorted(mine) == sorted(TRAIN if "train" in cell else SERVE)
    for m in mine:
        assert metrics[m]["value"] > 0, m
    for n in names:  # the program's span lies inside the benchmark's
        assert metrics[n]["value"] < metrics[twin]["value"]
