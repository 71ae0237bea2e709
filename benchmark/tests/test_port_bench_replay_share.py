"""The reader of ``graph_replay_share.serve`` (benchmark/metrics/) on
made-up spans: 100 x the closed ``serve.replay`` spans over the closed
``serve.program`` spans, and None where the window holds no
``serve.program`` span or the program has no spans at all. The metric is
not listed in BENCHMARK.json yet, so no run reports it."""
import sys

import pytest

from benchmark import harness
from msmp_pde_torch import tracing
from msmp_pde_torch.tracing import Span

MS = 1_000_000  # ns
NAME = "graph_replay_share.serve"


def requests(replayed):
    """Three requests, each one program call; the first ``replayed`` of
    them hold a ``serve.replay`` in their ``serve.program``; one more
    program call and its replay are still open."""
    spans = []
    for r in range(3):
        at = 20 * MS * r
        spans.append(Span("serve.rollout", at, at + 18 * MS, -1, r))
        spans.append(Span("serve.program", at + MS, at + 2 * MS,
                          len(spans) - 1, r))
        if r < replayed:
            spans.append(Span("serve.replay", at + MS, at + 2 * MS,
                              len(spans) - 1, r))
        spans.append(Span("serve.answer", at + 2 * MS, at + 18 * MS,
                          len(spans) - 2 - (r < replayed), r))
    spans.append(Span("serve.rollout", 60 * MS, None, -1, 3))
    spans.append(Span("serve.program", 61 * MS, None, len(spans) - 1, 3))
    spans.append(Span("serve.replay", 61 * MS, None, len(spans) - 1, 3))
    return spans


@pytest.mark.parametrize("replayed,want", [(3, 100.0), (2, 200.0 / 3),
                                           (0, 0.0)])
def test_the_reader_gives_the_replayed_share(replayed, want, monkeypatch):
    made = requests(replayed)
    monkeypatch.setattr(tracing, "spans", lambda: made)
    assert harness.metric_reader(NAME)(None) == pytest.approx(want)


def test_without_program_spans_the_reader_gives_none(monkeypatch):
    steps = [Span("train.step", 0, 10 * MS, -1, 0),
             Span("train.replay", MS, 2 * MS, 0, 0)]
    for made in ([], steps):
        monkeypatch.setattr(tracing, "spans", lambda: made)
        assert harness.metric_reader(NAME)(None) is None


def test_a_program_without_spans_gives_none(monkeypatch):
    import msmp_pde_torch

    monkeypatch.delattr(msmp_pde_torch, "tracing")
    monkeypatch.setitem(sys.modules, "msmp_pde_torch.tracing", None)
    assert harness.metric_reader(NAME)(None) is None

