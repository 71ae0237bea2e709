"""Spans: named host ranges at the port's layer boundaries, recorded while
a torch.profiler session records and free otherwise.

``span(name, id=None)`` is a context manager. While no profiler records it
returns ``NOOP``, one shared do-nothing context, after reading one module
flag (``torch.autograd.profiler._is_profiler_enabled``, which the profiler
sets when it starts recording and clears when it stops). While one
records, a span

- opens a profiler range named ``name``, so that it lands in the
  profiler's trace beside the card's events (the train CLI's
  ``--profile`` chrome trace carries it). The range is
  ``torch._C._profiler._RecordFunctionFast``: a host event of the op
  kind, where ``torch.profiler.record_function`` records a user
  annotation through two dispatched ops of its own, at about a tenth of
  its host time (PERF.md section 6);
- records ``Span(name, start_ns, end_ns, parent, id)``, its ends read with
  ``time.time_ns()`` inside the range: the clock the profiler stamps its
  events with, so a span and its range agree to a few microseconds.

``parent`` is the index (in ``spans()``) of the innermost span open on the
span's thread; on a thread with none open, of the innermost span open in
the process. Autograd runs a CUDA backward on a thread of its own while
the caller waits in ``backward()``, so the backward's op spans sit under
the step's ``train.backward``. ``id`` groups the spans of one training
step or one request: ``NEW`` draws a fresh id unless an enclosing span has
one (a chunk of a request shares the request's), None takes the enclosing
span's, and any other value is kept as it is.

``spans()`` returns the records of the current or last profiler session.
A session ends for this module when a span or ``spans()`` finds no
profiler recording, so the spans of set-up, warm-up or an earlier session
never show in a later one's. A session keeps at most ``MAX_SPANS``
records; ``dropped()`` counts those past it (their ranges still reach the
trace). Nothing is written to disk.

The spans, by layer (PERF.md section 3): ``train.step`` (one optimizer
step, ``NEW`` id), ``train.pushforward``, ``train.loss``,
``train.backward``, ``train.optimizer`` (training/loop.py, the eager
step); ``train.replay`` around a replay and ``train.capture`` around a
capture of the graphed step, inside its ``train.step`` (training/loop.py::
GraphedStep, whose replayed kernels open no span on the host);
``serve.rollout`` (one request, ``NEW`` id), ``serve.program``,
``serve.answer`` (serving/engine.py); ``serve.replay`` around a replay,
inside its ``serve.program``, and ``serve.capture`` around a capture of a
graphed rollout (serving/engine.py::GraphedRollout, whose replayed
kernels open no span on the host); ``model.forward``
(``Trainer.forward``); ``op.<k>`` around each op call and ``launch.<k>``
around each kernel's C call, ``k`` one of pair_fwd, pair_bwd, layer_fwd,
layer_bwd, lem_fwd, lem_bwd (ops/); ``op.inverse_lists`` and
``op.build``, work that is done again (a missed memo of the inverse
neighbour lists, an in-process nvcc).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 18


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    parent: int            # index in spans() of the enclosing span, or -1
    id: object


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()
NEW = object()  # span(..., id=NEW): a fresh id unless an enclosing one has


class _Record:
    __slots__ = ("name", "start", "end", "parent", "id", "index", "session")

    def __init__(self, name, start, parent, id, index, session):
        self.name, self.start, self.parent, self.id = name, start, parent, id
        self.index, self.session = index, session
        self.end = None


class _State:
    """The current session's records; ``ended`` once a span or spans()
    found no profiler recording."""

    def __init__(self):
        self.session = 0
        self.records = []
        self.dropped = 0
        self.ended = True


_state = _State()
_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()
_stacks = {}  # thread id -> that thread's open records, innermost last


def _stack():
    try:
        return _local.stack
    except AttributeError:
        s = _local.stack = []
        _stacks[threading.get_ident()] = s
        return s


def _enclosing(stack):
    """The innermost open record of this session: the thread's own, else
    the latest opened among every thread's innermost."""
    if stack:
        top = stack[-1]
    else:
        tops = [s[-1] for s in list(_stacks.values()) if s]
        top = max(tops, key=lambda r: r.start) if tops else None
    return top if top is not None and top.session == _state.session \
        else None


def _open(name, id, start):
    stack = _stack()
    with _lock:
        st = _state
        if st.ended:
            st.session += 1
            st.records, st.dropped, st.ended = [], 0, False
        up = _enclosing(stack)
        if id is None or id is NEW:
            id = up.id if up is not None and up.id is not None else (
                next(_ids) if id is NEW else None)
        full = len(st.records) >= MAX_SPANS
        rec = _Record(name, start, -1 if up is None else up.index, id,
                      -1 if full else len(st.records), st.session)
        if full:
            st.dropped += 1
        else:
            st.records.append(rec)
    stack.append(rec)
    return rec


class _Span:
    __slots__ = ("name", "id", "range", "rec")

    def __init__(self, name, id):
        self.name, self.id = name, id

    def __enter__(self):
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.rec = _open(self.name, self.id, time.time_ns())
        return self

    def __exit__(self, *exc):
        self.rec.end = time.time_ns()
        _stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, id=None):
    """A span named ``name`` while a profiler records, else ``NOOP``."""
    if not _profiler._is_profiler_enabled:
        _state.ended = True
        return NOOP
    return _Span(name, id)


def spans():
    """The current or last session's spans, in the order they opened."""
    if not _profiler._is_profiler_enabled:
        _state.ended = True
    with _lock:
        recs = list(_state.records)
    return [Span(r.name, r.start, r.end, r.parent, r.id) for r in recs]


def dropped() -> int:
    """Spans of the current or last session past ``MAX_SPANS``."""
    return _state.dropped
