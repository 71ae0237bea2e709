"""How the port captures a program as a CUDA graph and replays it, for the
training step (training/loop.py::GraphedStep) and the served rollout
(serving/engine.py::GraphedRollout).

``warm_up`` runs the program eagerly on the capture stream (the kernels'
builds, cuBLAS's workspace, cuDNN's and cuFFT's plans) and ``capture``
records one call of it into a graph; both leave the kernels' launch
counters (``ops.LAUNCH_COUNTERS``) as they found them, and ``capture``
returns the launches the captured call made, which ``replay`` adds on each
replay. The caller owns the rest: what the program reads and writes, its
static inputs, and the state a warm-up has to put back."""
from typing import Callable, Dict, Tuple

import torch

from msmp_pde_torch import ops, tracing


def warm_up(fn: Callable, stream: torch.cuda.Stream, n: int):
    """Calls ``fn()`` ``n`` times on ``stream``, after the work enqueued on
    the device's current stream and before any enqueued there later; the
    launch counters end where they began."""
    counts = ops.launch_counts()
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    try:
        with torch.cuda.stream(stream):
            for _ in range(n):
                fn()
    finally:
        main.wait_stream(stream)
        ops.set_launch_counts(counts)


def capture(fn: Callable, stream: torch.cuda.Stream, pool,
            what: str, hint: str = "") -> Tuple[torch.cuda.CUDAGraph,
                                                object, Dict[str, int]]:
    """Captures one call of ``fn()`` on ``stream`` into a new graph in the
    memory pool ``pool`` (another graph's ``pool()``, or None for a pool of
    its own). Returns (the graph, what the captured call returned, the
    launches it counted); the launch counters end where they began. Where
    the call cannot be captured, raises a RuntimeError that names ``what``
    and the cause, then ``hint``."""
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    # as torch.cuda.graph does: the warm-up's cached blocks go back
    torch.cuda.synchronize(stream.device)
    torch.cuda.empty_cache()
    try:
        # not torch.cuda.graph: where the capture fails, its context
        # leaves the side stream current
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
    except RuntimeError as e:
        raise RuntimeError(
            f"{what} cannot be captured as a CUDA graph ({e})"
            + (f". {hint}" if hint else "")) from e
    finally:
        after = ops.launch_counts()
        ops.set_launch_counts(before)
    return graph, out, {k: after[k] - before[k] for k in after}


def replay(graph: torch.cuda.CUDAGraph, deltas: Dict[str, int], span: str):
    """Replays ``graph`` on the current stream inside the span ``span``
    (tracing.py), then adds ``deltas`` (``capture``'s launches) to the
    launch counters."""
    with tracing.span(span):
        graph.replay()
    ops.set_launch_counts({k: n + deltas[k] for k, n in
                           ops.launch_counts().items()})
