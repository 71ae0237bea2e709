"""Percent of a serving window's program calls that ran as a replay of a
CUDA graph: 100 x the closed ``serve.replay`` spans over the closed
``serve.program`` spans (serving/engine.py). None without a
``serve.program`` span."""
from benchmark import program_spans


def read(ctx):
    closed = [s.name for s in program_spans.window_spans()
              if s.end_ns is not None]
    programs = closed.count("serve.program")
    if not programs:
        return None
    return 100.0 * closed.count("serve.replay") / programs
