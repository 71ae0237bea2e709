"""Mean host milliseconds a request spends in its ``RolloutProgram``
calls (the program's ``serve.program`` spans, serving/engine.py, over the
requests, ``serve.rollout`` ids): the time to enqueue its windows, the
copies of its inputs to the card left out. The in-program twin of
``host_enqueue_ms.serve``."""
from benchmark import program_spans


def read(ctx):
    s = program_spans.per_root(program_spans.window_spans(),
                               "serve.program", "serve.rollout")
    return None if s is None else 1e3 * s
