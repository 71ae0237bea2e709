"""Mean host milliseconds a request spends on its answer (the program's
``serve.answer`` spans, serving/engine.py, over the requests): the copy
to the host, which waits for the card to finish the windows, and the
concatenation."""
from benchmark import program_spans


def read(ctx):
    s = program_spans.per_root(program_spans.window_spans(),
                               "serve.answer", "serve.rollout")
    return None if s is None else 1e3 * s
