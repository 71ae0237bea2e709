"""Mean host milliseconds of a training step in the traced window, from
the program's own ``train.step`` span (training/loop.py): the step returns
its loss unsynchronised, so this is the time to enqueue it. The
in-program twin of ``host_enqueue_ms.train``."""
from benchmark import program_spans


def read(ctx):
    s = program_spans.per_root(program_spans.window_spans(), "train.step",
                               "train.step")
    return None if s is None else 1e3 * s
