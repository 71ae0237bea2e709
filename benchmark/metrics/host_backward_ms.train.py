"""Mean host milliseconds a training step spends in ``loss.backward()``
(the program's ``train.backward`` span, training/loop.py): autograd's
walk, the backward op calls and their launches."""
from benchmark import program_spans


def read(ctx):
    s = program_spans.per_root(program_spans.window_spans(),
                               "train.backward", "train.step")
    return None if s is None else 1e3 * s
