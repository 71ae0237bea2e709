"""Mean host milliseconds a training step spends in the optimizer (the
program's two ``train.optimizer`` spans a step, training/loop.py:
``zero_grad``, then AdamW's step and the schedule's)."""
from benchmark import program_spans


def read(ctx):
    s = program_spans.per_root(program_spans.window_spans(),
                               "train.optimizer", "train.step")
    return None if s is None else 1e3 * s
