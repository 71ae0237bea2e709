"""Mean host milliseconds of a training step's call over the traced
window: the step returns its loss unsynchronised, so this is the time to
enqueue the step (benchmark/kinds/train.py, span ``train.step``)."""


def read(ctx):
    d = ctx.spans.durations("train.step")
    return 1e3 * sum(d) / len(d) if d else None
