"""Mean host milliseconds from entering ``RolloutEngine.rollout`` to the
return of its ``RolloutProgram.forward``, before the copy to the host:
the time to enqueue a request's windows (benchmark/kinds/serve.py, span
``serve.enqueue``, from the traced run's wrapper)."""


def read(ctx):
    d = ctx.spans.durations("serve.enqueue")
    return 1e3 * sum(d) / len(d) if d else None
