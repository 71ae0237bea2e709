"""Mean host microseconds of an op call in the serving window outside
its kernel's C call: each ``op.<k>`` span less its ``launch.<k>`` child
(dispatch, checks, workspace, pointer arrays), over the number of op
calls."""
from benchmark import program_spans


def read(ctx):
    s = program_spans.op_host(program_spans.window_spans())
    return None if s is None else 1e6 * s
