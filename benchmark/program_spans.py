"""The port's own spans of a traced window (msmp_pde_torch/tracing.py),
for the readers of the ``program_span`` metrics.

The harness starts torch.profiler just before the window and stops it
just after, so the spans of the program's last profiler session are the
window's. Every function returns None where there is nothing to read: a
program without spans (a checkout from before them) or a window without
the span asked for.
"""
from __future__ import annotations

# the six op calls: span op.<k> around the call, launch.<k> around its
# kernel's C call within it
OPS = ("pair_fwd", "pair_bwd", "layer_fwd", "layer_bwd", "lem_fwd",
       "lem_bwd")


def window_spans():
    """The program's spans of the traced window; [] without them."""
    try:
        from msmp_pde_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def _seconds(s):
    return (s.end_ns - s.start_ns) * 1e-9


def per_root(spans, name, root):
    """Seconds of the closed ``name`` spans over the number of distinct
    ids of the ``root`` spans (steps, or requests: a chunked request's
    chunks share its id); None where either is missing."""
    roots = {s.id for s in spans if s.name == root and s.end_ns is not None}
    d = [_seconds(s) for s in spans
         if s.name == name and s.end_ns is not None]
    return sum(d) / len(roots) if roots and d else None


def op_host(spans):
    """Mean host seconds an op call spends outside its kernel's C call:
    the sum over the closed op.<k> spans of each one's time less that of
    its launch.<k> children, over their number; None without one."""
    ops = {"op." + k: "launch." + k for k in OPS}
    own = {}
    for i, s in enumerate(spans):
        if s.name in ops and s.end_ns is not None:
            own[i] = _seconds(s)
    for s in spans:
        if s.parent in own and s.end_ns is not None \
                and s.name == ops[spans[s.parent].name]:
            own[s.parent] -= _seconds(s)
    return sum(own.values()) / len(own) if own else None
