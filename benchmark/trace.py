"""The traced run: torch.profiler over the window, read back from its raw
(kineto) events without the profiler's own summary, which takes seconds
for every few steps.

- ``kernel_seconds``: device seconds and launches per kernel name (a
  frozen copy of msmp_pde_torch/tools/lem_times.py ``kernels_us``,
  reading the same events one by one, and ``short`` for the names).
- ``union_s``: the seconds in which any operation ran on the device, the
  union of the kernels', copies' and fills' intervals (two overlapping
  kernels count once).
- ``idle_gaps``: the device's idle intervals inside the window, each named
  by the innermost host range (an op, or a span of the benchmark) that was
  open at its middle: what the host was doing while the card waited.
"""
from __future__ import annotations

import heapq
import re
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def short(name: str) -> str:
    """A kernel's name without ``void``, its parameter list and the
    namespaces of every name in it (its template arguments stay), cut to
    120 characters."""
    name = name.removeprefix("void ").strip()
    if name.endswith(")"):  # the parameter list is the last (...) group
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.replace("(anonymous namespace)::", "")
    return re.sub(r"\b[A-Za-z_]\w*::", "", name).strip()[:120]


def _activity(e, cuda):
    """An event's kineto activity: ``activity_type()`` where torch has it;
    before it (torch 2.11), a device event that is not a user annotation
    counts as a kernel, a host one as an op. A user annotation's mirror on
    the device timeline is left out by its name (``events``)."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    user = e.is_user_annotation()
    if e.device_type() == cuda:
        return "gpu_user_annotation" if user else "kernel"
    return "user_annotation" if user else "cpu_op"


def events(prof):
    """(window [t0, t1] ns, device [(start, end, name)], host [(start, end,
    name)]) of a stopped profile; the window is the benchmark's
    ``bench.window`` range."""
    from torch.autograd import DeviceType

    device, host, window, annotations = [], [], None, set()
    for e in prof.profiler.kineto_results.events():
        kind = _activity(e, DeviceType.CUDA)
        s, d = e.start_ns(), e.duration_ns()
        if kind in DEVICE_ACTIVITIES:
            device.append((s, s + d, e.name()))
        elif kind in HOST_ACTIVITIES:
            if e.name() == WINDOW:
                window = (s, s + d)
            if kind == "user_annotation":
                annotations.add(e.name())
            host.append((s, s + d, e.name()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    lo, hi = window
    device = sorted((max(s, lo), min(t, hi), n) for s, t, n in device
                    if t > lo and s < hi and n not in annotations)
    return window, device, host


def kernel_seconds(device):
    """{short name: [device seconds, launches]}, the busiest first."""
    out = defaultdict(lambda: [0.0, 0])
    for s, t, n in device:
        rec = out[short(n)]
        rec[0] += (t - s) * 1e-9
        rec[1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def busy_intervals(device):
    """The union of the device intervals, merged, in order."""
    merged = []
    for s, t, _ in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def union_s(device) -> float:
    return sum(t - s for s, t in busy_intervals(device)) * 1e-9


def idle_gaps(window, device, host):
    """{host name: idle seconds}, the longest first: each idle interval of
    the device inside the window, named by the innermost host range open
    at its middle (the open range that started last)."""
    lo, hi = window
    gaps, cur = [], lo
    for s, t in busy_intervals(device):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    ranges = sorted(host)
    out = defaultdict(float)
    heap, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while i < len(ranges) and ranges[i][0] <= mid:
            s, t, n = ranges[i]
            heapq.heappush(heap, (-s, t, n))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "(no host range)"] += (b - a) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


class Trace:
    """What the readers of the per-layer metrics take from a traced
    window: ``window_s``, ``busy_s``, ``kernels`` (``kernel_seconds``),
    ``gaps`` (``idle_gaps``)."""

    def __init__(self, prof):
        window, device, host = events(prof)
        self.window_s = (window[1] - window[0]) * 1e-9
        self.busy_s = union_s(device)
        self.kernels = kernel_seconds(device)
        self.gaps = idle_gaps(window, device, host)

    def seconds_of(self, names):
        """The device seconds of the kernels whose short name starts with
        one of ``names``."""
        return sum(s for k, (s, _) in self.kernels.items()
                   if k.startswith(tuple(names)))

    def breakdown(self, top=10):
        return {"device_ops": [[k, v[0]] for k, v in
                               list(self.kernels.items())[:top]],
                "idle_gaps": [[k, v] for k, v in
                              list(self.gaps.items())[:top]]}
