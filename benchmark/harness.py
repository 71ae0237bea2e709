"""What every cell shares: finding its files by the names in
BENCHMARK.json, the run (set-up, window, check), and the result line.

A cell is a workload of BENCHMARK.json: a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<traffic>.json``,
whose ``kind`` names the code that runs it, ``kinds/<kind>.py``) and its
correctness limits (``limits/<workload>.json``). A per-layer metric is
``metrics/<name>.py`` (its ``read(ctx)`` returns a number, or None where
the window held nothing to read), a kernel's work ``counts/<kernel>.py``,
an architecture's plain reference ``reference/<arch>.py``. A later change
adds a cell, a mix, a metric or a kernel's count by adding files only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FOREIGN = ("jax", "jaxlib", "flax", "msmp_pde_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest():
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def kind(self):
        return kind_module(self.traffic["kind"])

    @property
    def arch(self):
        return importlib.import_module(
            f"benchmark.reference.{self.config['arch']}")


def _for_cell(metrics, name):
    return [m for m in metrics if name in m.get("workloads", [name])]


def cell(name: str, bench=None) -> Cell:
    bench = bench or manifest()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT / configs[w["config"]]["file"])
    return Cell(name=name, chips=int(w["chips"]), config=cfg,
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def kind_module(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


def counts_module(kernel: str):
    return importlib.import_module(f"benchmark.counts.{kernel}")


def metric_reader(name: str):
    """``read`` of metrics/<name>.py (a name may hold dots, so the file is
    loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(on: bool, name: str):
    """A profiler range named ``name`` in a traced run (it names the
    device's idle gaps, benchmark/trace.py), else nothing."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


class Spans:
    """Host-clock spans of the benchmark's own: name -> [(start, end)] in
    perf_counter seconds."""

    def __init__(self):
        self.spans = {}

    def add(self, name, start, end):
        self.spans.setdefault(name, []).append((start, end))

    def durations(self, name):
        return [b - a for a, b in self.spans.get(name, [])]


class Counters:
    """The program's launch counters (module globals of its op modules):
    their values at ``open`` and at ``close``."""

    def __init__(self, names):
        self.names = names
        self.before = self.after = None

    def _read(self):
        return {(m, a): getattr(importlib.import_module(m), a)
                for m, a in self.names}

    def open(self):
        self.before = self._read()

    def close(self):
        self.after = self._read()

    def delta(self, module, attr):
        key = (module, attr)
        return self.after[key] - self.before[key]


COUNTED = (("msmp_pde_torch.ops.mp_pair", "launches"),
           ("msmp_pde_torch.ops.mp_pair", "bwd_launches"),
           ("msmp_pde_torch.ops.mp_layer", "launches"),
           ("msmp_pde_torch.ops.mp_layer", "bwd_launches"),
           ("msmp_pde_torch.ops.lem_scan", "launches"),
           ("msmp_pde_torch.ops.lem_scan", "bwd_launches"))


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader gets: the cell, the window's
    record (``win``, the kind's), the spans, the program's counters and
    the trace."""

    cell: Cell
    win: dict
    spans: Spans
    counters: Counters
    trace: object

    def kernel_share(self, kernel: str):
        """100 x the least time of one call of ``kernel`` (its
        counts/<kernel>.py ``work`` at the cell's shape, over the peaks of
        roofline.py) over its mean device time a call in the trace; None
        where the window ran no such call."""
        from benchmark import roofline

        counts = counts_module(kernel)
        calls = self.counters.delta(*counts.COUNTER)
        secs = self.trace.seconds_of(counts.DEVICE_NAMES)
        if calls <= 0 or secs <= 0:
            return None
        bound = roofline.bound_s(*counts.work(self.win["shape"]))
        return 100.0 * bound / (secs / calls)


def run(c: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, plant=None):
    """Set-up, the window and the check of one run: (result dict, the
    numbers compared). ``plant(state)``, for the tests of the check,
    breaks the program after set-up builds it."""
    import torch

    from benchmark import trace as tracing

    torch.backends.cuda.matmul.allow_tf32 = bool(c.config["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(c.config["cudnn_allow_tf32"])
    kind = c.kind
    state = kind.setup(c, seed, device, plant)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for what, t in state["stamps"]:
        print(f"set-up: {what} at {t - t_start:.3f} s", file=sys.stderr)
    # what set-up made lives for the whole run: the collector need not
    # walk it again in the window
    gc.collect()
    gc.freeze()
    spans, counters = Spans(), Counters(COUNTED)
    prof = tracing.start() if trace else None
    setup_s = time.perf_counter() - t_start
    counters.open()
    with span(trace, tracing.WINDOW):
        win = kind.window(state, min(seconds, c.traffic["trace_seconds"])
                          if trace else seconds, spans, trace)
    counters.close()
    gc.unfreeze()
    traced = None
    if prof is not None:
        prof.stop()
        traced = tracing.Trace(prof)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    numbers = kind.check(state, win)
    failed = int(win["failed"])
    correct = failed == 0 and all(
        math.isfinite(numbers[k]) and numbers[k] <= c.limits[k]
        for k in c.limits)
    if trace:
        ctx = Context(c, win, spans, counters, traced)
        metrics = {}
        for m in c.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(win["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in c.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": c.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = {k: {"value": numbers[k], "limit": c.limits[k]}
                        for k in c.limits}
    return result, numbers


def build_kernels():
    """Builds every stale kernel library at once, one nvcc each, started
    together (msmp_pde_torch/ops/_build.py): a checkout's first run pays
    for it, later runs find the libraries built."""
    from msmp_pde_torch.ops import _build

    if any(_build._stale(n) for n in _build.SOURCES):
        _build.build_all()


def foreign_modules():
    """The loaded modules whose top-level name is one the benchmark may
    not hold: JAX, its libraries and the JAX package."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def emit(result):
    """The numbers compared, each beside its limit, as the last lines of
    standard error; then the result as the last line of standard output."""
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
