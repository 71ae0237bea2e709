"""BENCHMARK.json against the benchmark's contract, and every file that a
cell finds by its names."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_size():
    assert set(BENCH) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / w).exists()


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_allowed_and_unique(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs():
    keys = {"name", "source", "file", "reduced", "why"}
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == keys
        assert c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_workloads():
    keys = {"name", "config", "traffic", "chips", "why"}
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(BENCH["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == keys
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and one_line(w["why"])


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_end_to_end_metrics():
    keys = {"name", "unit", "better", "bound", "source"}
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        own = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in _cells_of(m)]
        assert "setup_s" in own and len(own) >= 2, w["name"]


def test_per_layer_metrics():
    keys = {"name", "unit", "better", "source", "layer", "moves"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in _cells_of(m):
            assert cell in _cells_of(e2e[m["moves"]]), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in BENCH["workloads"]:
        assert any(w["name"] in _cells_of(m) for m in BENCH["per_layer"])


def test_every_cell_finds_its_files():
    from benchmark import harness

    for w in BENCH["workloads"]:
        c = harness.cell(w["name"], BENCH)
        assert c.traffic["kind"] in ("train", "serve")
        assert c.kind.setup and c.kind.window and c.kind.check
        assert c.arch.n_params(c.config) == c.config["n_params"]
        assert set(c.limits) and all(
            isinstance(v, float) and math.isfinite(v) and v > 0
            for v in c.limits.values())
        for m in c.per_layer:
            assert callable(harness.metric_reader(m["name"]))
            if m["name"].endswith("_roofline"):
                counts = harness.counts_module(m["name"][:-len("_roofline")])
                assert counts.DEVICE_NAMES and counts.COUNTER


def test_files_are_named_from_names():
    allowed = re.compile(r"^[A-Za-z0-9_./-]+$")
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert allowed.match(str(p.relative_to(ROOT))), p
