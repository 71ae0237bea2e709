"""Each cell of BENCHMARK.json end to end on a CUDA card, as its command
runs it (a short window, untraced and traced): exit code 0, one JSON
result line, ``correct`` true, the cell's metrics. Skipped without a
card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import harness

    c = harness.cell(cell)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 33 + 17), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    want = c.per_layer if trace else c.end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in want}
    assert result["device"]["platform"] == "gpu"
