"""The check that decides ``correct``, driven through a whole run on the
CPU (the plain versions of the program, the published widths with two
layers, a small batch), with the look for a card skipped: a sound run is
correct; the control (the plain reference with TF32 products in the
program's place) and every fault of benchmark/faults.py that the cell can
have are not."""
import dataclasses
import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.kinds import serve, train
from benchmark.reference.mpsolver import Precision

SMALL = {
    "msmp_e1.train_b16": dict(trajectories=16, batch=4, warmup_steps=4,
                              trace_seconds=0.5),
    "mppde_e1.serve_b64": dict(pool=8, members=4, buckets=[1, 4],
                               n_windows=3, warmup_requests=1,
                               checked_requests=3, trace_seconds=0.5),
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small(name):
    c = harness.cell(name)
    return dataclasses.replace(c, config=dict(c.config, layers=2),
                               traffic=dict(c.traffic, **SMALL[name]))


def run(name, plant=None, trace=False, seed=2 ** 40 + 7):
    return harness.run(small(name), seed, 0.5, trace, "cpu",
                       time.perf_counter(), plant)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(name, trace):
    result, numbers = run(name, trace=trace)
    assert result["correct"], numbers
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


CASES = ([("msmp_e1.train_b16", f) for f in faults.TRAIN]
         + [("mppde_e1.serve_b64", f) for f in faults.SERVE])


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f}" for n, f in CASES])
def test_a_fault_is_not_correct(name, fault):
    plant = (faults.TRAIN if name.startswith("msmp") else faults.SERVE)[fault]
    result, numbers = run(name, plant)
    assert not result["correct"], numbers


def test_the_training_control_is_not_correct():
    """At all six pairs (two leave TF32's error too small to read), batch
    4, the reference's check steps in float32 and with TF32 products."""
    import numpy as np

    from benchmark import traffic

    c = harness.cell("msmp_e1.train_b16")
    cfg, arch = c.config, c.arch
    u = traffic.smooth(16, arch.time_grid(cfg, "cpu"),
                       arch.Graph(cfg, "cpu").x, cfg["L"],
                       traffic.generator(11, "data", "cpu"))
    feed = traffic.TrainFeed(16, 4, cfg["nt"], cfg["tw"], 1, 1,
                             np.random.default_rng(3), "cpu")
    rows = [(u[idx], st, f) for idx, st, f in
            (feed.next() for _ in range(3))]
    state = {"cell": c, "device": "cpu", "rows": rows,
             "weights": arch.make_weights(
                 cfg, traffic.generator(11, "weights", "cpu"), "cpu")}
    ref = train.reference_readings(state)
    ctrl = train.numbers(train.reference_readings(state, "tf32"), ref)
    assert any(ctrl[k] > c.limits[k] for k in c.limits), ctrl


def test_the_serving_control_is_not_correct():
    c = small("mppde_e1.serve_b64")
    cfg, tr, arch = c.config, c.traffic, c.arch
    state = serve.setup(c, 11, "cpu")
    graph, t_grid = arch.Graph(cfg, "cpu"), arch.time_grid(cfg, "cpu")
    inputs = state["pool"][:tr["members"]]
    with torch.no_grad():
        ans = serve.control_answers(arch, cfg, state["weights"], graph,
                                    t_grid, inputs, tr["n_windows"],
                                    tr["start_step"], Precision("tf32"))
        gap = serve.window_gaps(arch, cfg, state["weights"], graph, t_grid,
                                inputs, ans, tr["start_step"], Precision())
    assert gap > c.limits["window_gap"]
