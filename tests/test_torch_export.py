"""PyTorch port, the AOT export of a rollout (serving/export.py) on the CPU,
float32, at nx 40 with one or two layers (the grid model FNO at its
widths):

* the exported artifact against the engine it came from
  (``RolloutEngine.rollout``) for MSMP-PDE, MP-PDE, SaveMSMP-PDE (its LEM
  state carried across windows and reset past nt - tw), MSMP-PDE2D (RP, a
  and b) and FNO, at 1e-6 relative (the same ops in the same order; they
  agree bitwise here), with the kernels' ops (``msmp::*``) in the graph of
  the graph models and none in FNO's;
* the port's artifact against the JAX ``export_rollout`` ->
  ``load_exported`` output for the same flax weights (``params_from_flax``),
  at tests/test_torch_serving.py's float32 bound (summation order only);
* the artifact replayed in a fresh process that imports
  ``msmp_pde_torch.ops`` (the op registrations) and no model, engine or
  trainer module, equal to the engine's rollout; a ``device`` at load time
  (``move_to_device_pass``);
* the engine's ``RolloutProgram`` is the loop the engine runs.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from msmp_pde_tpu.serving.engine import RolloutEngine as JEngine
from msmp_pde_tpu.serving.engine import build_serving_trainer as jbuild
from msmp_pde_tpu.serving.export import export_rollout as jexport
from msmp_pde_tpu.serving.export import load_exported as jload
from msmp_pde_torch.serving.engine import (
    RolloutEngine,
    RolloutProgram,
    build_serving_trainer,
)
from msmp_pde_torch.serving.export import export_rollout, load_exported
from msmp_pde_torch.utils.convert import params_from_flax

from _torch_helpers import np_tree, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parent.parent
RES = (250, 40)
B, S = 2, 3
# (experiment, model, layers): the families of the slice
MODELS = [("E1", "MSMP-PDE", 2), ("E1", "MP-PDE", 2),
          ("E1", "SaveMSMP-PDE", 1), ("RP", "MSMP-PDE2D", 1),
          ("E1", "FNO", 1)]
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


def _engine(experiment, model, layers, state=None):
    tr = build_serving_trainer(experiment, model, base_resolution=RES,
                               n_graph_layers=layers, device="cpu")
    return RolloutEngine(tr, state, batch_buckets=(B,))


def _inputs(engine, seed=0):
    tr = engine.trainer
    rng = np.random.default_rng(seed)
    window = rng.normal(size=(B, tr.spec.nx, tr.d * tr.tw)).astype(
        np.float32)
    # the second sample starts where the third window passes nt - tw
    steps = np.array([tr.tw, 200])
    var = {k: rng.uniform(0.2, 0.8, size=B).astype(np.float32)
           for k in tr.eq_norms}
    return window, steps, var


def _ops(exported):
    return set(re.findall(r"torch\.ops\.msmp\.(\w+)",
                          exported.graph_module.code))


@pytest.mark.parametrize("experiment,model,layers", MODELS)
def test_export_equals_the_engine(experiment, model, layers, tmp_path):
    engine = _engine(experiment, model, layers)
    window, steps, var = _inputs(engine)
    path = tmp_path / "rollout.pt2"
    blob = export_rollout(engine, B, S, path=str(path))
    assert path.read_bytes() == blob
    art = load_exported(str(path))
    got = art(window, steps, var)
    want = engine.rollout(window, var, start_step=steps, n_windows=S)
    assert got.shape == want.shape == (B, S, 40, engine.trainer.d * 25)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    ops = _ops(art.exported)
    if model == "FNO":
        assert not ops
    else:
        assert ops == ({"layer_fwd"} if model == "MP-PDE"
                       else {"lem_fwd", "pair_fwd"})


def test_stateful_export_resets_past_the_horizon():
    """SaveMSMP-PDE: the exported state reset is a ``where`` on the steps,
    so an artifact exported at one start serves any other."""
    engine = _engine("E1", "SaveMSMP-PDE", 1)
    art = load_exported(export_rollout(engine, B, S))
    assert "where" in art.exported.graph_module.code
    window, _, var = _inputs(engine, seed=1)
    for steps in ([25, 25], [25, 225], [180, 200]):
        np.testing.assert_allclose(
            art(window, steps, var),
            engine.rollout(window, var, start_step=steps, n_windows=S),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("experiment,model", [("E1", "MSMP-PDE"),
                                              ("E1", "MP-PDE")])
def test_export_equals_the_jax_export(experiment, model, tmp_path):
    jt = jbuild(experiment, model, base_resolution=RES, n_graph_layers=2)
    params = jt.init_params(jax.random.PRNGKey(0), batch_size=B)
    jart = jload(jexport(JEngine(jt, params, batch_buckets=(B,)), B, S))
    engine = _engine(experiment, model, 2,
                     params_from_flax(np_tree(params, np.float32)))
    window, steps, var = _inputs(engine, seed=2)
    got = load_exported(export_rollout(engine, B, S))(window, steps, var)
    want = jart(window, steps.astype(np.int32), var)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **JAX_TOL)


REPLAY = """
import json, sys
import numpy as np, torch
import msmp_pde_torch.ops  # the msmp ops
z = np.load(sys.argv[2])
prog = torch.export.load(sys.argv[1]).module()
with torch.no_grad():
    out = prog(torch.as_tensor(z["window"]), torch.as_tensor(z["steps"]), {})
np.save(sys.argv[3], out.numpy())
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("msmp_pde_torch"))))
"""


def test_replay_in_a_fresh_process_builds_no_model(tmp_path):
    engine = _engine("E1", "MSMP-PDE", 2)
    window, steps, _ = _inputs(engine, seed=3)
    export_rollout(engine, B, S, path=str(tmp_path / "r.pt2"))
    np.savez(tmp_path / "in.npz", window=window, steps=steps)
    run = subprocess.run(
        [sys.executable, "-c", REPLAY, str(tmp_path / "r.pt2"),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npy")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    mods = json.loads(run.stdout.strip().splitlines()[-1])
    assert "msmp_pde_torch.ops.library" in mods
    assert not [m for m in mods if m.startswith((
        "msmp_pde_torch.models.gnn", "msmp_pde_torch.models.registry",
        "msmp_pde_torch.serving", "msmp_pde_torch.training",
        "msmp_pde_torch.utils"))], mods
    np.testing.assert_allclose(
        np.load(tmp_path / "out.npy"),
        engine.rollout(window, start_step=steps, n_windows=S),
        rtol=1e-6, atol=1e-7)


def test_load_moves_to_a_device():
    engine = _engine("E1", "MP-PDE", 1)
    window, steps, var = _inputs(engine, seed=4)
    art = load_exported(export_rollout(engine, B, S), device="cpu")
    assert art.device == torch.device("cpu")
    np.testing.assert_allclose(
        art(window, steps, var),
        engine.rollout(window, var, start_step=steps, n_windows=S),
        rtol=1e-6, atol=1e-7)


def test_the_engine_runs_its_rollout_program():
    engine = _engine("E1", "MSMP-PDE", 1)
    window, steps, var = _inputs(engine, seed=5)
    prog = engine.program(S)
    assert isinstance(prog, RolloutProgram) and prog is engine.program(S)
    with torch.no_grad():
        direct = prog(torch.as_tensor(window), torch.as_tensor(steps), {})
    np.testing.assert_array_equal(
        direct.numpy(), engine.rollout(window, var, start_step=steps,
                                       n_windows=S))
