"""PyTorch port, data parallelism (parallel/mesh.py, training/loop.py,
training/train.py, training/metrics.py, datagen/generate.py with
temporal/erk.py, serving/engine.py) on the CPU: two gloo ranks
(tests/_torch_ddp_worker.py, started as torchrun would, each with a
timeout) against one process, float64, MSMP-PDE of hidden 96 with two
gated pairs on nx 24 (tests/test_torch_train.py's):

* a step's loss and every parameter's gradient (not the parameters after
  AdamW, which would hide a uniform factor) at unrolled 0 and 1: 1e-12
  against one process, and 1e-8 against the JAX single-device step
  (``_one_step``'s gradient, the first Adam moment / (1 - b1));
* the metrics (L2 norms, one-step and unrolled losses, rollout store with
  a window past the horizon) over 5 trajectories in batches of 2, the
  short last batch included: bitwise, each batch's value computed whole
  on one rank;
* a CE chunk of 4 samples of datagen (E2's coefficient ranges, DOPRI45
  with the adaptive error's maxima all-reduced): bitwise; KS datagen
  (tests/test_torch_ks.py's, 6 samples, the ranks' rows gathered, rank 0
  writing): every array of its file bitwise;
* a short ``fit`` (60 steps, its metrics, best-val checkpoint): every
  number it prints and every checkpointed tensor at 1e-8, but the layers'
  last biases at lr * 1e-3 (their gradient is roundoff, which AdamW turns
  into steps; tests/test_torch_train.py says why); rank 1 prints nothing;
* the stall watchdog's action in a group: exit status 75, saying so;
* the engine over the device list ["cpu", "cpu"] against one device: a
  bucket of 4 split 2 + 2, bitwise;
* ``--dp`` and batch checks, and the rows a rank takes.
"""
import json
import os
import re
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_torch.datagen import generate
from msmp_pde_torch.equations import CE
from msmp_pde_torch.parallel import mesh
from msmp_pde_torch.serving import serve
from msmp_pde_torch.serving.engine import RolloutEngine
from msmp_pde_torch.training import metrics, train
from msmp_pde_torch.utils.checkpoint import restore_checkpoint

import _torch_ddp_worker as worker
from _torch_helpers import one_thread  # noqa: F401
from test_torch_train import TOL, _leaf, _trainers

pytestmark = pytest.mark.usefixtures("one_thread")

TW, NT = 20, 60
RANK_TIMEOUT = 420  # seconds a rank may take
DATAGEN = dict(kind="datagen", tmax=0.4, grid=[25, 40], chunk=4, seed=3)
TOL12 = dict(rtol=1e-12, atol=1e-12)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tasks, out: Path, world: int = 2):
    """Start ``world`` worker ranks on ``tasks``; [(status, stdout,
    stderr)] a rank, each killed after RANK_TIMEOUT seconds."""
    out.mkdir(parents=True, exist_ok=True)
    path = out / "tasks.json"
    path.write_text(json.dumps(tasks))
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, worker.__file__, str(path), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    res = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=RANK_TIMEOUT)
            res.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _batches(rng, n, unrolled):
    return (rng.permutation(n)[:2],
            rng.integers(TW, NT - TW * (unrolled + 1) + 1, size=2))


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """The inputs, and what two ranks made of them: {task: npz}."""
    d = tmp_path_factory.mktemp("ddp")
    jtr, params, trainer = _trainers(TW, NT)
    torch.save(trainer.model.state_dict(), d / "state.pt")
    rng = np.random.default_rng(7)
    data = {"u": rng.normal(size=(4, NT, worker.NX)) * 0.5}
    for unrolled in (0, 1):
        data[f"idx{unrolled}"], data[f"steps{unrolled}"] = _batches(
            rng, 4, unrolled)
    data["mu"] = rng.normal(size=(5, NT, worker.NX)) * 0.5
    data["mub"] = data["mu"] + rng.normal(size=data["mu"].shape) * 0.01
    for m in ("train", "valid", "test"):
        data[f"{m}_u"] = rng.normal(size=(2, NT, worker.NX)) * 0.5
        data[f"{m}_ub"] = rng.normal(size=(2, NT, worker.NX)) * 0.5
    np.savez(d / "data.npz", **data)
    np.savez(d / "metrics.npz", u=data["mu"], ub=data["mub"])
    common = dict(tw=TW, nt=NT, state=str(d / "state.pt"))
    tasks = [dict(kind="step", data=str(d / "data.npz"), unrolled=[0, 1],
                  **common),
             dict(kind="metrics", data=str(d / "metrics.npz"), batch_size=2,
                  **common),
             DATAGEN, dict(kind="ks"),
             dict(kind="fit", data=str(d / "data.npz"), **common)]
    out = d / "out"
    for r, (status, o, e) in enumerate(run_ranks(tasks, out)):
        assert status == 0, f"rank {r}: status {status}\n{o}\n{e[-3000:]}"
    got = {t["kind"]: dict(np.load(out / f"{t['kind']}.npz")) for t in tasks}
    return types.SimpleNamespace(dir=d, out=out, data=data, jtr=jtr,
                                 params=params, got=got, **common)


def _fresh(ranked):
    return worker.port_trainer(TW, NT, state=torch.load(
        ranked.state, weights_only=True))


@pytest.mark.parametrize("unrolled", [0, 1])
def test_step_gradients_equal_one_process(ranked, unrolled):
    trainer = _fresh(ranked)
    step = trainer.train_step_fn(trainer.make_optimizer(1e-3, 0.4, [1, 2], 1),
                                 unrolled)
    z = ranked.data
    loss = step(torch.as_tensor(z["u"]), {},
                torch.as_tensor(z[f"idx{unrolled}"]),
                torch.as_tensor(z[f"steps{unrolled}"]))
    got = ranked.got["step"]
    np.testing.assert_allclose(got[f"loss{unrolled}"], loss.numpy(), **TOL12)
    names = [n for n, _ in trainer.model.named_parameters()]
    assert names and all(f"grad{unrolled}/{n}" in got for n in names)
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(got[f"grad{unrolled}/{name}"],
                                   p.grad.numpy(), err_msg=name, **TOL12)


@pytest.mark.parametrize("unrolled", [0, 1])
def test_step_gradients_match_the_jax_step(ranked, unrolled):
    jtr, params, z = ranked.jtr, ranked.params, ranked.data
    tx = jtr.make_optimizer(1e-3, 0.4, [1, 2], 1)
    _, opt_state, jloss = jtr.train_step_fn(tx, unrolled)(
        params, tx.init(params), jnp.asarray(z["u"]), {},
        jnp.asarray(z[f"idx{unrolled}"]), jnp.asarray(z[f"steps{unrolled}"]))
    got = ranked.got["step"]
    np.testing.assert_allclose(got[f"loss{unrolled}"], float(jloss), **TOL)
    mu = opt_state[0].mu  # (1 - b1) * grad after one step
    for name, _ in _fresh(ranked).model.named_parameters():
        np.testing.assert_allclose(got[f"grad{unrolled}/{name}"],
                                   _leaf(mu, name) / 0.1, err_msg=name,
                                   **TOL)


def test_metrics_equal_one_process(ranked):
    trainer = _fresh(ranked)
    u, ub = torch.as_tensor(ranked.data["mu"]), torch.as_tensor(
        ranked.data["mub"])
    quiet = lambda *a, **k: None  # noqa: E731
    steps = metrics.test_timestep_losses(trainer, u, {}, 2, NT, log=quiet)
    want = {
        "l2": np.array(metrics.compute_l2_norms(trainer, u, {}, 2, 1, NT,
                                                log=quiet)),
        "timestep": np.array([steps[k] for k in sorted(steps)]),
        "unrolled": np.array(metrics.test_unrolled_losses(
            trainer, u, ub, {}, 2, 1, NT, worker.NX, log=quiet))}
    want["preds"], want["trues"] = metrics.rollout_store(
        trainer, u, {}, 2, 1, NT, n_more_rollout=1)
    got = ranked.got["metrics"]
    assert got["preds"].shape == (5, 3 * TW, 1, worker.NX)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_datagen_chunk_bitwise(ranked):
    pde = CE(tmin=0.0, tmax=DATAGEN["tmax"], grid_size=tuple(DATAGEN["grid"]))
    draws = generate.draw_chunk(np.random.default_rng(DATAGEN["seed"]),
                                DATAGEN["chunk"], 2, (1.0, 1.0), (0.0, 0.2),
                                (0.0, 0.0), pde)
    want = generate.ce_solver(pde, torch.float64, "cpu")(
        *[torch.as_tensor(a, dtype=torch.float64) for a in draws])
    got = ranked.got["datagen"]["traj"]
    assert got.shape == (4, 25, 1, 40) and np.isfinite(got).all()
    assert len(np.unique(draws[1])) == 2  # two beta groups
    np.testing.assert_array_equal(got, want.numpy())


def test_ks_datagen_files_bitwise(ranked, tmp_path):
    from msmp_pde_torch.datagen.hdf5_io import open_dataset

    generate.generate_ks(worker.ks_args(tmp_path), 5.0, 0.01,
                         resolutions=worker.KS_RES)
    with open_dataset(str(tmp_path / "KS_KS.npz")) as want, \
            open_dataset(str(ranked.out / "ks" / "KS_KS.npz")) as got:
        for mode, k in worker.KS_SAMPLES.items():
            for nt, nx in worker.KS_RES:
                name = f"{mode}/pde_{nt}-{nx}"
                u = got.array(name)
                assert u.shape == (k, nt, nx) and np.isfinite(u).all()
                np.testing.assert_array_equal(u, want.array(name))


def _numbers(text):
    return [float(x) for x in re.findall(
        r"-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+e[-+]?\d+", text)]


def test_fit_prints_and_checkpoint_equal_one_process(ranked, tmp_path,
                                                     capsys):
    z = ranked.data
    data = {m: (torch.as_tensor(z[f"{m}_u"]), torch.as_tensor(z[f"{m}_ub"]),
                {}) for m in ("train", "valid", "test")}
    trainer = _fresh(ranked)
    capsys.readouterr()
    want = train.fit(worker.fit_args(base_resolution=[NT, worker.NX]),
                     types.SimpleNamespace(trainer=trainer, t_res=NT), data,
                     str(tmp_path / "fit.pt"))
    printed = capsys.readouterr().out
    got_text = (ranked.out / "fit.txt").read_text()
    assert got_text.startswith("Data parallelism over 2 processes")
    lines = [ln for ln in got_text.splitlines()
             if not ln.startswith(("Data parallelism", "Saved model"))]
    want_lines = [ln for ln in printed.splitlines()
                  if not ln.startswith("Saved model")]
    assert len(lines) == len(want_lines)
    for a, b in zip(lines, want_lines):
        assert re.sub(r"[-\d.e+]+", "#", a) == re.sub(r"[-\d.e+]+", "#", b)
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=1e-8,
                                   err_msg=a)
    for k, v in ranked.got["fit"].items():
        np.testing.assert_allclose(v, want[k], rtol=1e-8, err_msg=k)
    mine = _fresh(ranked)
    epoch = restore_checkpoint(str(ranked.out / "fit.pt"), mine.model)
    assert epoch == 0
    for name, p in mine.model.named_parameters():
        atol = 1e-3 * 1e-3 if name.endswith("TorchDense_2.bias") else 1e-8
        np.testing.assert_allclose(p.detach().numpy(),
                                   dict(trainer.model.named_parameters())[
                                       name].detach().numpy(),
                                   rtol=1e-8, atol=atol, err_msg=name)


def test_watchdog_exits_the_group(tmp_path):
    res = run_ranks([dict(kind="watchdog")], tmp_path)
    for status, _, err in res:
        assert status == 75, err[-2000:]
        assert "cannot be re-exec'd into its group" in err


def test_engine_device_list_equals_one_device():
    trainer = worker.port_trainer(TW, NT, dtype=torch.float32)
    one = RolloutEngine(trainer, batch_buckets=(1, 4))
    two = RolloutEngine(trainer, batch_buckets=(1, 4),
                        devices=["cpu", "cpu"])
    assert [str(d) for d in two.devices] == ["cpu", "cpu"]
    assert two.replicas[0] is two.trainer
    rng = np.random.default_rng(3)
    for B in (1, 3, 4):
        window = rng.normal(size=(B, worker.NX, TW)).astype(np.float32)
        steps = rng.integers(TW, NT, size=B)
        a = one.rollout(window, start_step=steps, n_windows=3)
        b = two.rollout(window, start_step=steps, n_windows=3)
        assert a.shape == (B, 3, worker.NX, TW)
        np.testing.assert_array_equal(a, b)
    assert set(two._programs) == {(3, 0), (3, 1)}  # 4 split in two


def test_dp_checks_and_the_rows_of_a_rank():
    assert not mesh.active() and mesh.world_size() == 1
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train.check_dp(types.SimpleNamespace(dp=2, batch_size=4))
    train.check_dp(types.SimpleNamespace(dp=0, batch_size=3))
    train.check_dp(types.SimpleNamespace(dp=1, batch_size=3))
    bounds = [mesh.shard_bounds(5, r, 2) for r in range(2)]
    assert bounds == [(0, 3), (3, 5)]
    assert [mesh.shard_bounds(8, r, 4) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    x = torch.arange(6)
    assert mesh.shard_rows(x) is x and mesh.gather_rows(x) is x
    assert serve.serving_devices("cpu", 0) == [torch.device("cpu")]
    assert serve.serving_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert mesh.wait_for_backend("cpu") == []
