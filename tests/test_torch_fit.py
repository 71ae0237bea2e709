"""PyTorch port, the train CLI (training/train.py: ``fit``, ``main``), its
checkpoints (utils/checkpoint.py) and watchdog (utils/watchdog.py), and
the path generate E1 -> train -> serve the checkpoint, on the CPU.

* one epoch of ``fit`` against the JAX package's ``fit`` (its trainer's
  ``init_params`` patched here to return the weights the port starts
  from, carried across by ``params_from_flax``) on a tiny set: MSMP-PDE
  of hidden 96 with two gated pairs, tw 20, nt 60, nx 24, float64, 2
  trajectories a mode, batch 2 (the JAX side writes no checkpoint). The
  results dict (valid and test L2 and relative L2, the best validation
  loss, the test loss) at rtol 1e-6: 60 AdamW steps on both sides, whose
  parameters agree to 1e-8 but for the last biases of the layers
  (tests/test_torch_train.py says why);
* the checkpoint: the parameters, AdamW's moments and step counts, the
  schedule's state and the epoch come back bitwise; ``--resume`` starts
  at the next epoch; ``restore_params`` takes a training checkpoint and a
  params-only one;
* the watchdog: fires once on a stall, never while beats arrive, not at
  all when disabled; ``fit`` arms it only in the train CLI's process; its
  recovery re-execs the CLI with ``--resume`` of the last checkpoint;
* the CLIs end to end: ``generate --experiment=E1 --device=cpu``, then
  ``train --num_epochs=1 --device=cpu`` (one gated pair, nx 40; with
  ``--log``, ``--profile``, ``--milestones`` and the short-horizon
  metric), then the HTTP server started with that checkpoint and
  ``--data_dir`` answers one request equal to ``RolloutEngine.rollout``;
  without ``--device`` both CLIs raise where there is no CUDA.

torch runs on one intra-op thread here (``one_thread``): the tensors are
tiny and the test workers share the host's cores.
"""
import os
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.training import train as jtrain
from msmp_pde_tpu.utils import checkpoint as jcheckpoint
from msmp_pde_torch.datagen import generate
from msmp_pde_torch.serving import serve
from msmp_pde_torch.training import train
from msmp_pde_torch.utils import checkpoint, watchdog

from _torch_helpers import one_thread, tt  # noqa: F401
from test_torch_train import _trainers

pytestmark = pytest.mark.usefixtures("one_thread")

TW, NT, NX = 20, 60, 24
KEYS = ("valid_L2", "valid_rel_L2", "test_L2", "test_rel_L2", "min_val_loss",
        "test_loss")


def _args(**kw):
    base = dict(batch_size=2, num_epochs=1, lr=1e-3, lr_decay=0.4,
                milestones=None, unrolling=1, nr_gt_steps=1,
                print_interval=1000, seed=0, dp=1, resume=None, profile=None,
                base_resolution=[NT, NX], short_horizon_windows=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _sets():
    rng = np.random.default_rng(4)
    return {m: (rng.normal(size=(2, NT, NX)) * 0.5,
                rng.normal(size=(2, NT, NX)) * 0.5)
            for m in ("train", "valid", "test")}


def _port_data(sets):
    return {m: (tt(u), tt(ub), {}) for m, (u, ub) in sets.items()}


def _tx(trainer):
    """The (AdamW, LambdaLR) pair ``fit`` built (its steps hold it)."""
    (tx,) = {id(tx): tx for tx, _ in trainer._steps.values()}.values()
    return tx


def test_fit_one_epoch_matches_jax(tmp_path, monkeypatch):
    jtr, params, trainer = _trainers(TW, NT)
    monkeypatch.setattr(jtr, "init_params", lambda key, batch_size=2: params)
    # the JAX checkpoint (orbax) is not compared: skip writing it
    monkeypatch.setattr(jcheckpoint, "save_checkpoint", lambda *a, **k: None)
    sets = _sets()
    want = jtrain.fit(
        _args(), types.SimpleNamespace(trainer=jtr, t_res=NT),
        {m: (jnp.asarray(u), jnp.asarray(ub), {})
         for m, (u, ub) in sets.items()}, str(tmp_path / "jax"))
    got = train.fit(_args(), types.SimpleNamespace(trainer=trainer, t_res=NT),
                    _port_data(sets), str(tmp_path / "port.pt"))
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    (h,) = got["history"]
    assert h["epoch"] == 0 and h["improved"] and h["losses"].shape == (NT, 1)
    assert h["val_loss"] == got["min_val_loss"]


def test_checkpoint_round_trip_and_resume(tmp_path, capsys):
    _, _, trainer = _trainers(TW, NT)
    data = _port_data(_sets())
    path = str(tmp_path / "models" / "ck.pt")
    train.fit(_args(), types.SimpleNamespace(trainer=trainer, t_res=NT), data,
              path)
    assert os.path.isfile(path) and not os.path.exists(path + ".tmp")
    opt, sched = _tx(trainer)

    _, _, fresh = _trainers(TW, NT)
    with torch.no_grad():
        for p in fresh.model.parameters():
            p.zero_()
    opt2, sched2 = fresh.make_optimizer(1e-3, 0.4, [1, 5, 10, 15], NT)
    assert checkpoint.restore_checkpoint(path, fresh.model,
                                         (opt2, sched2)) == 0
    params = list(trainer.model.parameters())
    for p, q in zip(params, fresh.model.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(params, list(fresh.model.parameters())):
        s, s2 = opt.state[p], opt2.state[q]
        assert set(s) == set(s2) == {"step", "exp_avg", "exp_avg_sq"}
        for k in s:
            assert torch.equal(s[k], s2[k]), k
    assert sched2.state_dict() == sched.state_dict()
    assert sched2.last_epoch == NT  # one epoch of one batch a pass

    state = checkpoint.restore_params(path)
    bare = str(tmp_path / "bare.pt")
    torch.save(trainer.model.state_dict(), bare)
    for sd in (state, checkpoint.restore_params(bare)):
        assert sd.keys() == trainer.model.state_dict().keys()
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(sd[k], v)

    capsys.readouterr()
    res = train.fit(_args(num_epochs=2, resume=path),
                    types.SimpleNamespace(trainer=fresh, t_res=NT), data,
                    str(tmp_path / "models" / "resumed.pt"))
    assert f"Resumed from {path} at epoch 1" in capsys.readouterr().out
    assert [h["epoch"] for h in res["history"]] == [1]


def test_watchdog_fires_on_a_stall_only():
    import time

    fired = []
    wd = watchdog.Watchdog(0.2, lambda: fired.append(1),
                           log=lambda *_: None).start()
    for _ in range(8):  # beats keep it alive well past stall_s
        wd.beat()
        time.sleep(0.06)
    assert not fired
    time.sleep(0.6)
    assert fired == [1]
    wd.stop()
    disabled = watchdog.Watchdog(0.0, lambda: fired.append(2)).start()
    assert disabled._thread is None
    time.sleep(0.1)
    assert fired == [1]


def test_watchdog_armed_only_in_the_cli(tmp_path, monkeypatch):
    armed = []

    class Recording(watchdog.Watchdog):
        def __init__(self, stall_s, action, log=print):
            super().__init__(0.0, action, log)
            armed.append((stall_s, action))

    monkeypatch.setattr(watchdog, "Watchdog", Recording)
    monkeypatch.setenv("MSMP_WATCHDOG_S", "123")
    _, _, trainer = _trainers(TW, NT)
    exp = types.SimpleNamespace(trainer=trainer, t_res=NT)
    save = str(tmp_path / "ck.pt")
    data = _port_data(_sets())
    assert not train._running_as_cli()  # pytest is not the train CLI
    train.fit(_args(num_epochs=0), exp, data, save)
    monkeypatch.setenv("MSMP_WATCHDOG_FORCE", "1")
    assert train._running_as_cli()
    train.fit(_args(num_epochs=0), exp, data, save)
    assert [s for s, _ in armed] == [0.0, 123.0]

    # the recovery re-execs the CLI, resuming from a complete checkpoint
    execs = []
    monkeypatch.setattr(os, "execv", lambda exe, argv: execs.append(argv))
    monkeypatch.setattr("sys.argv", ["train.py", "--experiment=E1",
                                     "--resume", "old.pt"])
    armed[-1][1]()
    torch.save({}, save)
    armed[-1][1]()
    assert execs[0][-1] == "--experiment=E1"
    assert execs[1][-3:] == ["--experiment=E1", "--resume", save]
    argv = ["--experiment=E1", "--resume", "models/old", "--batch_size=16",
            "--resume=models/older"]
    assert train._recovery_argv(argv, resume="models/new") == [
        "--experiment=E1", "--batch_size=16", "--resume", "models/new"]


def test_cli_generate_train_serve_e1(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    generate.main(generate.build_parser().parse_args(
        ["--experiment=E1", "--train_samples=2", "--valid_samples=1",
         "--test_samples=1", "--chunk=2", "--device=cpu"]))
    targs = ["--experiment=E1", "--model=MSMP-PDE", "--num_epochs=1",
             "--batch_size=2", "--n_graph_layers=1",
             "--base_resolution=250,40", "--print_interval=1000",
             "--milestones", "1", "--short_horizon_windows=2",
             "--profile=prof", "--log=True"]
    res = train.main(train.build_parser().parse_args(targs + ["--device=cpu"]))
    assert all(np.isfinite(res[k]) for k in KEYS + ("test_rel_L2_short",))
    (ckpt,) = os.listdir("models")
    (log,) = os.listdir("experiments/log")
    assert log == ckpt[:-len(".pt")] + ".csv"
    text = open(f"experiments/log/{log}").read()
    assert "Saved model at" in text and "short-horizon" in text
    assert os.path.getsize("prof/pass1.json") > 0  # one pass, traced
    sargs = serve.build_parser().parse_args(
        ["--experiment=E1", f"--checkpoint=models/{ckpt}",
         "--n_graph_layers=1", "--base_resolution", "250", "40",
         "--port=0", "--warmup_windows=0", "--device=cpu"])
    assert sargs.data_dir == "data"
    srv, engine = serve.build_server(sargs)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        w = np.random.default_rng(0).normal(size=(2, 40, 25)).astype(
            np.float32)
        got = serve.request_rollout("127.0.0.1", srv.server_address[1], w,
                                    n_windows=2)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    assert not th.is_alive()
    np.testing.assert_array_equal(got, engine.rollout(w, n_windows=2))
    state = checkpoint.restore_params(f"models/{ckpt}")
    for k, v in engine.trainer.model.state_dict().items():
        assert torch.equal(v, state[k])
    assert engine.trainer.spec.nx == 40
    if not torch.cuda.is_available():
        for cli, args in ((train, targs), (generate, ["--experiment=E1"])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(cli.build_parser().parse_args(args))
