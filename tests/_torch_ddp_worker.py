"""One rank of the data-parallel CPU tests (tests/test_torch_ddp.py),
started with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) and a gloo group:

    python tests/_torch_ddp_worker.py <task.json> <out_dir>

It imports no JAX. Each task of ``task.json`` runs in the group and rank 0
saves what it got under ``out_dir``: a step's loss and gradients
(``step``), the metrics (``metrics``), a CE chunk of datagen
(``datagen``), KS datagen's files (``ks``), a short ``fit`` with its
printed lines and checkpoint (``fit``); ``watchdog`` fires the train CLI's stall action in the group,
which must end the process with status 75.
"""
import contextlib
import io
import json
import os
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from msmp_pde_torch.data.graph import (  # noqa: E402
    GraphSpec,
    build_neighbors_radius,
)
from msmp_pde_torch.models.registry import get_model  # noqa: E402
from msmp_pde_torch.parallel import mesh  # noqa: E402
from msmp_pde_torch.training.loop import Trainer  # noqa: E402

NX, H, LAYERS, L, TMAX = 24, 96, 2, 16.0, 4.0


def port_trainer(tw, nt, name="MSMP-PDE", state=None,
                 dtype=torch.float64):
    """The trainer of tests/test_torch_train.py::_port_trainer (float64)
    on its radius-3 graph of nx 24, with ``state`` loaded."""
    x = np.linspace(0.0, L, NX)
    idx, mask = build_neighbors_radius(x, 3)
    m, kind = get_model(name, tw=tw, n_eq_vars=0, L=L, tmax=TMAX,
                        dt=TMAX / (nt - 1), n_layers=LAYERS, hidden=H)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    spec = GraphSpec(idx=torch.as_tensor(idx, dtype=torch.int64),
                     mask=f(mask), x=f(x),
                     t_grid=f(np.linspace(0.0, TMAX, nt)), tw=tw,
                     n_components=1, L=L, tmax=TMAX, dt=TMAX / (nt - 1))
    trainer = Trainer(model=m.to(dtype), kind=kind, spec=spec, eq_norms={})
    if state is not None:
        trainer.model.load_state_dict(state, strict=True)
    return trainer


def step_task(t, out):
    """One optimizer step at each unrolled depth from the same weights:
    the loss and every parameter's gradient."""
    z = np.load(t["data"])
    res = {}
    for unrolled in t["unrolled"]:
        trainer = port_trainer(t["tw"], t["nt"], state=torch.load(
            t["state"], weights_only=True))
        tx = trainer.make_optimizer(1e-3, 0.4, [1, 2], 1)
        step = trainer.train_step_fn(tx, unrolled)
        u = torch.as_tensor(z["u"])
        loss = step(u, {}, torch.as_tensor(z[f"idx{unrolled}"]),
                    torch.as_tensor(z[f"steps{unrolled}"]))
        res[f"loss{unrolled}"] = loss.numpy()
        for name, p in trainer.model.named_parameters():
            res[f"grad{unrolled}/{name}"] = p.grad.numpy()
    return res


def metrics_task(t, out):
    from msmp_pde_torch.training import metrics

    z = np.load(t["data"])
    trainer = port_trainer(t["tw"], t["nt"], state=torch.load(
        t["state"], weights_only=True))
    u, ub = torch.as_tensor(z["u"]), torch.as_tensor(z["ub"])
    bs, gt, nt = t["batch_size"], 1, t["nt"]
    quiet = lambda *a, **k: None  # noqa: E731
    res = {}
    res["l2"] = np.array(metrics.compute_l2_norms(trainer, u, {}, bs, gt, nt,
                                                  log=quiet))
    steps = metrics.test_timestep_losses(trainer, u, {}, bs, nt, log=quiet)
    res["timestep"] = np.array([steps[k] for k in sorted(steps)])
    res["unrolled"] = np.array(metrics.test_unrolled_losses(
        trainer, u, ub, {}, bs, gt, nt, NX, log=quiet))
    res["preds"], res["trues"] = metrics.rollout_store(trainer, u, {}, bs,
                                                       gt, nt,
                                                       n_more_rollout=1)
    return res


def datagen_task(t, out):
    from msmp_pde_torch.datagen import generate
    from msmp_pde_torch.equations import CE

    pde = CE(tmin=0.0, tmax=t["tmax"], grid_size=tuple(t["grid"]))
    draws = generate.draw_chunk(np.random.default_rng(t["seed"]), t["chunk"],
                                2, (1.0, 1.0), (0.0, 0.2), (0.0, 0.0), pde)
    solve = generate.ce_solver(pde, torch.float64, "cpu")
    traj = generate.solve_chunk(
        solve, [torch.as_tensor(a, dtype=torch.float64) for a in draws])
    return {"traj": traj.numpy()}


KS_SAMPLES = {"train": 3, "valid": 1, "test": 2}
KS_RES = [(250, 100), (250, 50)]


def ks_args(data_dir):
    """tests/test_torch_ks.py's KS datagen arguments (tend 5, dt 0.01)."""
    from msmp_pde_torch.datagen import generate

    return generate.build_parser().parse_args(
        ["--experiment=KS", "--device=cpu", "--seed=2", "--chunk=2",
         f"--data_dir={data_dir}"] + [f"--{m}_samples={k}"
                                      for m, k in KS_SAMPLES.items()])


def ks_task(t, out):
    """KS datagen over the group (every rank its rows), rank 0 writing
    ``out/ks``."""
    from msmp_pde_torch.datagen import generate

    generate.generate_ks(ks_args(os.path.join(out, "ks")), 5.0, 0.01,
                         resolutions=KS_RES)
    return {}


def fit_args(**kw):
    """The arguments of tests/test_torch_fit.py's ``fit`` runs."""
    base = dict(batch_size=2, num_epochs=1, lr=1e-3, lr_decay=0.4,
                milestones=None, unrolling=1, nr_gt_steps=1,
                print_interval=1000, seed=0, dp=0, resume=None, profile=None,
                base_resolution=[0, NX], short_horizon_windows=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def fit_task(t, out):
    from msmp_pde_torch.training import train

    z = np.load(t["data"])
    trainer = port_trainer(t["tw"], t["nt"], state=torch.load(
        t["state"], weights_only=True))
    data = {m: (torch.as_tensor(z[f"{m}_u"]), torch.as_tensor(z[f"{m}_ub"]),
                {}) for m in ("train", "valid", "test")}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = train.fit(fit_args(base_resolution=[t["nt"], NX]),
                        types.SimpleNamespace(trainer=trainer, t_res=t["nt"]),
                        data, os.path.join(out, "fit.pt"))
    if mesh.rank() == 0:
        with open(os.path.join(out, "fit.txt"), "w") as f:
            f.write(buf.getvalue())
    elif buf.getvalue():
        raise AssertionError(f"rank {mesh.rank()} printed {buf.getvalue()!r}")
    return {k: np.asarray(got[k]) for k in ("valid_L2", "valid_rel_L2",
                                            "test_L2", "test_rel_L2",
                                            "min_val_loss", "test_loss")}


def watchdog_task(t, out):
    from msmp_pde_torch.training import train

    train._stall_recovery(fit_args(), os.path.join(out, "none.pt"))()
    raise AssertionError("the stall action returned")


TASKS = {"step": step_task, "metrics": metrics_task,
         "datagen": datagen_task, "ks": ks_task, "fit": fit_task,
         "watchdog": watchdog_task}


def main():
    task_path, out = sys.argv[1:3]
    torch.set_num_threads(1)
    with open(task_path) as f:
        tasks = json.load(f)
    assert mesh.init_distributed("cpu"), "no torchrun environment"
    for t in tasks:
        res = TASKS[t["kind"]](t, out)
        if mesh.rank() == 0:
            np.savez(os.path.join(out, f"{t['kind']}.npz"), **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
