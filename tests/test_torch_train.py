"""PyTorch port, the training path (data/graph.py::slice_windows,
training/loop.py: ``make_optimizer``, ``Trainer._one_step``,
``train_epoch``) against the JAX package, float64, on an MSMP-PDE of
hidden 96 (tw=25 needs H >= 88), two gated pairs, nx=24.

* slice_windows: exact;
* the learning rate of every step across two milestones against optax's
  schedule: 1e-15;
* one and three optimizer steps at unrolled 0 and 1 against the JAX
  ``Trainer.train_step_fn`` (``mp_impl="xla"``, ``lem_impl="xla"``) from
  the same converted parameters and batches: the losses, the gradients (the
  first Adam moment / (1 - b1) after one step), the updated parameters and
  Adam's moments after three steps, at 1e-8;
* one epoch of ``train_epoch`` (tw=20, nt=60, i.e. 60 passes of one batch
  of 2) against the JAX ``train_epoch`` drawing from the same seed: mean
  loss and final parameters at 1e-8, except the layers' last biases (b4,
  ``TorchDense_2.bias``). Their gradient is analytically zero
  (InstanceNorm removes it) and both sides hold roundoff there, which
  AdamW turns into steps of about lr * noise / eps that differ between
  the two; over 60 steps those leaves are held to lr * 1e-3 = 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msmp_pde_tpu.data.graph import GraphSpec as JSpec
from msmp_pde_tpu.data.graph import build_neighbors_radius
from msmp_pde_tpu.data.graph import slice_windows as jslice
from msmp_pde_tpu.models.gnn import MPSolver as JSolver
from msmp_pde_tpu.training.loop import Trainer as JTrainer
from msmp_pde_tpu.training.loop import train_epoch as jtrain_epoch
from msmp_pde_torch.data.graph import GraphSpec, slice_windows
from msmp_pde_torch.models.registry import get_model
from msmp_pde_torch.ops import lem_scan, mp_pair
from msmp_pde_torch.training.loop import Trainer, train_epoch
from msmp_pde_torch.utils.convert import params_from_flax

from _torch_helpers import np_tree, tt

NX, H, LAYERS, L, TMAX = 24, 96, 2, 16.0, 4.0
TOL = dict(rtol=1e-8, atol=1e-8)
# registry name -> (encoder, gate) of the JAX MPSolver
ENCODER_GATE = {"MSMP-PDE": ("lem", "sigmoid"), "MP-PDE": ("mlp", "none"),
                "LEM": ("lem", "none"), "Gated": ("mlp", "sigmoid")}


def _port_trainer(tw, nt, idx, mask, x, name="MSMP-PDE"):
    m, kind = get_model(name, tw=tw, n_eq_vars=0, L=L, tmax=TMAX,
                        dt=TMAX / (nt - 1), n_layers=LAYERS, hidden=H)
    spec = GraphSpec(idx=torch.as_tensor(idx, dtype=torch.int64),
                     mask=tt(mask), x=tt(x),
                     t_grid=tt(np.linspace(0.0, TMAX, nt)), tw=tw,
                     n_components=1, L=L, tmax=TMAX, dt=TMAX / (nt - 1))
    return Trainer(model=m.to(torch.float64), kind=kind, spec=spec,
                   eq_norms={})


def _trainers(tw, nt, name="MSMP-PDE"):
    """(JAX trainer, its float64 params, port trainer with the same
    weights) of the registry model ``name`` on one stencil graph."""
    x = np.linspace(0.0, L, NX)
    idx, mask = build_neighbors_radius(x, 3)
    t_grid = np.linspace(0.0, TMAX, nt)
    dt = TMAX / (nt - 1)
    meta = dict(tw=tw, n_components=1, L=L, tmax=TMAX, dt=dt)
    jspec = JSpec(idx=jnp.asarray(idx), mask=jnp.asarray(mask, jnp.float64),
                  x=jnp.asarray(x), t_grid=jnp.asarray(t_grid), **meta)
    encoder, gate = ENCODER_GATE[name]
    jm = JSolver(tw=tw, hidden=H, layers=LAYERS, encoder=encoder, gate=gate,
                 L=L, tmax=TMAX, dt=dt, mp_impl="xla", lem_impl="xla")
    jtr = JTrainer(model=jm, kind="graph", spec=jspec, eq_norms={})
    f = lambda a: jnp.asarray(a, jnp.float32)
    params = np_tree(jm.init(
        jax.random.PRNGKey(0), f(np.zeros((2, NX, tw))),
        f(np.broadcast_to(x, (2, NX))), f(np.zeros(2)), f(np.zeros((2, 1))),
        jnp.asarray(idx), f(mask)))
    trainer = _port_trainer(tw, nt, idx, mask, x, name)
    trainer.model.load_state_dict(params_from_flax(params), strict=True)
    return jtr, params, trainer


def _leaf(tree, name):
    node = tree["params"]
    for part in name.split("."):
        node = node[part]
    return np.asarray(node)


def _assert_params(trainer, tree, b4_atol=TOL["atol"]):
    for name, p in trainer.model.named_parameters():
        tol = TOL
        if name.endswith("TorchDense_2.bias"):
            tol = dict(TOL, atol=b4_atol)
        np.testing.assert_allclose(p.detach().numpy(), _leaf(tree, name),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("d", [1, 2])
def test_slice_windows_matches_jax(d):
    rng = np.random.default_rng(d)
    shape = (3, 40, NX) if d == 1 else (3, 40, d, NX)
    u = rng.normal(size=shape)
    steps = np.array([5, 17, 30])
    want = jslice(jnp.asarray(u), jnp.asarray(steps), 5)
    got = slice_windows(tt(u), torch.as_tensor(steps), 5)
    for a, b in zip(got, want):
        assert a.shape == (3, NX, d * 5)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lr_schedule_matches_optax():
    x = np.linspace(0.0, L, NX)
    trainer = _port_trainer(25, 100, *build_neighbors_radius(x, 3), x)
    spe, milestones = 3, [1, 2]
    opt, sched = trainer.make_optimizer(1e-3, 0.4, milestones, spe)
    want = optax.piecewise_constant_schedule(
        1e-3, {m * spe: 0.4 for m in milestones})
    for count in range(10):
        assert abs(opt.param_groups[0]["lr"] - float(want(count))) < 1e-15
        opt.step()
        sched.step()


@pytest.mark.parametrize("unrolled", [0, 1])
def test_steps_match_jax_train_step(unrolled):
    tw, nt = 25, 100
    jtr, params, trainer = _trainers(tw, nt)
    rng = np.random.default_rng(10 + unrolled)
    u = rng.normal(size=(4, nt, NX))
    batches = [(rng.permutation(4)[:2],
                rng.integers(tw, nt - tw * (unrolled + 1) + 1, size=2))
               for _ in range(3)]
    # milestones at update counts 1 and 2: the rate changes inside the run
    tx = jtr.make_optimizer(1e-3, 0.4, [1, 2], 1)
    opt_state = tx.init(params)
    jstep = jtr.train_step_fn(tx, unrolled)
    ttx = trainer.make_optimizer(1e-3, 0.4, [1, 2], 1)
    tstep = trainer.train_step_fn(ttx, unrolled)
    before = (lem_scan.launches, lem_scan.bwd_launches, mp_pair.launches,
              mp_pair.bwd_launches)
    for i, (ib, st) in enumerate(batches):
        params, opt_state, jloss = jstep(
            params, opt_state, jnp.asarray(u), {}, jnp.asarray(ib),
            jnp.asarray(st))
        loss = tstep(tt(u), {}, torch.as_tensor(ib), torch.as_tensor(st))
        np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
        if i == 0:  # after one step, mu = (1 - b1) * grad
            mu = opt_state[0].mu
            for name, p in trainer.model.named_parameters():
                np.testing.assert_allclose(
                    p.grad.numpy(), _leaf(mu, name) / 0.1, err_msg=name,
                    **TOL)
        _assert_params(trainer, params)
    opt = ttx[0]
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                                   _leaf(opt_state[0].mu, name),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(),
                                   _leaf(opt_state[0].nu, name),
                                   err_msg=name, **TOL)
    # CPU tensors take the plain versions: no kernel ran
    assert before == (lem_scan.launches, lem_scan.bwd_launches,
                      mp_pair.launches, mp_pair.bwd_launches)


def test_train_epoch_matches_jax():
    tw, nt, n, batch = 20, 60, 2, 2
    jtr, params, trainer = _trainers(tw, nt)
    u = np.random.default_rng(3).normal(size=(n, nt, NX))
    spe = nt * (n // batch)
    tx = jtr.make_optimizer(1e-3, 0.4, [1, 5], spe)
    quiet = dict(print_interval=1000, log=lambda *a: None)
    params, _, jmean = jtrain_epoch(
        jtr, tx, params, tx.init(params), jnp.asarray(u), {}, 1, batch, nt,
        1, np.random.default_rng(7), **quiet)
    flags = []
    mean, losses = train_epoch(
        trainer, trainer.make_optimizer(1e-3, 0.4, [1, 5], spe), tt(u), {},
        1, batch, nt, 1, np.random.default_rng(7), on_step=flags.append,
        **quiet)
    assert losses.shape == (nt, 1) and len(flags) == nt
    assert set(flags) == {0, 1}  # both pushforward depths ran
    np.testing.assert_allclose(mean, jmean, **TOL)
    _assert_params(trainer, params, b4_atol=1e-6)
