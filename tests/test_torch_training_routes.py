"""PyTorch port, the routes of the training step (training/loop.py) on the
CPU, no JAX. On the CPU, and on the CPU inside a process group (gloo,
world size 1), ``train_step_fn`` gives the eager step: no CUDA graph is
captured or replayed, ``make_optimizer`` builds AdamW as before (not
capturable, its rate a number), and the losses, weights and AdamW's state
of steps that mix depths 0 and 1 across a milestone are bitwise those of
the step as written before the graphed route (``_reference_step``). A
checkpoint stores the rate as a number and loads into the eager route from
either route. The warm-up's snapshot and restore (``_snapshot``,
``_restore``) put the weights and AdamW's state back bitwise, and zero the
state that AdamW made since. A graphed step's key follows its inputs, and
a copied trainer leaves its built steps behind. MSMP-PDE at one layer on
E1's grid cut to nx 40. tests/test_torch_training_graphs_gpu.py holds the graphed route on
the card."""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from msmp_pde_torch.parallel import mesh
from msmp_pde_torch.training import loop
from msmp_pde_torch.training.setup import build_trainer
from msmp_pde_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)

from _torch_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NX, NT, TW, N, B = 40, 250, 25, 6, 2
LR, DECAY, MILESTONES, PER_EPOCH = 1e-3, 0.4, [1], 2
DEPTHS = [0, 1, 1, 0, 1]


def _trainer():
    return build_trainer("E1", "MSMP-PDE", base_resolution=(NT, NX),
                         n_graph_layers=1, device="cpu")


def _twins():
    a, b = _trainer(), _trainer()
    b.model.load_state_dict(a.model.state_dict(), strict=True)
    return a, b


def _reference_tx(tr):
    """AdamW and the schedule as ``make_optimizer`` built them before the
    graphed route."""
    opt = torch.optim.AdamW(tr.model.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.01)
    bounds = [m * PER_EPOCH for m in MILESTONES]
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: DECAY ** sum(count >= b for b in bounds))
    return opt, sched


def _reference_step(tr, tx, u_all, idx, steps, unrolled):
    """The step as written before the graphed route, on one process."""
    opt, sched = tx
    loss = tr.step_loss(u_all, {}, idx, steps, unrolled)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def _data(seed=0):
    return torch.randn(N, NT, NX, generator=torch.Generator().manual_seed(
        seed))


def _batches(depths, seed=1):
    rng = np.random.default_rng(seed)
    return [(f, torch.as_tensor(rng.permutation(N)[:B]),
             torch.as_tensor(rng.integers(TW, NT - TW - TW * f + 1, B)))
            for f in depths]


def _assert_same(a, tx_a, b, tx_b):
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
        sa, sb = tx_a[0].state[p], tx_b[0].state[q]
        assert sa.keys() == sb.keys(), n
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (n, k)
    assert tx_a[0].param_groups[0]["lr"] == tx_b[0].param_groups[0]["lr"]
    assert tx_a[1].last_epoch == tx_b[1].last_epoch


@pytest.fixture
def process_group():
    """A gloo group of one process, destroyed after the test."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("group", [False, True], ids=["cpu", "process_group"])
def test_the_step_takes_the_eager_route(request, group):
    if group:
        request.getfixturevalue("process_group")
    assert mesh.active() == group
    tr, ref = _twins()
    assert not tr.graphed()
    tx = tr.make_optimizer(LR, DECAY, MILESTONES, PER_EPOCH)
    for g in tx[0].param_groups:
        assert g["capturable"] is False and isinstance(g["lr"], float)
    fns = {f: tr.train_step_fn(tx, f) for f in (0, 1)}
    assert not any(isinstance(fn, loop.GraphedStep) for fn in fns.values())
    ref_tx = _reference_tx(ref)
    u_all = _data()
    captures, replays = loop.captures, loop.replays
    for f, idx, st in _batches(DEPTHS):
        got = fns[f](u_all, {}, idx, st)
        want = _reference_step(ref, ref_tx, u_all, idx, st, f)
        assert torch.equal(got, want)
    assert (loop.captures, loop.replays) == (captures, replays)
    assert tx[0].param_groups[0]["lr"] == pytest.approx(LR * DECAY)
    _assert_same(tr, tx, ref, ref_tx)


@pytest.mark.parametrize("saved_by", ["eager", "graphed"])
def test_a_checkpoint_loads_into_the_eager_route(tmp_path, saved_by):
    """A checkpoint of the eager route, or one as the graphed route writes
    it (AdamW capturable, the rate a number), restores a CPU trainer,
    which goes on bitwise as the trainer it was saved from."""
    a, b = _twins()
    tx_a = a.make_optimizer(LR, DECAY, MILESTONES, PER_EPOCH)
    tx_b = b.make_optimizer(LR, DECAY, MILESTONES, PER_EPOCH)
    fns = {f: a.train_step_fn(tx_a, f) for f in (0, 1)}
    u_all = _data()
    batches = _batches(DEPTHS)
    for f, idx, st in batches[:3]:
        fns[f](u_all, {}, idx, st)
    path = str(tmp_path / "ck.pt")
    save_checkpoint(path, a.model, tx_a, 2)
    payload = torch.load(path, weights_only=True)
    assert isinstance(payload["optimizer"]["param_groups"][0]["lr"], float)
    if saved_by == "graphed":
        for g in payload["optimizer"]["param_groups"]:
            g["capturable"] = True
        torch.save(payload, path)
    assert restore_checkpoint(path, b.model, tx_b) == 2
    for g in tx_b[0].param_groups:
        assert g["capturable"] is False and isinstance(g["lr"], float)
    _assert_same(a, tx_a, b, tx_b)
    fns_b = {f: b.train_step_fn(tx_b, f) for f in (0, 1)}
    for f, idx, st in batches[3:]:
        assert torch.equal(fns[f](u_all, {}, idx, st),
                           fns_b[f](u_all, {}, idx, st))
    _assert_same(a, tx_a, b, tx_b)


@pytest.mark.parametrize("prior", [0, 2])
def test_the_warm_up_restore_is_bitwise(prior):
    """``_restore`` puts back what ``_snapshot`` copied, through steps
    taken in between, and zeroes the AdamW state made since (``prior`` = 0:
    none before)."""
    tr = _trainer()
    tx = tr.make_optimizer(LR, DECAY, MILESTONES, PER_EPOCH)
    step = {f: tr.train_step_fn(tx, f) for f in (0, 1)}
    u_all = _data()
    for f, idx, st in _batches([1, 0][:prior]):
        step[f](u_all, {}, idx, st)
    params = [p.detach().clone() for p in tr.model.parameters()]
    state = {p: {k: v.clone() for k, v in st.items()}
             for p, st in tx[0].state.items()}
    saved = loop._snapshot(tr.model, tx[0])
    for f, idx, st in _batches([0, 1], seed=4):
        step[f](u_all, {}, idx, st)
    loop._restore(tr.model, tx[0], saved)
    for p, q in zip(tr.model.parameters(), params):
        assert torch.equal(p, q)
    assert len(tx[0].state) == len(params)
    for p, st in tx[0].state.items():
        for k, v in st.items():
            assert torch.equal(v, state[p][k]) if prior else not v.any()


def test_a_graphed_step_key_follows_its_inputs():
    """``GraphedStep.key_of`` changes with the identity or shape of
    ``u_all`` or a variable, and with the batch size, and with nothing
    else."""
    u1, u2 = _data(0), _data(0)
    v = {"a": torch.ones(N)}
    idx, st = torch.arange(B), torch.full((B,), 50)
    key = loop.GraphedStep.key_of
    base = key(u1, v, idx, st)
    assert key(u1, v, idx + 1, st + 3) == base
    assert key(u2, v, idx, st) != base
    assert key(u1[:, :, :20], v, idx, st) != base
    assert key(u1, {"a": torch.ones(N)}, idx, st) != base
    assert key(u1, {}, idx, st) != base
    assert key(u1, v, torch.arange(B + 1), torch.full((B + 1,), 50)) != base


def test_a_copied_trainer_builds_its_own_steps():
    """``copy.deepcopy`` of a trainer (chip_smoke.py's float64 twin) leaves
    its built steps behind, a captured graph among them, and the copy
    steps as the original does."""
    import copy

    tr = _trainer()
    tx = tr.make_optimizer(LR, DECAY, MILESTONES, PER_EPOCH)
    u_all = _data()
    (f, idx, st), = _batches([1])
    tr.train_step_fn(tx, f)(u_all, {}, idx, st)
    twin, twin_tx = copy.deepcopy((tr, tx))
    assert twin._steps == {} and len(tr._steps) == 1
    assert torch.equal(tr.train_step_fn(tx, 0)(u_all, {}, idx, st),
                       twin.train_step_fn(twin_tx, 0)(u_all, {}, idx, st))
