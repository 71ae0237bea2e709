"""PyTorch port, the training step as CUDA graphs (training/loop.py::
``GraphedStep``) against the eager step (``Trainer._one_step``) on the
card, at the models' full widths, steps that mix pushforward depths 0 and
1 from the same weights, both routes with the graphed route's optimizer
(AdamW capturable, its rate a tensor on the card) and cuDNN's
deterministic algorithms. The models (``CASES``): MSMP-PDE and MP-PDE on
E1 at batch 16; MSGMP-PDE, whose hidden-164 LEM ring builds a tensor map
each call; MSMP-PDE2D on RP's grid; FNO2DPU (cuFFT, the interpolation to
and from RPU's LCG grid); MSMP-PDE at batch 48 with the pair's fallback
backward forced. The first two, and all six where marked:

* (all six) the replays' losses, the parameters and AdamW's moments and
  step counts are bitwise the eager step's, and so are the rates, with a
  milestone 3 steps in; each launch counter advances by what the eager
  step's does; ``captures`` counts one a depth and ``replays`` every
  step; each loss is a tensor of its own;
* (all six) a capture leaves the weights, AdamW's state, the schedule and
  the launch counters bitwise as they were;
* a milestone changes the rate that the replay applies: the step after it
  moves the weights by the decay times what it would have;
* a new ``u_all`` or batch size captures anew, and the replays stay
  bitwise the eager step's;
* a checkpoint round trip restores a graphed trainer bitwise and drops the
  graphs captured on the optimizer it loads into;
* an optimizer that cannot be captured raises at capture, and so does a
  step whose parameters an autograd graph kept from an earlier forward
  still holds, naming the kept graph, until that graph is freed.

Skipped without a card. This file imports no JAX:

    python -m pytest tests/test_torch_training_graphs_gpu.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

from msmp_pde_torch import ops
from msmp_pde_torch.datagen.ics import pseudo_random_grid
from msmp_pde_torch.ops import mp_pair
from msmp_pde_torch.training import loop
from msmp_pde_torch.training.setup import GridInfo, build_trainer
from msmp_pde_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)

from _torch_helpers import cuda_device  # noqa: F401

pytestmark = pytest.mark.gpu

MODELS = ["MSMP-PDE", "MP-PDE"]
# case: (experiment, model, batch, a step's (mp_pair_bwd, mp_layer_bwd)
# launches)
CASES = {"MSMP-PDE": ("E1", "MSMP-PDE", 16, (6, 0)),
         "MP-PDE": ("E1", "MP-PDE", 16, (0, 6)),
         "MSGMP-PDE": ("E1", "MSGMP-PDE", 16, (6, 0)),
         "MSMP-PDE2D": ("RP", "MSMP-PDE2D", 16, (6, 0)),
         "FNO2DPU": ("RPU", "FNO2DPU", 16, (0, 0)),
         "fallback": ("E1", "MSMP-PDE", 48, (0, 12))}
B, N, NT, NX, TW = 16, 64, 250, 100, 25
DEPTHS = [0, 1, 1, 0, 1, 0, 0, 1]  # more than 6 steps, both depths mixed
# AdamW's rate 1e-3, times 0.1 from update 3 on
LR, DECAY, MILESTONES, PER_EPOCH = 1e-3, 0.1, [1], 3


@pytest.fixture
def deterministic(cuda_device):
    """cuDNN's deterministic algorithms (its default conv backward does not
    repeat bitwise) and TF32 off, for the block."""
    was = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark,
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = was


def _twins(name, dev, n=2, experiment="E1"):
    """``n`` trainers of ``name`` on ``experiment``'s grid (RPU's LCG
    grid, as a dataset holds it) with the same weights."""
    grid = None
    if experiment == "RPU":
        x = pseudo_random_grid(0.0, 16.0, NX).astype(np.float32)
        grid = GridInfo(x=x, nt=NT, dt=4.0 / 249, tmin=0.0, tmax=4.0,
                        n_components=2)
    trs = [build_trainer(experiment, name, device=dev, grid=grid)
           for _ in range(n)]
    for tr in trs[1:]:
        tr.model.load_state_dict(trs[0].model.state_dict(), strict=True)
    return trs


def _data(dev, seed=0, n=N):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(n, NT, NX, device=dev, generator=g)


def _case(case, dev, monkeypatch, n=2):
    """The case's ``n`` trainers, its (u_all, var_all) and batch size; the
    pair's fallback forced for the "fallback" case (the route is chosen in
    the forward, so in the capture too)."""
    experiment, name, batch, _ = CASES[case]
    if case == "fallback":
        monkeypatch.setattr(mp_pair, "pair_bwd_fused_fits",
                            lambda *a, **k: False)
    trs = _twins(name, dev, n, experiment)
    g = torch.Generator(device=dev).manual_seed(0)
    d = trs[0].d
    u_all = torch.randn((N, NT, NX) if d == 1 else (N, NT, d, NX),
                        device=dev, generator=g)
    var_all = {k: 0.1 + 0.9 * torch.rand(N, device=dev, generator=g)
               for k in trs[0].eq_norms}
    return trs, u_all, var_all, batch


def _batches(dev, depths, seed=1, batch=B, n=N):
    rng = np.random.default_rng(seed)
    return [(f, torch.as_tensor(rng.permutation(n)[:batch], device=dev),
             torch.as_tensor(rng.integers(TW, NT - TW - TW * f + 1, batch),
                             device=dev)) for f in depths]


def _run(fns, u_all, batches, var_all=None):
    """Each batch through ``fns[depth]``: (the losses, each step's launch
    counter deltas)."""
    losses, deltas = [], []
    for f, idx, st in batches:
        before = ops.launch_counts()
        losses.append(fns[f](u_all, var_all or {}, idx, st))
        after = ops.launch_counts()
        deltas.append({k: after[k] - before[k] for k in after})
    torch.cuda.synchronize()
    return losses, deltas


def _state(tr, tx):
    """The weights, AdamW's state and the schedule's, as copies."""
    opt, sched = tx
    params = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    moments = {n: {k: v.clone() for k, v in opt.state[p].items()}
               for n, p in tr.model.named_parameters() if p in opt.state}
    lr = float(opt.param_groups[0]["lr"])
    return params, moments, lr, sched.last_epoch


def _assert_same(a, b):
    pa, ma, lra, ca = a
    pb, mb, lrb, cb = b
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    assert ma.keys() == mb.keys()
    for n in ma:
        assert ma[n].keys() == mb[n].keys(), n
        for k in ma[n]:
            assert torch.equal(ma[n][k], mb[n][k]), (n, k)
    assert (lra, ca) == (lrb, cb)


def _make_tx(tr):
    return tr.make_optimizer(LR, DECAY, MILESTONES, PER_EPOCH)


@pytest.mark.parametrize("case", CASES)
def test_replays_are_bitwise_the_eager_steps(deterministic, monkeypatch,
                                             case):
    dev = deterministic
    (graphed, eager), u_all, var_all, batch = _case(case, dev, monkeypatch)
    assert graphed.graphed()
    tx_g, tx_e = _make_tx(graphed), _make_tx(eager)
    assert tx_g[0].param_groups[0]["capturable"]
    assert torch.is_tensor(tx_g[0].param_groups[0]["lr"])
    fns_g = {f: graphed.train_step_fn(tx_g, f) for f in (0, 1)}
    fns_e = {f: eager._one_step(tx_e, f) for f in (0, 1)}
    assert all(isinstance(fn, loop.GraphedStep) for fn in fns_g.values())
    batches = _batches(dev, DEPTHS, batch=batch)
    captures, replays = loop.captures, loop.replays
    losses_g, deltas_g = _run(fns_g, u_all, batches, var_all)
    assert (loop.captures - captures, loop.replays - replays) == (
        2, len(DEPTHS))
    losses_e, deltas_e = _run(fns_e, u_all, batches, var_all)
    assert loop.captures == captures + 2
    for i, (a, b) in enumerate(zip(losses_g, losses_e)):
        assert torch.equal(a, b), (i, a, b)
    assert deltas_g == deltas_e
    assert (deltas_g[0]["mp_pair_bwd"],
            deltas_g[0]["mp_layer_bwd"]) == CASES[case][3]
    # each loss a tensor of its own, none the graph's
    ptrs = {x.data_ptr() for x in losses_g}
    assert len(ptrs) == len(losses_g)
    assert not ptrs & {fn.loss.data_ptr() for fn in fns_g.values()}
    _assert_same(_state(graphed, tx_g), _state(eager, tx_e))
    assert tx_g[1].last_epoch == len(DEPTHS)
    assert float(tx_g[0].param_groups[0]["lr"]) == pytest.approx(LR * DECAY)


@pytest.mark.parametrize("prior", [0, 2])
@pytest.mark.parametrize("case", CASES)
def test_a_capture_leaves_the_state_unchanged(deterministic, monkeypatch,
                                              case, prior):
    dev = deterministic
    (tr,), u_all, var_all, batch = _case(case, dev, monkeypatch, 1)
    tx = _make_tx(tr)
    eager = {f: tr._one_step(tx, f) for f in (0, 1)}
    _run(eager, u_all, _batches(dev, [0, 1][:prior], seed=2, batch=batch),
         var_all)
    before = _state(tr, tx)
    counts = ops.launch_counts()
    captures = loop.captures
    f, idx, st = _batches(dev, [1], seed=3, batch=batch)[0]
    step = loop.GraphedStep(tr, tx, f)
    step.capture(u_all, var_all, idx, st)
    torch.cuda.synchronize()
    after = _state(tr, tx)
    if not prior:
        # AdamW's state is made at the warm-up's first step: zeros, as
        # AdamW makes it fresh
        for st_ in after[1].values():
            for v in st_.values():
                assert not v.any()
        after = (after[0], {}, after[2], after[3])
    _assert_same(before, after)
    assert ops.launch_counts() == counts
    assert loop.captures == captures + 1
    assert all(p.grad is None for p in tr.model.parameters())


def test_a_milestone_changes_the_replayed_rate(deterministic):
    """Two graphed trainers from the same weights, one with the milestone 3
    steps in and one without: the first three steps agree bitwise, the
    fourth moves the weights by DECAY times as much (AdamW's update and
    its weight decay both scale with the rate)."""
    dev = deterministic
    a, b = _twins("MSMP-PDE", dev)
    tx_a = a.make_optimizer(LR, DECAY, MILESTONES, PER_EPOCH)
    tx_b = b.make_optimizer(LR, DECAY, [1000], PER_EPOCH)
    fa = {f: a.train_step_fn(tx_a, f) for f in (0, 1)}
    fb = {f: b.train_step_fn(tx_b, f) for f in (0, 1)}
    u_all = _data(dev)
    batches = _batches(dev, [0, 1, 0, 1])
    _run(fa, u_all, batches[:3])
    _run(fb, u_all, batches[:3])
    third = _state(a, tx_a)[0]
    _assert_same((third, {}, 0, 0), (_state(b, tx_b)[0], {}, 0, 0))
    assert float(tx_a[0].param_groups[0]["lr"]) == pytest.approx(LR * DECAY)
    assert float(tx_b[0].param_groups[0]["lr"]) == pytest.approx(LR)
    _run(fa, u_all, batches[3:])
    _run(fb, u_all, batches[3:])
    da = torch.cat([(p.detach() - third[n]).reshape(-1)
                    for n, p in a.model.named_parameters()])
    db = torch.cat([(p.detach() - third[n]).reshape(-1)
                    for n, p in b.model.named_parameters()])
    ratio = float(torch.linalg.vector_norm(da) / torch.linalg.vector_norm(db))
    assert ratio == pytest.approx(DECAY, rel=1e-2)


@pytest.mark.parametrize("name", MODELS)
def test_new_inputs_capture_anew(deterministic, name):
    dev = deterministic
    graphed, eager = _twins(name, dev)
    tx_g, tx_e = _make_tx(graphed), _make_tx(eager)
    fn_g, fn_e = graphed.train_step_fn(tx_g, 1), eager._one_step(tx_e, 1)
    u1, u2 = _data(dev, 0), _data(dev, 5)
    runs = [(u1, _batches(dev, [1], seed=6)), (u1, _batches(dev, [1], 7)),
            (u2, _batches(dev, [1], 8)),
            (u2, _batches(dev, [1], 9, batch=8))]
    new = []
    for u_all, batch in runs:
        captures = loop.captures
        lg, _ = _run({1: fn_g}, u_all, batch)
        new.append(loop.captures - captures)
        le, _ = _run({1: fn_e}, u_all, batch)
        assert torch.equal(lg[0], le[0])
    assert new == [1, 0, 1, 1]
    _assert_same(_state(graphed, tx_g), _state(eager, tx_e))


def test_a_checkpoint_round_trip(deterministic, tmp_path):
    """A graphed trainer's checkpoint holds the rate as a number; restored
    into a fresh graphed trainer it is a tensor on the card again, AdamW's
    step counts are there too, and both trainers go on bitwise alike. A
    load into a trainer whose graphs are captured drops them."""
    dev = deterministic
    a, b = _twins("MSMP-PDE", dev)
    tx_a, tx_b = _make_tx(a), _make_tx(b)
    fa = {f: a.train_step_fn(tx_a, f) for f in (0, 1)}
    fb = {f: b.train_step_fn(tx_b, f) for f in (0, 1)}
    u_all = _data(dev)
    batches = _batches(dev, DEPTHS)
    _run(fa, u_all, batches[:4])
    _run(fb, u_all, batches[:1])  # b's graphs of depth 0 captured
    path = str(tmp_path / "ck.pt")
    save_checkpoint(path, a.model, tx_a, 0)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert isinstance(saved["optimizer"]["param_groups"][0]["lr"], float)
    assert restore_checkpoint(path, b.model, tx_b) == 0
    group = tx_b[0].param_groups[0]
    assert group["capturable"] and torch.is_tensor(group["lr"])
    assert group["lr"].is_cuda
    assert all(st["step"].is_cuda for st in tx_b[0].state.values())
    assert fb[0].graph is None
    _assert_same(_state(a, tx_a), _state(b, tx_b))
    captures = loop.captures
    _run(fa, u_all, batches[4:])
    _run(fb, u_all, batches[4:])
    assert loop.captures == captures + 2  # b's two depths
    _assert_same(_state(a, tx_a), _state(b, tx_b))


def test_an_eager_optimizer_raises_at_capture(cuda_device):
    (tr,) = _twins("MP-PDE", cuda_device, 1)
    opt = torch.optim.AdamW(tr.model.parameters(), lr=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda c: 1.0)
    step = tr.train_step_fn((opt, sched), 0)
    f, idx, st = _batches(cuda_device, [0])[0]
    with pytest.raises(ValueError, match="capturable"):
        step(_data(cuda_device), {}, idx, st)


def test_a_kept_autograd_graph_raises_at_capture(cuda_device):
    """A loss kept from a forward on another stream holds its parameters'
    gradient accumulators there: the capture raises, twice over on two
    trainers, saying so, and leaves the weights as they were; once the
    loss is freed the step captures and runs."""
    for _ in range(2):
        (tr,) = _twins("MP-PDE", cuda_device, 1)
        tx = _make_tx(tr)
        u_all = _data(cuda_device)
        f, idx, st = _batches(cuda_device, [0])[0]
        loss = tr.step_loss(u_all, {}, idx, st, 0)
        before = _state(tr, tx)
        step = tr.train_step_fn(tx, 0)
        with pytest.raises(RuntimeError, match="cannot be captured(.|\n)*"
                           "autograd graph"):
            step(u_all, {}, idx, st)
        after = _state(tr, tx)
        _assert_same(before, (after[0], {}, after[2], after[3]))
        del loss
        assert bool(torch.isfinite(step(u_all, {}, idx, st)))
