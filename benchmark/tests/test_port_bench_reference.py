"""The plain reference (benchmark/reference/) against the port's plain CPU
path, at the published widths with two layers: one set of weights made by
the benchmark loads strictly into both, the forwards agree to float32
rounding, and so do a training step's loss and gradients."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.reference import mpsolver, training

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("msmp_pde_e1", "mp_pde_e1")


def config(name, layers=2):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                     .read_text())
    return dict(cfg, layers=layers)


def program(cfg):
    from msmp_pde_torch.training.setup import build_trainer

    return build_trainer(cfg["experiment"], cfg["model"],
                         base_resolution=(cfg["nt"], cfg["nx"]),
                         neighbors=cfg["neighbors"], time_window=cfg["tw"],
                         n_graph_layers=cfg["layers"], device="cpu")


def weights(cfg, seed=5):
    return mpsolver.make_weights(cfg, traffic.generator(seed, "weights",
                                                        "cpu"), "cpu")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_load_strictly_and_count(name):
    cfg = config(name, layers=6)
    w = weights(cfg)
    tr = program(cfg)
    tr.model.load_state_dict(w, strict=True)
    assert sum(p.numel() for p in tr.model.parameters()) == cfg["n_params"]
    for n, _, fan in mpsolver.param_specs(cfg):
        assert w[n].abs().max() <= fan ** -0.5


def test_the_graph_is_the_programs():
    cfg = config("msmp_pde_e1")
    g = mpsolver.Graph(cfg, "cpu")
    spec = program(cfg).spec
    theirs = {(i, int(j)) for i in range(spec.nx)
              for j, m in zip(spec.idx[i], spec.mask[i]) if m}
    ours = set(zip(g.dst.tolist(), g.src.tolist()))
    assert ours == theirs and g.n_edges == 588
    assert torch.equal(g.x, spec.x)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_program(name):
    cfg = config(name)
    w = weights(cfg)
    tr = program(cfg)
    tr.model.load_state_dict(w, strict=True)
    gen = torch.Generator().manual_seed(3)
    window = torch.randn(3, cfg["nx"], cfg["tw"], generator=gen)
    steps = torch.tensor([25, 100, 200])
    with torch.no_grad():
        got, _ = tr.forward(window, steps, {})
        ref = mpsolver.forward(cfg, w, mpsolver.Graph(cfg, "cpu"), window,
                               mpsolver.time_grid(cfg, "cpu")[steps],
                               mpsolver.Precision())
    step = (ref - window[..., -1:]).abs().max()
    assert float((got - ref).abs().max() / step) < 1e-5


@pytest.mark.parametrize("unrolled", [0, 1])
def test_training_step_matches_the_program(unrolled):
    cfg = config("msmp_pde_e1")
    w = weights(cfg)
    tr = program(cfg)
    tr.model.load_state_dict(w, strict=True)
    x = mpsolver.Graph(cfg, "cpu").x
    u = traffic.smooth(4, mpsolver.time_grid(cfg, "cpu"), x, cfg["L"],
                       torch.Generator().manual_seed(1))
    idx = torch.tensor([2, 0, 3])
    steps = torch.tensor([25, 90, 170])
    loss = tr.step_loss(u, {}, idx, steps, unrolled)
    loss.backward()
    got = {n: p.grad for n, p in tr.model.named_parameters()}
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_loss = training.loss_of(
        mpsolver, cfg, params, mpsolver.Graph(cfg, "cpu"),
        mpsolver.time_grid(cfg, "cpu"), u[idx], steps, unrolled,
        mpsolver.Precision())
    grads = dict(zip(params, torch.autograd.grad(ref_loss,
                                                 list(params.values()))))
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                rel=1e-6)
    moving = training.moving_leaves(grads)
    gap, leaf = training.worst(training.leaf_gaps(got, grads, moving))
    assert gap < 1e-4, leaf


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10, -3.0 - 2 ** -12, 1e-30])
    got = mpsolver.tf32(x)
    want = torch.tensor([1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -3.0,
                         1e-30])
    assert torch.equal(got[:5], want[:5])
    assert abs(float(got[5]) / 1e-30 - 1) < 2 ** -10
    bits = got.view(torch.int32) & 0x1FFF
    assert not bits.any()


def test_adamw_matches_torch():
    gen = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(5, 3, generator=gen)}
    ours = {"a": p["a"].clone()}
    theirs = torch.nn.Parameter(p["a"].clone())
    opt = torch.optim.AdamW([theirs], lr=1e-3, weight_decay=0.01)
    state = {}
    for k in range(3):
        g = torch.randn(5, 3, generator=gen)
        training.adamw(ours, {"a": g}, state, 1e-3, k + 1)
        theirs.grad = g.clone()
        opt.step()
    np.testing.assert_allclose(ours["a"].numpy(), theirs.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
