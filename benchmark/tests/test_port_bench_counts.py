"""The work counts of benchmark/counts/ against hand counts at E1's shapes
(nx 100, hidden 128, tw 25, one variable, K 6 of which 588 edges are
valid)."""
import json
from pathlib import Path

import pytest

from benchmark import roofline
from benchmark.counts import layer, lem_bwd, mp_layer_fwd, mp_pair_bwd
from benchmark.counts.mpsolver import call_shape as shape
from benchmark.counts.mpsolver import forward_flops, valid_edges

ROOT = Path(__file__).resolve().parents[2]
NX, H, D, V, E = 100, 128, 25, 1, 588


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / name).read_text())


def test_valid_edges_of_the_radius_graph():
    # nodes 0-2 and 97-99 lose 3, 2 and 1 of their six neighbours
    assert valid_edges(100, 3) == 600 - 2 * (3 + 2 + 1) == 588
    assert valid_edges(40, 3) == 240 - 12


def test_layer_forward_by_hand():
    sides = 2 * NX * H * (H + D + 1 + V) + 2 * NX * H * H  # i side, j side
    message = 2 * E * H * H
    update = 2 * NX * (2 * H + V) * H + 2 * NX * H * H
    assert layer.forward(NX, H, D, V, E) == sides + message + update
    assert layer.forward(NX, H, D, V, E) == 36_368_384


def test_layer_backward_by_hand():
    dw4_da3 = 2 * (2 * NX * H * H)
    dw3 = 2 * NX * (2 * H + V) * H
    dz3_back = 2 * NX * H * (2 * H)
    dw2_dm1 = 2 * (2 * E * H * H)
    dh_sides = 2 * (2 * NX * H * H)
    dw_sides = 2 * NX * H * (2 * H)
    dw_mix = 2 * NX * (D + 1 + V) * H
    assert layer.backward(NX, H, D, V, E) == (
        dw4_da3 + dw3 + dz3_back + dw2_dm1 + dh_sides + dw_sides + dw_mix)


def test_weights_of_a_layer():
    assert layer.n_weights(H, D, V) == 102_400


def test_mp_pair_bwd_work():
    s = shape(config("msmp_pde_e1.json"), 16)
    nbytes, flops, other = mp_pair_bwd.work(s)
    w = 2 * 102_400
    ins = 16 * NX * (H + D + 1 + V) + w + 2 * NX * 6
    outs_and_g = 2 * 16 * NX * H + w
    assert nbytes == 4 * (ins + outs_and_g)
    assert flops == 2 * 16 * (layer.forward(NX, H, D, V, E)
                              + layer.backward(NX, H, D, V, E))
    assert other == 0.0


def test_mp_layer_fwd_work():
    s = shape(config("mp_pde_e1.json"), 64)
    nbytes, flops, _ = mp_layer_fwd.work(s)
    assert nbytes == 4 * (64 * NX * (H + D + 1 + V) + 102_400 + 2 * NX * 6
                          + 64 * NX * H)
    assert flops == 64 * 36_368_384


def test_lem_bwd_work():
    s = shape(config("msmp_pde_e1.json"), 16)
    T, N = 25, 1600
    nbytes, flops, _ = lem_bwd.work(s)
    assert flops == T * N * (8 + 8 + 8) * H * H == 15_728_640_000
    assert nbytes == 4 * (10 * T * N * H + 6 * N * H + 8 * H * H)


def test_forward_flops_by_hand():
    msmp, mp = config("msmp_pde_e1.json"), config("mp_pde_e1.json")
    N = 16 * NX
    lem = (2 * 25 * N * 3 * 4 * H + 25 * N * (2 * H * 3 * H + 2 * H * H)
           + 2 * 2 * N * H * H)
    dec = 2 * N * 8 * 16 * 38 + 2 * N * 8 * 14 * 25
    assert forward_flops(msmp, 16) == (lem + 12 * 16 * 36_368_384 + dec)
    N = 64 * NX
    mlp = 2 * N * 27 * H + 2 * N * H * H
    dec = 2 * N * 8 * 16 * 38 + 2 * N * 8 * 14 * 25
    assert forward_flops(mp, 64) == mlp + 6 * 64 * 36_368_384 + dec


@pytest.mark.parametrize("nbytes,flops,other,expect", [
    (3.35e12, 0, 0, 1.0),
    (0, 495e12 / 3, 0, 1.0),
    (0, 0, 67e12, 1.0),
    (3.35e12, 495e12 / 3, 67e12, 2.0),
])
def test_bound(nbytes, flops, other, expect):
    assert roofline.bound_s(nbytes, flops, other) == pytest.approx(expect)
