"""PyTorch port, the holds that chip_smoke.py phase 27 puts on the bf16
message-passing kernels, tried on the CPU with stand-ins for the kernels.

The kernels run only on the card. Here a kernel's run is played by
``_emulate``: the plain versions' site functions (ops/mp_layer.py) chained
stage by stage, returning the outputs and the intermediates in the form
``chip_smoke.workspace_layers`` reads from a kernel's workspace. It equals
the plain versions. Summed in another order (``chip_smoke.reordered``) it
is a second sound version, as the kernel is; with a fault planted in a
site function it is a kernel with that fault.

* The rounding-site check (``chip_smoke.bf16_sites``): a sound version
  reorders its float32 sums and passes every site within
  ``BF16_SITE_RATIO`` (the largest read ~1e-2); each fault of
  ``chip_smoke.BF16_FAULTS`` fails its own site, planted in the kernel
  stand-in and planted in the check's reference (as phase 27 plants it on
  the card); bias gradients summed from rounded cotangents fail their
  sites, and so does the storage mode's float32 h where h enters outside a
  product.
* The witness hold of a backward's outputs (``chip_smoke.witness_rhos``):
  a version summed in yet another order lies within ``BF16_WITNESS_RHO``
  of the spread of the plain version, the same summed in two other orders
  and the same in float64; a float32 kernel does not.
* ``workspace_layers`` tiles the workspace as csrc/mp_phases.cuh::
  layer_bufs lays it out.

float32 inputs made with numpy from a seed: nx 24 on a radius graph with
truncated boundary masks and 40 on RPU's k-NN graph (nodes of in-degree
0), hidden 32; the witness at E1's shapes (nx 100, hidden 128, K 6) at
batch 4.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from msmp_pde_torch.data.graph import build_neighbors_radius
from msmp_pde_torch.models.common import swish
from msmp_pde_torch.models.gnn import GNNLayer
from msmp_pde_torch.ops import mp_layer as ml

from test_torch_mp_layer import RPU_NX, rpu_graph

MODES = ("bfloat16", "bfloat16s")
NAMES = ("mp_pair_fwd", "mp_pair_fwd_stash", "mp_pair_bwd", "mp_layer_fwd",
         "mp_layer_bwd")


def _cases(graph, B=3, H=32, D=10, V=2, seed=0):
    """{kernel name: operands as chip_smoke.mp_calls takes them}."""
    rng = np.random.default_rng(seed)
    if graph == "knn_rpu":
        idx, mask = rpu_graph(RPU_NX)
        nx = RPU_NX
    else:
        nx = 24 if graph == "radius" else 100
        idx, mask = build_neighbors_radius(np.linspace(0.0, 16.0, nx),
                                           2 if graph == "radius" else 3)
    r = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(size=s) * scale, dtype=torch.float32)
    wg, wl, w1 = [tuple(w.detach() for w in GNNLayer(
        H, D, V, torch.Generator().manual_seed(seed + i)).weights())
        for i in range(3)]
    px = torch.linspace(0.0, 1.0, nx).expand(B, nx)[..., None].contiguous()
    base = (r(B, nx, H), r(B, nx, D), px, r(B, nx, V, scale=0.5),
            torch.as_tensor(np.asarray(idx)),
            torch.as_tensor(np.asarray(mask, np.float32)))
    g = r(B, nx, H)
    return {"mp_pair_fwd": (*base, wg, wl),
            "mp_pair_fwd_stash": (*base, wg, wl),
            "mp_pair_bwd": (*base, wg, wl, g), "mp_layer_fwd": (*base, w1),
            "mp_layer_bwd": (*base, w1, g)}


def _emulate(name, args, mode, rounded_bias=False, h32_terms=False):
    """A run of kernel ``name`` in ``mode`` by the plain site functions:
    (outputs as the kernel returns them, the intermediates as
    ``workspace_layers`` reads them). The single layer is GNN_Layer (final
    activation and residual), as chip_smoke.mp_calls calls it.
    ``rounded_bias`` sums the bias gradients from rounded cotangents and
    ``h32_terms`` takes the caller's h, not the storage mode's cast h,
    where h enters outside a product (faults)."""
    m = ml.mode_of(mode)
    r = ml._rounding(m)
    n_l = 2 if name.startswith("mp_pair") else 1
    idx, mask = args[4], args[5]
    h, u, px, v, *Ws = ml.plain_inputs(m, *args[:4], *args[6:6 + n_l])
    H = h.shape[-1]
    ht = args[0] if h32_terms else h
    col = ml._bf16 if rounded_bias else (lambda x: x)
    colsum = lambda x: col(x).reshape(-1, H).sum(0)  # noqa: E731
    layers = []
    for W in Ws:
        si, sj = ml._sides(h, u, px, v, W, r)
        m0 = ml._edge_in(si, sj, idx, r)
        z2 = ml._mm(swish(m0), W[6], r) + W[7]
        agg = ml._aggregate(z2, mask, m)
        z3 = ml._mm(torch.cat([h, agg, v], -1), W[8], r) + W[9]
        z4 = ml._mm(swish(z3), W[10], r) + W[11]
        layers.append(dict(si=si, sj=sj, agg=agg, z3=z3, z4=z4, m0=m0,
                           z2=z2))
    if n_l == 1:
        z4 = layers[0]["z4"]
        xh, rs = ml._instnorm(ht + swish(z4))
        out = xh
    else:
        (gn, rs_g), (ln, rs_l) = (ml._instnorm(L["z4"]) for L in layers)
        tau = torch.sigmoid(gn)
        out = (1.0 - tau) * ht + tau * swish(ln)
        if name.endswith("_stash"):
            out = (out, gn, ln)
    if not name.endswith("_bwd"):
        return out, layers
    g = args[6 + n_l]
    if n_l == 1:
        dxo = ml._instnorm_bwd(g, xh, rs)
        dz4s, dh = [dxo * ml._dswish(z4)], dxo
    else:
        dz4s = [ml._instnorm_bwd(g * (swish(ln) - ht) * tau * (1.0 - tau),
                                 gn, rs_g),
                ml._instnorm_bwd(g * tau * ml._dswish(ln), ln, rs_l)]
        dh = g * (1.0 - tau)
    dws = []
    for L, W, dz4 in zip(layers, Ws, dz4s):
        z3, m0 = L["z3"], L["m0"]
        dz3 = ml._mm(dz4, W[10].T, r) * ml._dswish(z3)
        dz2 = ml._aggregate_bwd(ml._mm(dz3, W[8][H:2 * H].T, r), mask,
                                L.pop("z2"), m)
        dm0 = ml._mm(dz2, W[6].T, r) * ml._dswish(m0)
        dsi, dsj = ml._gather_bwd(dm0, idx, mask, r)
        dh = (dh + ml._mm(dz3, W[8][:H].T, r) + ml._mm(dsi, W[0].T, r)
              + ml._mm(dsj, W[1].T, r))
        x3 = torch.cat([h, L["agg"], v], -1)
        dws.append((ml._outer(h, dsi, r), ml._outer(h, dsj, r),
                    *ml._mix_grads(u, px, dsi, dsj, r), ml._outer(v, dsi, r),
                    colsum(dsi), ml._outer(swish(m0), dz2, r), colsum(dz2),
                    ml._outer(x3, dz3, r), colsum(dz3),
                    ml._outer(swish(z3), dz4, r), colsum(dz4)))
        L.update(dz4=dz4, dz3=dz3, dz2=dz2, dm0=dm0, dsi=dsi, dsj=dsj)
    return (dh, *dws), layers


def _sites(name, args, mode, run, live=True):
    return cs.bf16_site_ratios(cs.bf16_sites(name, args, mode, *run), live)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_emulation_is_the_plain_version(name, mode):
    args = _cases("radius")[name]
    got = cs.flat(_emulate(name, args, mode)[0])
    want = cs.flat(cs.mp_calls(name, mode)[1](*args))
    for a, b in zip(got, want, strict=True):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), name


@pytest.mark.parametrize("graph", ("radius", "knn_rpu"))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_sites_hold_a_reordered_sound_version(name, mode, graph):
    """Every site of a version whose float32 sums run in chunks of 8 (a
    sound kernel) within BF16_SITE_RATIO; each site's rounding is live."""
    args = _cases(graph)[name]
    with cs.reordered(8):
        run = _emulate(name, args, mode)
    ratios = _sites(name, args, mode, run)
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= cs.BF16_SITE_RATIO, (worst, ratios[worst])


@pytest.mark.parametrize("fault", sorted(cs.BF16_FAULTS))
def test_sites_catch_a_fault_in_the_kernel(fault):
    """The kernel stand-in with one fault fails that fault's site."""
    name, site = cs.BF16_FAULTS[fault][2]
    args = _cases("radius")[name]
    with cs.planted(fault):
        run = _emulate(name, args, "bfloat16")
    assert cs.fault_site(_sites(name, args, "bfloat16", run),
                         site) > cs.BF16_SITE_RATIO


@pytest.mark.parametrize("fault", sorted(cs.BF16_FAULTS))
def test_sites_catch_a_fault_in_the_reference(fault):
    """Phase 27's teeth on the CPU: a sound run against the check with the
    fault planted in its site functions fails that site."""
    name, site = cs.BF16_FAULTS[fault][2]
    args = _cases("radius")[name]
    run = _emulate(name, args, "bfloat16")
    with cs.planted(fault):
        r = cs.fault_site(_sites(name, args, "bfloat16", run, False), site)
    assert r > cs.BF16_SITE_RATIO


@pytest.mark.parametrize("name", ("mp_pair_bwd", "mp_layer_bwd"))
def test_sites_catch_bias_gradients_of_rounded_cotangents(name):
    args = _cases("radius")[name]
    ratios = _sites(name, args, "bfloat16",
                    _emulate(name, args, "bfloat16", rounded_bias=True))
    for b in ("db1", "db2", "db3", "db4"):
        assert cs.fault_site(ratios, b) > cs.BF16_SITE_RATIO, b


@pytest.mark.parametrize("name", NAMES)
def test_storage_sites_catch_the_float32_h(name):
    """bfloat16s: a kernel whose residual, combine or dgn takes the
    caller's float32 h fails the storage mode's E site."""
    args = _cases("radius")[name]
    ratios = _sites(name, args, "bfloat16s",
                    _emulate(name, args, "bfloat16s", h32_terms=True))
    e = {k: v for k, v in ratios.items() if " E " in f" {k}"}
    assert e and max(e.values()) > cs.BF16_SITE_RATIO, ratios


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ("mp_pair_bwd", "mp_layer_bwd"))
def test_witness_holds_a_third_order_and_not_float32(name, mode):
    """At E1's shapes (batch 4): a version summed in chunks of 40 lies
    within BF16_WITNESS_RHO of the spread of P, P in float64 and P summed
    in chunks of 16 and 8 on every output but the b4 gradients; the
    float32 plain version lies beyond it."""
    args = _cases("e1", B=4, H=128, D=25, V=1, seed=3)[name]
    plain = cs.mp_calls(name, mode)[1]
    versions = cs.sound_versions(lambda o: cs.flat(plain(
        *(cs.to64(args) if o == "float64" else args))))
    with cs.reordered(40):
        k = cs.flat(plain(*args))
    p32 = cs.flat(cs.mp_calls(name)[1](*args))
    b4 = cs.b4_indices(name)

    def rhos(got):
        return [r for r in cs.witness_rhos(got, versions, p32, b4)
                if r is not None]

    assert max(rhos(k)) <= cs.BF16_WITNESS_RHO, rhos(k)
    assert max(rhos(p32)) > cs.BF16_WITNESS_RHO, rhos(p32)


@pytest.mark.parametrize("name", ("mp_pair_fwd", "mp_pair_bwd",
                                  "mp_layer_fwd", "mp_layer_bwd"))
def test_workspace_layers_tile_the_workspace(name):
    """The views ``workspace_layers`` takes are disjoint and each layer's
    lie within its slice, the forward's first (csrc/mp_phases.cuh::
    fwd_layer_floats, layer_floats)."""
    B, nx, H, K = 2, 5, 4, 3
    R = B * nx
    per = 5 * R * H + 2 * R * K * H
    if name.endswith("_bwd"):
        per += 5 * R * H + R * K * H + 6 * H * H
    n_l = 2 if name.startswith("mp_pair") else 1
    ws = torch.arange(n_l * per, dtype=torch.float64)
    seen = set()
    for k, L in enumerate(cs.workspace_layers(name, ws, B, nx, H, K)):
        for key, t in L.items():
            idx = set(t.reshape(-1).long().tolist())
            assert len(idx) == t.numel() and not idx & seen, key
            assert min(idx) >= k * per and max(idx) < (k + 1) * per, key
            seen |= idx
        want = 5 * R * H + 2 * R * K * H + (
            4 * R * H + R * K * H if name.endswith("_bwd") else 0)
        assert len(seen) == (k + 1) * want
    assert math.prod(cs.workspace_layers(name, ws, B, nx, H, K)[0]["m0"]
                     .shape) == R * K * H
