"""PyTorch port, the eight grid models (models/cnn.py, models/fno.py:
BaseCNN, FNO, FNOP, VNO, BaseCNN2D, FNO2D, FNO2DP, FNO2DPU on RPU's LCG
grid) against the JAX modules
built by the JAX registry, on the same flax tree carried across by
``params_from_flax``: nx 40 (16 modes need nx // 2 + 1 >= 16), tw 25, batch
2, float64 (JAX in x64, tests/conftest.py).

* each forward against the JAX module's ``apply``: 1e-10;
* the gradient of a loss for every leaf against ``jax.grad``: 1e-9 of the
  leaf's largest gradient entry;
* the converted tree loads with ``strict=True`` and its keys are the flax
  leaves (VNO's transform and the grid channel are not parameters);
* VNO's transform rounded through float32 as the JAX module rounds it,
  also at random sorted positions;
* BaseCNN2D's hidden width is 128 whatever ``hidden`` says; the
  registry builds all 27 names; the full-width parameter counts of the
  JAX modules (nx 100; FNO2DPU's resampling holds no parameter).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.models.registry import get_model as jget_model
from msmp_pde_torch.datagen.ics import pseudo_random_grid
from msmp_pde_torch.models.registry import (
    GRID,
    MODEL_REGISTRY,
    PORTED,
    get_model,
)
from msmp_pde_torch.utils.convert import params_from_flax

from _torch_helpers import np_tree, one_thread, tt  # noqa: F401

NX, B, TW, L, TMAX = 40, 2, 25, 16.0, 4.0
DT = TMAX / 249
# the experiments' equation variables: E3's for FNOP, RP's for the 2-D
EQ = {"FNOP": ("alpha", "beta", "gamma"), "FNO2DP": ("a", "b"),
      "FNO2DPU": ("a", "b"), "BaseCNN2D": ("a", "b"), "FNO2D": ("a", "b")}
TWO_D = ("BaseCNN2D", "FNO2D", "FNO2DP", "FNO2DPU")
VAR_MODELS = ("FNOP", "FNO2DP", "FNO2DPU")  # the Param variants
pytestmark = pytest.mark.usefixtures("one_thread")


def _positions(rng=None):
    """The grid: uniform, sorted random points from ``rng``, or with
    ``rng`` = "FNO2DPU" RPU's LCG grid (float32, as the dataset holds
    it), the one FNO2DPU resamples from."""
    if rng is None or isinstance(rng, str) and rng != "FNO2DPU":
        return np.linspace(0.0, L, NX).astype(np.float32)
    if isinstance(rng, str):
        return pseudo_random_grid(0.0, L, NX).astype(np.float32)
    return np.sort(rng.uniform(0.0, L, NX)).astype(np.float32)


def _shape(name, n=B, nx=NX):
    return (n, TW, 2, nx) if name in TWO_D else (n, TW, nx)


def _jax_model(name, positions, nx=NX):
    eq = EQ.get(name, ())
    m, kind = jget_model(name, tw=TW, n_eq_vars=len(eq), L=L, tmax=TMAX,
                         dt=DT, eq_var_names=eq, positions=positions)
    assert kind == "grid"
    args = [jnp.zeros(_shape(name, nx=nx), jnp.float32)]
    if name in VAR_MODELS:
        args.append(jnp.zeros((B, len(eq)), jnp.float32))
    if name == "FNO2DPU":
        args.append(jnp.asarray(positions))
    return m, np_tree(m.init(jax.random.PRNGKey(0), *args))


def _port_model(name, positions, params=None, hidden=128):
    eq = EQ.get(name, ())
    m, kind = get_model(name, tw=TW, n_eq_vars=len(eq), L=L, tmax=TMAX,
                        dt=DT, eq_var_names=eq, positions=positions,
                        hidden=hidden)
    assert kind == "grid"
    m = m.double()
    if params is not None:
        m.load_state_dict(params_from_flax(params), strict=True)
    return m


def _inputs(name, rng):
    u = rng.normal(size=_shape(name))
    var = (rng.uniform(0.1, 1.0, (B, len(EQ[name])))
           if name in VAR_MODELS else None)
    return u, var


def _apply_jax(jm, params, u, var, x=None):
    args = [jnp.asarray(u)] + ([] if var is None else [jnp.asarray(var)])
    return jm.apply(params, *args, *([] if x is None else [jnp.asarray(x)]))


def _apply_port(m, u, var, x=None):
    return m(tt(u), None if var is None else tt(var),
             *([] if x is None else [torch.as_tensor(x)]))


def _grid_of(name):
    """The unstructured model's coordinates, None for the others."""
    return _positions(name) if name == "FNO2DPU" else None


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield ".".join(prefix), tree


@pytest.mark.parametrize("name", GRID)
def test_forward_matches_jax(name):
    pos = _positions(name)
    jm, params = _jax_model(name, pos)
    m = _port_model(name, pos, params)
    u, var = _inputs(name, np.random.default_rng(1))
    want = np.asarray(_apply_jax(jm, params, u, var, _grid_of(name)))
    with torch.no_grad():
        got = _apply_port(m, u, var, _grid_of(name)).numpy()
    assert got.shape == _shape(name) == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", GRID)
def test_gradients_match_jax(name):
    """The gradient of sum(out * r) for every leaf: 1e-9 of the leaf's
    largest entry."""
    pos = _positions(name)
    x = _grid_of(name)
    jm, params = _jax_model(name, pos)
    m = _port_model(name, pos, params)
    rng = np.random.default_rng(2)
    u, var = _inputs(name, rng)
    r = rng.normal(size=_shape(name))
    want = jax.grad(lambda p: jnp.sum(_apply_jax(jm, p, u, var, x) * r))(
        jax.tree_util.tree_map(jnp.asarray, params))
    want = dict(_leaves(jax.device_get(want)["params"]))
    loss = torch.sum(_apply_port(m, u, var, x) * tt(r))
    named = list(m.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    assert {n for n, _ in named} == set(want)
    for (pname, _), g in zip(named, grads):
        w = np.asarray(want[pname])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-9 * np.abs(w).max(), err_msg=pname)


@pytest.mark.parametrize("name", GRID)
def test_state_dict_is_the_flax_leaves(name, tmp_path):
    """Strict loading, the keys and shapes of the flax leaves, and an
    ``.npz`` round trip of the spectral weights' trailing pair axis."""
    from msmp_pde_torch.utils.convert import load_npz, save_npz

    pos = _positions(name)
    _, params = _jax_model(name, pos)
    m = _port_model(name, pos, params)
    flax = dict(_leaves(params["params"]))
    sd = m.state_dict()
    assert sorted(sd) == sorted(params_from_flax(params))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: v.shape for k, v in flax.items()}
    path = str(tmp_path / "params.npz")
    save_npz(path, sd)
    back = load_npz(path)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


@pytest.mark.parametrize("case", ["uniform", "random_sorted"])
def test_vno_transform_rounded_through_float32(case):
    """VNO's c and s are the float64 Vandermonde parts rounded to float32
    (in any module dtype), and the forward at random sorted positions
    matches JAX's at 1e-10."""
    rng = np.random.default_rng(3)
    pos = _positions(None if case == "uniform" else rng)
    m = _port_model("VNO", pos)
    theta = np.outer(np.arange(16), pos.astype(np.float64))
    for buf, f in ((m.c, np.cos), (m.s, np.sin)):
        exact = (f(theta) / np.sqrt(NX)).T
        assert buf.dtype == torch.float64
        np.testing.assert_array_equal(buf.numpy(), exact.astype(np.float32))
        assert np.abs(buf.numpy() - exact).max() > 0  # rounded
    assert "c" not in m.state_dict() and "s" not in m.state_dict()
    jm, params = _jax_model("VNO", pos)
    m.load_state_dict(params_from_flax(params), strict=True)
    u, _ = _inputs("VNO", rng)
    want = np.asarray(_apply_jax(jm, params, u, None))
    with torch.no_grad():
        got = _apply_port(m, u, None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_basecnn2d_hidden_is_128():
    for hidden in (40, 64, 256):
        m = _port_model("BaseCNN2D", _positions(), hidden=hidden)
        assert tuple(m._CircularConv_0.TorchConv1d_0.kernel.shape) == (
            128, 2 * TW, 3)
        assert tuple(m._CircularConv_7.TorchConv1d_0.kernel.shape) == (
            2 * TW, 128, 9)
    m = _port_model("BaseCNN", _positions(), hidden=64)
    assert m._CircularConv_0.TorchConv1d_0.kernel.shape[0] == 40


def test_fno2dpu_raises_and_the_registry_builds_the_rest():
    """FNO2DPU no longer raises: the registry builds all 27 names."""
    m = _port_model("FNO2DPU", _positions("FNO2DPU"))
    assert m.unstructured and m.n_vars == 2
    assert sorted(MODEL_REGISTRY) == sorted(PORTED)
    assert len(set(MODEL_REGISTRY)) == 27
    for name in MODEL_REGISTRY:
        eq = EQ.get(name, ("a", "b") if "2D" in name else ())
        _, kind = get_model(name, tw=TW, n_eq_vars=len(eq), L=L, tmax=TMAX,
                            dt=DT, eq_var_names=eq, n_layers=1,
                            positions=_positions(name))
        assert kind == ("grid" if name in GRID else "graph")


@pytest.mark.parametrize("name,count", [
    ("BaseCNN", 69905), ("BaseCNN2D", 667570), ("FNO", 554201),
    ("VNO", 554201), ("FNOP", 554393), ("FNO2D", 2192818),
    ("FNO2DP", 2193074), ("FNO2DPU", 2193074)])
def test_full_width_parameter_counts(name, count):
    """At nx 100, tw 25 (FNOP with E3's three variables, the 2-D models
    with a and b), the JAX modules' counts."""
    eq = EQ.get(name, ())
    m, _ = get_model(name, tw=TW, n_eq_vars=len(eq), L=L, tmax=TMAX, dt=DT,
                     eq_var_names=eq,
                     positions=np.linspace(0.0, L, 100).astype(np.float32))
    assert sum(p.numel() for p in m.parameters()) == count


def test_xavier_bounds():
    """BaseCNN's kernels draw within the Xavier bound and fill it; the
    biases within the fan-in bound."""
    m = _port_model("BaseCNN", _positions())
    for i in range(8):
        conv = getattr(m, f"_CircularConv_{i}").TorchConv1d_0
        o, c, k = conv.kernel.shape
        xb = (6.0 / (c * k + o * k)) ** 0.5
        assert conv.kernel.abs().max().item() <= xb
        assert conv.kernel.abs().max().item() > 0.9 * xb
        assert conv.bias.abs().max().item() <= (c * k) ** -0.5
