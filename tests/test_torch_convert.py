"""PyTorch port, weights carried across (utils/convert.py) and the port's
independence from JAX."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msmp_pde_tpu.data.graph import build_neighbors_radius
from msmp_pde_tpu.models.registry import get_model as jget_model
from msmp_pde_torch.models.registry import get_model
from msmp_pde_torch.utils.convert import load_npz, params_from_flax, save_npz

ROOT = Path(__file__).resolve().parent.parent


def _flax_shapes(n_eq_vars, layers=6):
    """The full-width E1 MSMP-PDE param tree's shapes, without computing."""
    nx, B, tw = 100, 2, 25
    m, _ = jget_model("MSMP-PDE", tw=tw, n_eq_vars=n_eq_vars, L=16.0,
                      tmax=4.0, dt=4.0 / 249, n_layers=layers)
    idx, mask = build_neighbors_radius(np.linspace(0, 16, nx), 3)
    z = lambda *s: jnp.zeros(s, jnp.float32)
    return jax.eval_shape(
        lambda: m.init(jax.random.PRNGKey(0), z(B, nx, tw), z(B, nx), z(B),
                       z(B, 1 + n_eq_vars), jnp.asarray(idx),
                       jnp.asarray(mask)))


def _random_tree(shapes, rng):
    if hasattr(shapes, "items"):
        return {k: _random_tree(v, rng) for k, v in shapes.items()}
    return rng.normal(size=shapes.shape).astype(np.float32)


@pytest.mark.parametrize("n_eq_vars", [0, 3])
def test_every_leaf_maps_to_the_port(n_eq_vars):
    tree = _random_tree(_flax_shapes(n_eq_vars), np.random.default_rng(0))
    sd = params_from_flax(tree)
    model, _ = get_model("MSMP-PDE", tw=25, n_eq_vars=n_eq_vars, L=16.0,
                         tmax=4.0, dt=4.0 / 249)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    model.load_state_dict(sd, strict=True)
    if n_eq_vars == 0:
        # the full-width E1 model: 1,329,657 parameters
        assert sum(v.numel() for v in sd.values()) == 1329657
        assert want["embedding_lem.weights"] == (384, 131)
        assert want["gate_5.TorchDense_1.kernel"] == (257, 128)
        assert want["gnn_0.FactorizedEdgeDense_0.w_du"] == (25, 128)
        assert want["output_mlp.TorchConv1d_1.kernel"] == (1, 8, 14)
    np.testing.assert_array_equal(
        model.gnn_3.FactorizedEdgeDense_0.w_var.detach().numpy(),
        tree["params"]["gnn_3"]["FactorizedEdgeDense_0"]["w_var"])


def test_npz_roundtrip(tmp_path):
    tree = _random_tree(_flax_shapes(0, layers=1), np.random.default_rng(1))
    # an npz written from the JAX side: one array per '/'-joined flax path
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = v

    walk(tree, ())
    np.savez(tmp_path / "jax.npz", **flat)
    sd = load_npz(str(tmp_path / "jax.npz"))
    assert sd.keys() == params_from_flax(tree).keys()
    save_npz(str(tmp_path / "port.npz"), sd)
    sd2 = load_npz(str(tmp_path / "port.npz"))
    for k in sd:
        torch.testing.assert_close(sd2[k], sd[k], rtol=0, atol=0)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("where", ["msmp_pde_torch", "chip_smoke.py"])
def test_port_imports_no_jax(where):
    target = ROOT / where
    files = sorted(target.rglob("*.py")) if target.is_dir() else [target]
    assert files
    banned = ("jax", "flax", "optax", "orbax", "msmp_pde_tpu")
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, f"{f} imports {mod}"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """The smoke script exits non-zero and prints no result where there is
    no card, and where it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = (ROOT / "chip_smoke.py").read_text()
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, path in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(path)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
