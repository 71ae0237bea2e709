"""PyTorch port, serving a checkpoint the JAX package wrote, on the CPU in
float64: the JAX ``save_checkpoint`` in both of its layouts (the train
CLI's params, AdamW state and epoch; params-only), converted by
``convert_jax_checkpoint.py`` (the repository's root) into the ``.npz``
of flax paths, read by the port's ``serve.load_checkpoint``, and rolled
out over three windows (from a start step whose windows cross nt - tw)
against the JAX engine's rollout program from the params that
``restore_params`` gives back, at 1e-9; MSMP-PDE and MP-PDE at nx 40, two
layers. The port's server refuses the orbax directory itself, naming the
converter.
"""
import dataclasses
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from msmp_pde_tpu.serving.engine import RolloutEngine as JEngine
from msmp_pde_tpu.serving.engine import build_serving_trainer as jbuild
from msmp_pde_tpu.utils.checkpoint import restore_params, save_checkpoint
from msmp_pde_torch.serving import serve
from msmp_pde_torch.serving.engine import (
    RolloutProgram,
    build_serving_trainer,
)

from _torch_helpers import np_tree, one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import convert_jax_checkpoint  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

RES, LAYERS, B, S = (250, 40), 2, 2, 3


def _args(ckpt, out, model):
    return types.SimpleNamespace(
        checkpoint=str(ckpt), out=str(out), experiment="E1", model=model,
        base_resolution=list(RES), super_resolution=[250, 200], neighbors=3,
        time_window=25, n_graph_layers=LAYERS, data_dir="", data_suffix="",
        mp_precision="float32", dtype="float64")


@pytest.mark.parametrize("layout", ["train", "params"])
@pytest.mark.parametrize("model", ["MSMP-PDE", "MP-PDE"])
def test_jax_checkpoint_serves_as_the_jax_engine(tmp_path, model, layout):
    jt = jbuild("E1", model, base_resolution=RES, n_graph_layers=LAYERS)
    params = np_tree(jt.init_params(jax.random.PRNGKey(1), batch_size=B))
    rng = np.random.default_rng(5)
    # weights away from their init, so a restore of the template would show
    params = jax.tree.map(
        lambda a: a + 0.01 * rng.normal(size=a.shape), params)
    ckpt = tmp_path / "jax_ckpt"
    if layout == "train":
        tx = jt.make_optimizer(1e-3, 0.4, [1], 10)
        save_checkpoint(str(ckpt), params, tx.init(params), 3)
    else:
        save_checkpoint(str(ckpt), params)
    with pytest.raises(ValueError, match="convert_jax_checkpoint.py"):
        serve.load_checkpoint(str(ckpt))

    npz = tmp_path / "params.npz"
    convert_jax_checkpoint.convert(_args(ckpt, npz, model))
    state = serve.load_checkpoint(str(npz))
    assert all(v.dtype == torch.float64 for v in state.values())

    restored = restore_params(str(ckpt), jt, jax.tree.map(
        lambda a: np.asarray(a, np.float64), params))
    window = rng.normal(size=(B, 40, 25))
    steps = np.array([25, 200], np.int32)
    # the JAX engine's rollout program, on float64 windows (its ``rollout``
    # casts a request to float32)
    want = np.asarray(JEngine(jt, restored, batch_buckets=(B,))._program(
        B, S, ())(restored, window, steps, {}))

    tr = build_serving_trainer("E1", model, base_resolution=RES,
                               n_graph_layers=LAYERS, device="cpu")
    tr.model.to(torch.float64).load_state_dict(state, strict=True)
    spec = dataclasses.replace(tr.spec, **{
        k: getattr(tr.spec, k).double() for k in ("x", "t_grid", "mask")})
    tr = dataclasses.replace(tr, spec=spec)
    with torch.no_grad():
        got = RolloutProgram(tr, S)(
            torch.as_tensor(window, dtype=torch.float64),
            torch.as_tensor(steps, dtype=torch.int64), {}).numpy()
    assert got.shape == want.shape == (B, S, 40, 25)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
