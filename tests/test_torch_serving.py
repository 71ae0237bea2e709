"""PyTorch port, serving (serving/engine.py, serving/serve.py) against the
JAX RolloutEngine on the same weights: E1 and E2 at nx=40 with 2 gated
pairs (MSMP-PDE, SaveMSMP-PDE) or 2 ungated layers (MP-PDE) at hidden 128.
Both engines run float32 on the CPU; the bound is 1e-4 after two or three
autoregressive windows (summation order only)."""
import threading

import jax
import numpy as np
import pytest
import torch

from msmp_pde_tpu.serving.engine import RolloutEngine as JEngine
from msmp_pde_tpu.serving.engine import build_serving_trainer as jbuild
from msmp_pde_torch.serving import serve
from msmp_pde_torch.serving.engine import (
    RolloutEngine,
    build_serving_trainer,
    windows_to_trajectory,
)
from msmp_pde_torch.utils.convert import params_from_flax, save_npz

from _torch_helpers import np_tree

RES = (250, 40)
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(experiment, buckets, model="MSMP-PDE", edit=None):
    """(JAX engine, the state dict, the port's engine) on one set of random
    weights; ``edit(params)`` changes them first."""
    jt = jbuild(experiment, model, base_resolution=RES, n_graph_layers=2)
    params = jt.init_params(jax.random.PRNGKey(0), batch_size=2)
    if edit is not None:
        params = edit(params)
    jeng = JEngine(jt, params, batch_buckets=buckets)
    state = params_from_flax(np_tree(params, np.float32))
    tt = build_serving_trainer(experiment, model, base_resolution=RES,
                               n_graph_layers=2, device="cpu")
    return jeng, state, RolloutEngine(tt, state, batch_buckets=buckets)


@pytest.fixture(scope="module")
def e1():
    return _pair("E1", (4,))


def _windows(B, seed):
    return np.random.default_rng(seed).normal(size=(B, 40, 25)).astype(
        np.float32)


ROLLOUT_CASES = [("MSMP-PDE", (4,)), ("MSMP-PDE", (1,)), ("MP-PDE", (4,)),
                 ("MP-PDE", (1,))]


@pytest.mark.parametrize("model,buckets", ROLLOUT_CASES)
def test_rollout_matches_jax(e1, model, buckets):
    """The gated and the ungated serving path, with the four windows in one
    bucket of 4 and one at a time in buckets of 1."""
    jeng, _, eng = (e1 if (model, buckets) == ROLLOUT_CASES[0]
                    else _pair("E1", buckets, model))
    w = _windows(4, 0)
    got = eng.rollout(w, start_step=25, n_windows=2)
    assert got.shape == (4, 2, 40, 25) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jeng.rollout(w, start_step=25,
                                                 n_windows=2), **TOL)


def test_stateful_rollout_across_horizon_matches_jax():
    """SaveMSMP-PDE carries its LEM state from window to window, and each
    sample's state is reset to zeros once its window starts past nt - tw
    (225): the samples starting at 200 and 225 cross it within the three
    windows, those at 25 and 150 do not. At random weights the LEM forgets
    its initial state within a window (its gates' step dt sigmoid(g) ~ 0.5
    a step), so the gates' biases are set to -8 first: then it keeps ~99%
    of the state over 25 steps, and a missing reset shows."""

    def slow_gates(params):
        p = jax.tree_util.tree_map(np.array, params)
        H = p["params"]["embedding_lem"]["bias"].shape[0] // 3
        p["params"]["embedding_lem"]["bias"][:2 * H] = -8.0
        return p

    jeng, _, eng = _pair("E1", (4,), "SaveMSMP-PDE", slow_gates)
    w = _windows(4, 8)
    steps = np.array([200, 25, 150, 225])
    got = eng.rollout(w, start_step=steps, n_windows=3)
    assert got.shape == (4, 3, 40, 25) and np.isfinite(got).all()
    np.testing.assert_allclose(
        got, jeng.rollout(w, start_step=steps, n_windows=3), **TOL)


def test_bucket_padding_is_invisible(e1):
    jeng, _, eng = e1
    w = _windows(3, 1)
    got = eng.rollout(w, n_windows=2)
    assert got.shape[0] == 3
    np.testing.assert_allclose(got, jeng.rollout(w, n_windows=2), **TOL)
    # the pad rows do not leak: the first row alone gives the same answer
    np.testing.assert_allclose(got[:1], eng.rollout(w[:1], n_windows=2),
                               rtol=1e-6, atol=1e-6)


def test_oversize_request_chunks_over_largest_bucket(e1):
    jeng, state, _ = e1
    tt = build_serving_trainer("E1", "MSMP-PDE", base_resolution=RES,
                               n_graph_layers=2, device="cpu")
    eng2 = RolloutEngine(tt, state, batch_buckets=(2,))  # 2 + 2 + 1
    w = _windows(5, 2)
    steps = np.array([25, 50, 75, 100, 125])
    got = eng2.rollout(w, start_step=steps, n_windows=2)
    np.testing.assert_allclose(
        got, jeng.rollout(w, start_step=steps, n_windows=2), **TOL)


def test_time_feature_clamps_beyond_horizon(e1):
    """Past the data horizon the time feature freezes at nt - tw."""
    jeng, _, eng = e1
    w = _windows(4, 3)
    got = eng.rollout(w, start_step=220, n_windows=2)  # 220, 245 -> 225
    np.testing.assert_allclose(
        got, jeng.rollout(w, start_step=220, n_windows=2), **TOL)
    clamped = eng.rollout(w, start_step=225, n_windows=1)
    np.testing.assert_allclose(got[:, 0], eng.rollout(
        w, start_step=220, n_windows=1)[:, 0], rtol=0, atol=0)
    assert not np.allclose(got[:, 0], clamped[:, 0])


def test_trajectory_layout(e1):
    jeng, _, eng = e1
    w = _windows(2, 4)
    traj = eng.trajectory(w, n_windows=2)
    assert traj.shape == (2, 50, 1, 40)
    np.testing.assert_allclose(traj, jeng.trajectory(w, n_windows=2), **TOL)
    preds = eng.rollout(w, n_windows=2)
    np.testing.assert_array_equal(traj, windows_to_trajectory(preds, 1, 25))
    np.testing.assert_array_equal(traj[1, 25 + 7, 0], preds[1, 1, :, 7])


def test_strict_validation(e1):
    _, _, eng = e1
    with pytest.raises(ValueError, match="window must be"):
        eng.rollout(np.zeros((2, 41, 25), np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        eng.rollout(_windows(2, 5), variables={"beta": np.zeros(2)})


def test_equation_variables_match_jax():
    """E2 conditions on beta (negated, normalized): the same through both
    engines."""
    jeng, _, eng = _pair("E2", (2,))
    w = _windows(2, 6)
    var = {"beta": np.array([0.05, 0.15], np.float32)}
    got = eng.rollout(w, variables=var, n_windows=1)
    np.testing.assert_allclose(got, jeng.rollout(w, variables=var,
                                                 n_windows=1), **TOL)
    other = eng.rollout(w, variables={"beta": var["beta"] * 0}, n_windows=1)
    assert not np.allclose(got, other)


def test_http_roundtrip(e1):
    from http.server import ThreadingHTTPServer

    _, _, eng = e1
    meta = {"backend": "cpu", "experiment": "E1", "model": "MSMP-PDE",
            "buckets": [4]}
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve.make_handler(eng, meta, max_windows=3))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        port = srv.server_address[1]
        w = _windows(3, 7)
        got = serve.request_rollout("127.0.0.1", port, w, steps=[25, 30, 35],
                                    n_windows=2)
        np.testing.assert_array_equal(
            got, eng.rollout(w, start_step=[25, 30, 35], n_windows=2))
        traj = serve.request_rollout("127.0.0.1", port, w, n_windows=2,
                                     as_trajectory=True)
        np.testing.assert_array_equal(traj, eng.trajectory(w, n_windows=2))
        with pytest.raises(RuntimeError, match="400"):
            serve.request_rollout("127.0.0.1", port, w, n_windows=4)
        with pytest.raises(RuntimeError, match="400"):
            serve.request_rollout("127.0.0.1", port, w,
                                  variables={"beta": np.zeros(3)})
    finally:
        srv.shutdown()
        srv.server_close()
        th.join()


def test_entry_points_need_cuda_unless_cpu(tmp_path, e1):
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_serving_trainer("E1", "MSMP-PDE", base_resolution=RES,
                              n_graph_layers=2)
    ckpt = tmp_path / "p.npz"
    save_npz(str(ckpt), e1[1])
    args = serve.build_parser().parse_args(
        ["--experiment=E1", f"--checkpoint={ckpt}", "--n_graph_layers=2",
         "--base_resolution", "250", "40"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(args)
