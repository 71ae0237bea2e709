"""RPU's interpolated-route evaluation CLI (counterpart of
msmp_pde_tpu/training/eval_interpolated.py):

    python -m msmp_pde_torch.data.interpolate --experiment=RPU      # once
    python -m msmp_pde_torch.training.eval_interpolated --experiment=RPU \
        --model=FNO2DP --model_to_test=models/<run>.pt [--data_dir=data]

A model trained on the interpolated (uniform-grid) ``_I`` files rolls
out once over their test set; each prediction is interpolated back onto
the unstructured grid and measured there against the unstructured ground
truth (``metrics.compute_l2_norms_u``, the interp-back L2 and rel-L2).
The same rollout store feeds the uniform grid's norms; the one-step and
unrolled losses run on the uniform grid too. Figures (the rollout set on
the uniform grid, the interp-back comparison on the unstructured one)
go to ``plots/`` where matplotlib imports; ``--n_more_rollout`` rolls
past the horizon into ``plots/long_rollout_interp_pred.npy``. ``main``
returns the metrics and the stores. ``--device`` is cuda by default and
raises without it. ``--dp`` is taken and shards nothing, as in the JAX
CLI.
"""
from __future__ import annotations

import copy
import os

import numpy as np

from msmp_pde_torch.training.eval import PLOTS, _matplotlib


def plot_interp_back(preds_u, trues_u, x_unstructured, out_dir=PLOTS,
                     dpi=400):
    """The interpolated route on the unstructured grid: ground truth and
    the interpolated-back prediction (first component, points in sorted
    order) and the per-timestep relative error."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from msmp_pde_torch.training.metrics import compute_space_l2_norms

    os.makedirs(out_dir, exist_ok=True)
    order = np.argsort(np.asarray(x_unstructured))
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    axes[0].imshow(trues_u[0, :, 0][:, order].T, aspect="auto")
    axes[0].set_title("Ground Truth (unstructured)")
    axes[0].set_xlabel("Timestep")
    axes[0].set_ylabel("Grid Point (sorted)")
    axes[1].imshow(preds_u[0, :, 0][:, order].T, aspect="auto")
    axes[1].set_title("Prediction (interp back)")
    axes[1].set_xlabel("Timestep")
    _, rel = compute_space_l2_norms(preds_u, trues_u)
    axes[2].set_yscale("log")
    axes[2].plot(100 * rel)
    axes[2].set_title("Relative Error % (unstructured)")
    axes[2].set_xlabel("Timestep")
    fig.tight_layout()
    fig.savefig(f"{out_dir}/plot_interp_back.png", dpi=dpi)
    plt.close(fig)


def main(args):
    """Returns {interp_L2, interp_rel_L2, test_L2, test_rel_L2, test_loss,
    test_base_loss, preds, trues, preds_interp_back, trues_unstructured,
    figures}: the metrics printed, the uniform grid's rollout store ([N,
    T, d, nx] each), the horizon's predictions interpolated back and
    their unstructured targets, and whether the figures were written."""
    from msmp_pde_torch.data.dataset import PDEDataset
    from msmp_pde_torch.data.graph import build_graph_spec
    from msmp_pde_torch.device import resolve_device
    from msmp_pde_torch.serving.serve import load_checkpoint
    from msmp_pde_torch.training import metrics
    from msmp_pde_torch.training.eval import plot_2d_system, plot_rollouts
    from msmp_pde_torch.training.loop import Trainer
    from msmp_pde_torch.training.setup import (
        data_family,
        resolve_data_path,
        setup_experiment,
    )
    from msmp_pde_torch.training.train import device_arrays

    from msmp_pde_torch.parallel import mesh

    mesh.wait_for_backend(args.device)
    dev = resolve_device(args.device)
    exp = setup_experiment(args, modes=("test",), data_dir=args.data_dir)
    ds_unstruct = exp.datasets["test"]
    # the model runs on the interpolated files' uniform grid
    pde_uniform = copy.deepcopy(exp.pde)
    pde_uniform.unstructured_grid = False
    ds_uniform = PDEDataset(
        resolve_data_path(args.data_dir, data_family(args.experiment),
                          args.experiment, "_I", "test"),
        pde_uniform, "test", base_resolution=tuple(args.base_resolution),
        super_resolution=tuple(args.super_resolution))
    spec = build_graph_spec(pde_uniform, ds_uniform, args.neighbors,
                            args.time_window, dev)
    trainer = Trainer(model=exp.trainer.model, kind=exp.trainer.kind,
                      spec=spec, eq_norms=exp.trainer.eq_norms)
    trainer.model.load_state_dict(load_checkpoint(args.model_to_test),
                                  strict=True)
    trainer.model.eval()
    print(f"Loaded checkpoint {args.model_to_test} (device {dev})")

    t_res = ds_uniform.nt
    u_uni, ub_uni, var_uni = device_arrays(ds_uniform, dev)
    bs, gt, tw = args.batch_size, args.nr_gt_steps, args.time_window
    out = {}
    # the full-horizon rollout runs once; every rollout metric reads it
    preds, trues = metrics.rollout_store(
        trainer, u_uni, var_uni, bs, gt, t_res,
        n_more_rollout=args.n_more_rollout)
    out["preds"], out["trues"] = preds, trues
    horizon = preds.shape[1] - args.n_more_rollout * tw

    print("**Interpolated-back L2 errors (test, unstructured grid)**")
    out["interp_L2"], out["interp_rel_L2"] = metrics.compute_l2_norms_u(
        trainer, u_uni, var_uni, ds_unstruct.u_super, ds_uniform.x,
        ds_unstruct.x, bs, gt, t_res, preds=preds[:, :horizon])

    print("**Uniform-grid (interpolated route) diagnostics**")
    metrics.test_timestep_losses(trainer, u_uni, var_uni, bs, t_res)
    out["test_loss"], out["test_base_loss"] = metrics.test_unrolled_losses(
        trainer, u_uni, ub_uni, var_uni, bs, gt, t_res,
        args.base_resolution[1])
    out["test_L2"], out["test_rel_L2"] = metrics.l2_norms_from_store(
        preds[:, :horizon], trues[:, :horizon])

    start = tw * gt
    out["trues_unstructured"] = np.asarray(
        ds_unstruct.u_super)[:, start:start + horizon]
    out["preds_interp_back"] = metrics.interp_rollout_to_unstructured(
        preds[:, :horizon], ds_uniform.x, ds_unstruct.x, dev)
    out["figures"] = _matplotlib()
    if out["figures"]:
        plot_rollouts(preds[:, :horizon], trues[:, :horizon], ds_uniform.x,
                      start_step=start)
        plot_interp_back(out["preds_interp_back"],
                         out["trues_unstructured"], ds_unstruct.x)
        print(f"Plots written to {PLOTS}/ (the interp-back comparison: "
              f"{PLOTS}/plot_interp_back.png)")
    else:
        print("matplotlib does not import here: the figures were skipped")
    if args.n_more_rollout:
        os.makedirs(PLOTS, exist_ok=True)
        np.save(f"{PLOTS}/long_rollout_interp_pred.npy", preds)
        if out["figures"]:
            plot_2d_system(preds, trues, n=1,
                           out_path=f"{PLOTS}/long_rollout_interp2d.png")
        print(f"Long rollout ({args.n_more_rollout} extra windows): "
              f"{PLOTS}/long_rollout_interp_pred.npy")
    return out


def build_parser():
    from msmp_pde_torch.training.train import build_parser as train_parser

    p = train_parser()
    p.description = ("Evaluate a model trained on the interpolated RPU "
                     "files on the unstructured grid")
    p.add_argument("--model_to_test", type=str, required=True,
                   help="the train CLI's checkpoint, or an .npz of the flax "
                        "params keyed by '/'-joined paths")
    p.add_argument("--n_more_rollout", type=int, default=0,
                   help="extra rollout windows past the data horizon")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
