"""Offline evaluation CLI (counterpart of msmp_pde_tpu/training/eval.py):

    python -m msmp_pde_torch.training.eval --experiment=E1 --model=BaseCNN \
        --model_to_test=models/<run>.pt [--n_more_rollout=N] [--device=cuda]

Loads a checkpoint (the train CLI's ``.pt`` or an ``.npz`` of flax paths,
as the server does) into any ported model, and prints on the test set the
space-time L2 / relative-L2 norms, the short-horizon norms
(``--short_horizon_windows``), the unrolled losses and the rollout store
behind the reference's figures, written to ``plots/`` where matplotlib
imports (one line says they were skipped where it does not, as on a
machine without it). ``--n_more_rollout`` rolls past the data horizon and
writes the predictions to ``plots/long_rollout_pred.npy``. ``main``
returns every metric printed, and the rollout store.

``--ks_spectrum`` (KS only) computes the reference's spectral
diagnostics of the first test sample's rollout and its ground truth with
the port's ``KS`` methods on the device in float64 (``ks_spectrum``),
writes them to ``plots/ks_spectrum.npz`` and returns them, and draws
``plots/ks_spectrum.png`` where matplotlib imports. ``--device`` is cuda
by default and raises without it.

Under ``torchrun --nproc_per_node N`` the metrics' batches are split over
the N ranks (training/metrics.py), as the JAX CLI shards them over its
mesh; ``--dp`` 0 takes the world size, another must equal it. Every rank
returns the same metrics; rank 0 prints and writes the files.
"""
from __future__ import annotations

import os

import numpy as np

PLOTS = "plots"


def plot_2d_system(pred, true, n=1, out_path=f"{PLOTS}/plot2d.png",
                   dpi=400):
    """The reference's 2x2 system heatmap figure: ground truth left,
    prediction right, one row per component, color scale [-3, 3],
    viridis, a shared colorbar."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = pred.shape[2]
    fig, axes = plt.subplots(ncols=2, nrows=max(d, 1), sharex=True,
                             sharey=True, figsize=(10, 5), squeeze=False)
    vmin, vmax, cmap = -3, 3, "viridis"
    axes[0][0].set_title("Ground Truth")
    axes[0][1].set_title("Prediction")
    for di in range(d):
        axes[di][0].imshow(true[n - 1, :, di, :].T, vmin=vmin, vmax=vmax,
                           cmap=cmap, aspect="auto")
        im = axes[di][1].imshow(pred[n - 1, :, di, :].T, vmin=vmin,
                                vmax=vmax, cmap=cmap, aspect="auto")
        axes[di][0].set_ylabel("Grid Point")
        twin = axes[di][1].twinx()
        twin.set_ylabel(rf"$u_{di + 1}$", fontsize=15, rotation=0,
                        labelpad=8)
        twin.set_yticks([])
    for ax in axes[-1]:
        ax.set_xlabel("Timestep")
    fig.subplots_adjust(right=0.8)
    cbar_ax = fig.add_axes([0.93, 0.18, 0.01, 0.7])
    fig.colorbar(im, cax=cbar_ax)
    plt.tight_layout(rect=[0, 0, 0.95, 1])
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def _curves(plt, preds, trues, x, titles, ylabels=None):
    """Prediction above ground truth, one curve a timestep colored by
    time; returns (fig, cmap, axes)."""
    T = preds.shape[1]
    fig, (ax1, ax2) = plt.subplots(2, sharex=True, sharey=True)
    cmap = plt.get_cmap("viridis")
    for ti in range(T):
        c = cmap(ti / max(T - 1, 1))
        ax1.plot(x, preds[0, ti, 0], color=c, lw=0.5)
        ax2.plot(x, trues[0, ti, 0], color=c, lw=0.5)
    ax1.set_title(titles[0])
    ax2.set_title(titles[1])
    if ylabels:
        ax1.set_ylabel(ylabels[0])
        ax2.set_ylabel(ylabels[1])
    ax2.set_xlabel(r"$x$")
    return fig, cmap, (ax1, ax2)


def plot_rollouts(preds, trues, x, out_dir=PLOTS, start_step=50, dpi=400):
    """The reference's figures: per-timestep rollout curves (plot1d.png),
    pred/true heatmaps (plot2d.png; the 2x2 system figure at d = 2) and
    the log-scale per-timestep relative error (plot_relerror.png).
    preds, trues: [N, T, d, nx]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.colors as mcolors
    import matplotlib.pyplot as plt

    from msmp_pde_torch.training.metrics import compute_space_l2_norms

    os.makedirs(out_dir, exist_ok=True)
    T, d = preds.shape[1], preds.shape[2]
    if d == 1:
        fig, cmap, (ax1, ax2) = _curves(
            plt, preds, trues, x, ("Prediction", "Ground Truth"),
            (r"$u_{\theta}(x)$", r"$u(x)$"))
        ax1.margins(x=0)
        ax2.margins(x=0)
        cbar = fig.colorbar(
            cm.ScalarMappable(norm=mcolors.Normalize(vmin=0, vmax=T),
                              cmap=cmap), ax=[ax1, ax2])
        cbar.set_label("Timestep", rotation=270, labelpad=16)
        fig.savefig(f"{out_dir}/plot1d.png", dpi=dpi)
        plt.close(fig)

        fig, (ax2, ax1) = plt.subplots(2, sharex=True, sharey=True)
        ax1.imshow(preds[0, :, 0].T, aspect="auto")
        ax2.imshow(trues[0, :, 0].T, aspect="auto")
        ax1.set_title("Prediction")
        ax2.set_title("Ground Truth")
        ax1.set_xlabel("Timestep")
        ax1.set_ylabel("Grid Point")
        ax2.set_ylabel("Grid Point")
        fig.savefig(f"{out_dir}/plot2d.png", dpi=dpi)
        plt.close(fig)
    else:
        plot_2d_system(preds, trues, n=1, out_path=f"{out_dir}/plot2d.png",
                       dpi=dpi)
        fig, _, _ = _curves(plt, preds, trues, x,
                            ("Prediction ($u_1$)", "Ground Truth ($u_1$)"))
        fig.savefig(f"{out_dir}/plot1d.png", dpi=dpi)
        plt.close(fig)

    _, rel = compute_space_l2_norms(preds, trues)
    fig, ax = plt.subplots()
    ax.set_yscale("log")
    ax.set_xlabel("Timestep")
    ax.set_ylabel("Relative Error %")
    fig.suptitle("Rollout Relative Error")
    ax.plot(list(range(start_step, start_step + T)), 100 * rel)
    fig.tight_layout()
    fig.savefig(f"{out_dir}/plot_relerror.png", dpi=dpi)
    plt.close(fig)


def ks_spectrum(pde, preds, trues, k_cut: float, device):
    """The KS diagnostics of ``plot_ks_spectrum`` (reference
    PDEs.py:773-817) of the first sample of preds, trues [N, T, 1, nx], in
    float64 on ``device``: for the prediction (``_pred``) and the truth
    (``_true``) the time-averaged spectrum ``Ek_k`` [nx], the total energy
    ``Ek_t`` [T] and its running average ``Ek_tt`` [T] (``KS.
    energy_spectrum``), the low-pass field ``filt`` [T, nx] and the
    residual's RMS ``resid_rms`` [T] (``KS.space_filter`` at ``k_cut``);
    and ``k``, the wavenumbers' magnitudes. Numpy arrays."""
    import torch

    out = {"k": np.abs(pde._k_grid())}
    for tag, arr in (("pred", preds), ("true", trues)):
        u = torch.as_tensor(np.asarray(arr[0, :, 0, :], np.float64),
                            device=device)
        ek = pde.energy_spectrum(u)
        filt, resid = pde.space_filter(u, k_cut)
        for name in ("Ek_k", "Ek_t", "Ek_tt"):
            out[f"{name}_{tag}"] = ek[name].cpu().numpy()
        out[f"filt_{tag}"] = filt.cpu().numpy()
        out[f"resid_rms_{tag}"] = torch.sqrt(
            torch.mean(resid ** 2, dim=-1)).cpu().numpy()
    return out


def plot_ks_spectrum(diag, k_cut: float = 2.0,
                     out_path=f"{PLOTS}/ks_spectrum.png", dpi=400):
    """The reference's KS diagnostics figure from ``ks_spectrum``'s
    arrays: the time-averaged spectrum and the total energy of prediction
    and truth, the truth's low-pass field, and the residual RMS. Raises
    where matplotlib does not import."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "the --ks_spectrum figure needs matplotlib, which does not "
            "import here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = diag["k"]
    nhalf = len(k) // 2
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    ax = axes[0][0]
    ax.loglog(k[1:nhalf], diag["Ek_k_true"][1:nhalf], label="truth")
    ax.loglog(k[1:nhalf], diag["Ek_k_pred"][1:nhalf], "--",
              label="prediction")
    ax.set_xlabel(r"$|k|$")
    ax.set_ylabel(r"$E_k$ (time-averaged)")
    ax.legend()
    ax = axes[0][1]
    ax.plot(diag["Ek_t_true"], label="truth")
    ax.plot(diag["Ek_t_pred"], "--", label="prediction")
    ax.set_xlabel("Timestep")
    ax.set_ylabel(r"$E(t)$")
    ax.legend()
    ax = axes[1][0]
    ax.imshow(diag["filt_true"].T, aspect="auto")
    ax.set_title(rf"truth, low-pass $|k|<{k_cut:g}$")
    ax.set_xlabel("Timestep")
    ax.set_ylabel("Grid Point")
    ax = axes[1][1]
    ax.plot(diag["resid_rms_true"], label="truth")
    ax.plot(diag["resid_rms_pred"], "--", label="prediction")
    ax.set_xlabel("Timestep")
    ax.set_ylabel("residual RMS")
    ax.legend()
    fig.suptitle("KS spectral diagnostics")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def _matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def main(args):
    """Returns {test_L2, test_rel_L2, [test_L2_short, test_rel_L2_short,]
    test_loss, test_base_loss, preds, trues, figures[, ks_spectrum]}: the
    metrics printed, the rollout store ([N, T, d, nx] each), whether the
    figures were written and ``ks_spectrum``'s arrays."""
    from msmp_pde_torch.device import resolve_device
    from msmp_pde_torch.parallel import mesh
    from msmp_pde_torch.training.train import check_dp

    if args.ks_spectrum and args.experiment != "KS":
        raise ValueError("--ks_spectrum is a KS-family diagnostic")
    mesh.init_distributed(args.device)
    mesh.wait_for_backend(args.device)
    dev = mesh.local_device(resolve_device(args.device))
    args.device = str(dev)
    check_dp(args, batch=False)
    with mesh.rank0_stdout():
        return _main(args, dev, lead=mesh.rank() == 0)


def _main(args, dev, lead: bool):
    from msmp_pde_torch.serving.serve import load_checkpoint
    from msmp_pde_torch.training import metrics
    from msmp_pde_torch.training.setup import setup_experiment
    from msmp_pde_torch.training.train import device_arrays

    exp = setup_experiment(args, modes=("test",), data_dir=args.data_dir)
    trainer = exp.trainer
    trainer.model.load_state_dict(load_checkpoint(args.model_to_test),
                                  strict=True)
    trainer.model.eval()
    print(f"Loaded checkpoint {args.model_to_test} (device {dev})")
    t_res = exp.datasets["test"].nt
    u_test, ub_test, var_test = device_arrays(exp.datasets["test"], dev)
    bs, gt = args.batch_size, args.nr_gt_steps
    out = {}

    print("**Dimensionless L2 errors (test)**")
    out["test_L2"], out["test_rel_L2"] = metrics.compute_l2_norms(
        trainer, u_test, var_test, bs, gt, t_res)
    shw = args.short_horizon_windows
    if shw:
        print(f"**Short-horizon L2 errors (first {shw} rollout windows)**")
        out["test_L2_short"], out["test_rel_L2_short"] = \
            metrics.compute_l2_norms(trainer, u_test, var_test, bs, gt,
                                     t_res, max_windows=shw)
    out["test_loss"], out["test_base_loss"] = metrics.test_unrolled_losses(
        trainer, u_test, ub_test, var_test, bs, gt, t_res,
        args.base_resolution[1])
    preds, trues = metrics.rollout_store(
        trainer, u_test, var_test, bs, gt, t_res,
        n_more_rollout=args.n_more_rollout)
    out["preds"], out["trues"] = preds, trues
    horizon = preds.shape[1] - args.n_more_rollout * args.time_window
    out["figures"] = lead and _matplotlib()
    if out["figures"]:
        plot_rollouts(preds[:, :horizon], trues[:, :horizon],
                      trainer.spec.x.cpu().numpy(),
                      start_step=args.time_window * gt)
        print(f"Plots written to {PLOTS}/")
    else:
        print("matplotlib does not import here: the figures were skipped")
    if args.ks_spectrum:
        diag = ks_spectrum(exp.pde, preds[:, :horizon], trues[:, :horizon],
                           args.ks_k_cut, dev)
        out["ks_spectrum"] = diag
        if lead:
            os.makedirs(PLOTS, exist_ok=True)
            np.savez(f"{PLOTS}/ks_spectrum.npz", **diag)
        if out["figures"]:
            plot_ks_spectrum(diag, args.ks_k_cut)
        print(f"KS spectral diagnostics: {PLOTS}/ks_spectrum.npz"
              + (f" + {PLOTS}/ks_spectrum.png" if out["figures"] else
                 " (the figure skipped: matplotlib does not import)"))
    if args.n_more_rollout and lead:
        os.makedirs(PLOTS, exist_ok=True)
        np.save(f"{PLOTS}/long_rollout_pred.npy", preds)
        if out["figures"]:
            plot_2d_system(preds, trues, n=1,
                           out_path=f"{PLOTS}/long_rollout2d.png")
        print(f"Long rollout ({args.n_more_rollout} extra windows): "
              f"{PLOTS}/long_rollout_pred.npy"
              + (f" + {PLOTS}/long_rollout2d.png" if out["figures"] else ""))
    return out


def build_parser():
    from msmp_pde_torch.training.train import build_parser as train_parser

    p = train_parser()
    p.description = "Evaluate a trained neural PDE solver"
    p.add_argument("--model_to_test", type=str, required=True,
                   help="the train CLI's checkpoint, or an .npz of the flax "
                        "params keyed by '/'-joined paths")
    p.add_argument("--n_more_rollout", type=int, default=0,
                   help="extra rollout windows past the data horizon")
    p.add_argument("--ks_spectrum", action="store_true",
                   help="KS only: the energy-spectrum and low-pass-filter "
                        "diagnostics to plots/ks_spectrum.npz (and .png "
                        "where matplotlib imports)")
    p.add_argument("--ks_k_cut", type=float, default=2.0,
                   help="wavenumber cutoff of the --ks_spectrum filter")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
