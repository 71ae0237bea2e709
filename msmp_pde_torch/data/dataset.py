"""Dataset reader with super -> base down-projection (counterpart of
msmp_pde_tpu/data/dataset.py).

Reads one mode of a dataset file, the port's ``.npz`` or, where ``h5py``
imports, an ``.h5`` in the reference schema (datagen/hdf5_io.py), and
holds as numpy arrays:

* ``u_base``: the coarse numerical trajectories [N, nt, nx] (AD:
  [N, nt, 2, nx]);
* ``u_super``: the super-resolution trajectories down-projected to the
  base resolution, the training target:
  - CE and KS: temporal stride ``ratio_nt``, the periodic
    duplicated-endpoint pad (u[-3:-1] left, u[1:3] right), then the
    5-tap averaging kernel [0.2] * 5 with spatial stride ``ratio_nx``;
  - KF: the same on a zero pad (Dirichlet);
  - WE: temporal stride, then the ``ratio_nx``-wide mean kernel with
    stride ``ratio_nx``, no pad; the coordinates ``x`` are the super
    grid's, down-projected by the same kernel (the Chebyshev grid is not
    nested);
  - AD (stored [N, 2, nt, nx]): temporal stride ``ratio_nt``, then every
    second point ``u[..., 0:-1:2]``, laid out as [N, nt, 2, nx]; on the
    unstructured grid (RPU, ``pde.unstructured_grid``) the target is
    ``u_base`` itself, each resolution having its own grid;
* ``x``: the base coordinates (WE's as above; RPU's its stored LCG grid),
  and the equation's scalar ``variables``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from msmp_pde_torch.datagen.hdf5_io import open_dataset


def _avg_downproject(u: np.ndarray, ratio_nx: int,
                     pad: str = "periodic") -> np.ndarray:
    """5-tap [0.2] * 5 stride-``ratio_nx`` averaging along the last axis,
    on the periodic duplicated-endpoint pad or a zero pad (the JAX
    package's numpy path)."""
    if pad == "periodic":
        left, right = u[..., -3:-1], u[..., 1:3]
    elif pad == "zero":
        left = right = np.zeros_like(u[..., :2])
    else:
        raise ValueError(pad)
    up = np.concatenate([left, u, right], axis=-1)
    n_out = u.shape[-1] // ratio_nx
    idx = np.arange(n_out) * ratio_nx
    out = np.zeros(u.shape[:-1] + (n_out,), dtype=u.dtype)
    for j in range(5):
        out += 0.2 * up[..., idx + j]
    return out


def _mean_downproject(u: np.ndarray, ratio_nx: int) -> np.ndarray:
    """``ratio_nx``-wide mean kernel with stride ``ratio_nx``, no pad (WE;
    the JAX package's numpy path)."""
    n_out = u.shape[-1] // ratio_nx
    idx = np.arange(n_out) * ratio_nx
    out = np.zeros(u.shape[:-1] + (n_out,), dtype=u.dtype)
    for j in range(ratio_nx):
        out += u[..., idx + j] / ratio_nx
    return out


class PDEDataset:
    """One mode (train/valid/test) of a dataset file."""

    VAR_NAMES = {"CE": ("alpha", "beta", "gamma"), "KF": ("r", "D"),
                 "KS": (), "WE": ("bc_left", "bc_right", "c"),
                 "AD": ("a", "b")}

    def __init__(self, path: str, pde, mode: str, base_resolution=None,
                 super_resolution=None, dtype=np.float32):
        family = f"{pde}"
        if family not in self.VAR_NAMES:
            raise ValueError(f"unknown family {family!r}")
        self.pde = pde
        self.mode = mode
        self.base_resolution = tuple(base_resolution or (250, 100))
        self.super_resolution = tuple(super_resolution or (250, 200))
        key_base = "pde_%d-%d" % self.base_resolution
        key_super = "pde_%d-%d" % self.super_resolution

        with open_dataset(path) as f:
            u_base = f.array(f"{mode}/{key_base}")
            u_super = f.array(f"{mode}/{key_super}")
            attrs = f.attrs(f"{mode}/{key_base}")
            x_super = f.attrs(f"{mode}/{key_super}")["x"]
            self.variables: Dict[str, np.ndarray] = {
                name: f.array(f"{mode}/{name}")
                for name in self.VAR_NAMES[family]}
        if u_super.shape[-2] % u_base.shape[-2] or \
                u_super.shape[-1] % u_base.shape[-1]:
            raise ValueError(
                f"{path}: super resolution {u_super.shape[-2:]} is not a "
                f"multiple of the base resolution {u_base.shape[-2:]}")
        ratio_nt = u_super.shape[-2] // u_base.shape[-2]
        ratio_nx = u_super.shape[-1] // u_base.shape[-1]
        self.nt = int(attrs["nt"])
        self.dt = float(attrs["dt"])
        self.dx = float(attrs["dx"])
        self.tmin = float(attrs["tmin"])
        self.tmax = float(attrs["tmax"])
        x = np.asarray(attrs["x"], np.float64)

        if family == "AD":
            if getattr(pde, "unstructured_grid", False):
                u = np.swapaxes(u_base, 1, 2)
            else:
                u = np.swapaxes(u_super[:, :, ::ratio_nt][..., 0:-1:2], 1, 2)
            u_base = np.swapaxes(u_base, 1, 2)
        elif family == "WE":
            u = _mean_downproject(u_super[:, ::ratio_nt], ratio_nx)
            x = _mean_downproject(np.asarray(x_super, np.float64)[None],
                                  ratio_nx)[0]
        else:
            pad = "zero" if family == "KF" else "periodic"
            u = _avg_downproject(u_super[:, ::ratio_nt], ratio_nx, pad)
        self.u_base = u_base.astype(dtype)
        self.u_super = u.astype(dtype)
        self.x = x.astype(dtype)

    def __len__(self):
        return self.u_super.shape[0]

    @property
    def n_components(self) -> int:
        return self.pde.n_components
