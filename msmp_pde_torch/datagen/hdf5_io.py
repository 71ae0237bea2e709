"""Dataset files with the reference schema (counterpart of
msmp_pde_tpu/datagen/hdf5_io.py), and their reader.

One generated dataset is ``{stem}.npz`` always, and ``{stem}.h5`` as well
where ``h5py`` imports (the card's machine has no ``h5py``). Both hold all
three modes with one layout:

* ``{mode}/pde_{nt}-{nx}``: float64 [num_samples, nt, nx], or
  [num_samples, 2, nt, nx] for the two-component advection system, with
  the attributes dt, dx, nt, nx, tmin, tmax, x (in the ``.npz`` the array
  ``{mode}/pde_{nt}-{nx}/attrs/{name}`` each);
* the per-sample scalars, ``{mode}/alpha``, ``{mode}/beta``,
  ``{mode}/gamma`` (CE), ``{mode}/r``, ``{mode}/D`` (KF),
  ``{mode}/bc_left``, ``{mode}/bc_right`` (ints) and ``{mode}/c`` (WE) or
  ``{mode}/a``, ``{mode}/b`` (AD): [num_samples], float64 unless
  ``scalar_dtypes`` names another type.

The ``.h5`` is the JAX package's merged layout, so its reader takes the
port's data, and the port reads the JAX package's ``.h5`` files.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Sequence

import numpy as np

try:
    import h5py
except ImportError:  # the card's machine has no h5py: .npz only
    h5py = None

ATTRS = ("dt", "dx", "nt", "nx", "tmin", "tmax", "x")


def _attr_key(name: str, attr: str) -> str:
    return f"{name}/attrs/{attr}"


class ModeWriter:
    """Writes one mode group (train/valid/test) chunk by chunk, into the
    ``.npz``'s arrays in memory and into the ``.h5`` group where there is
    one. ``components`` > 1 puts a component axis after the samples'."""

    def __init__(self, arrays: Dict[str, np.ndarray], h5f, mode: str,
                 num_samples: int, resolutions: Dict[str, dict],
                 scalar_names: Sequence[str] = (), components: int = 1,
                 scalar_dtypes: Optional[Dict[str, type]] = None):
        self.mode = mode
        self.group = h5f.create_group(mode) if h5f is not None else None
        self.u, self.h5 = {}, {}
        lead = (num_samples,) if components == 1 else (num_samples,
                                                        components)
        for key, meta in resolutions.items():
            name = f"{mode}/{key}"
            shape = lead + (meta["nt"], meta["nx"])
            self.u[key] = arrays[name] = np.zeros(shape, np.float64)
            for attr in ATTRS:
                arrays[_attr_key(name, attr)] = np.asarray(meta[attr])
            if self.group is not None:
                ds = self.group.create_dataset(key, shape, dtype=float)
                for attr in ATTRS:
                    ds.attrs[attr] = meta[attr]
                self.h5[key] = ds
        scalar_dtypes = scalar_dtypes or {}
        for name in scalar_names:
            dt = scalar_dtypes.get(name, float)
            self.u[name] = arrays[f"{mode}/{name}"] = np.zeros(
                (num_samples,), dt)
            if self.group is not None:
                self.h5[name] = self.group.create_dataset(
                    name, (num_samples,), dtype=dt)

    def _put(self, key: str, start: int, vals: np.ndarray):
        self.u[key][start:start + vals.shape[0]] = vals
        if key in self.h5:
            self.h5[key][start:start + vals.shape[0]] = vals

    def write(self, key: str, start: int, traj: np.ndarray):
        # loud, not fatal: silent non-finite values once reached a training
        # set from a float32 overflow
        n_bad = int(traj.size - np.isfinite(traj).sum())
        if n_bad:
            print(f"WARNING: {n_bad}/{traj.size} non-finite values written to "
                  f"{self.mode}/{key}[{start}:{start + traj.shape[0]}]")
        self._put(key, start, traj)

    def write_scalar(self, name: str, start: int, vals):
        self._put(name, start, np.asarray(vals).reshape(-1))


class DatasetWriter:
    """``{stem}.npz`` (and ``{stem}.h5`` where ``h5py`` imports) of one
    dataset. Use as a context manager: the ``.npz`` is written on a clean
    exit only, through a temporary file and ``os.replace``, so a
    half-written ``.npz`` never exists under its name."""

    def __init__(self, stem: str):
        self.npz_path = f"{stem}.npz"
        self.h5_path = f"{stem}.h5" if h5py is not None else None
        self.arrays: Dict[str, np.ndarray] = {}
        self.h5f = None

    def __enter__(self):
        if self.h5_path is not None:
            self.h5f = h5py.File(self.h5_path, "w")
        return self

    def mode(self, mode: str, num_samples: int, resolutions: Dict[str, dict],
             scalar_names: Sequence[str] = (), components: int = 1,
             scalar_dtypes: Optional[Dict[str, type]] = None) -> ModeWriter:
        return ModeWriter(self.arrays, self.h5f, mode, num_samples,
                          resolutions, scalar_names, components,
                          scalar_dtypes)

    def __exit__(self, exc_type, exc, tb):
        if self.h5f is not None:
            self.h5f.close()
        if exc_type is None:
            tmp = f"{self.npz_path}.tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, **self.arrays)
            os.replace(tmp, self.npz_path)
        return False


class _NpzReader:
    def __init__(self, z):
        self._z = z

    def names(self):
        """Every dataset's ``{mode}/{key}``, the attributes' arrays left
        out."""
        return [n for n in self._z.files if n.count("/") == 1]

    def array(self, name: str) -> np.ndarray:
        return self._z[name]

    def attrs(self, name: str) -> dict:
        return {a: self._z[_attr_key(name, a)] for a in ATTRS}


class _H5Reader:
    def __init__(self, f):
        self._f = f

    def names(self):
        return [f"{mode}/{key}" for mode in self._f for key in self._f[mode]]

    def array(self, name: str) -> np.ndarray:
        return self._f[name][:]

    def attrs(self, name: str) -> dict:
        return {a: self._f[name].attrs[a] for a in ATTRS}


@contextlib.contextmanager
def open_dataset(path: str):
    """A reader of a ``.npz`` or ``.h5`` dataset file: ``array(name)`` and
    ``attrs(name)`` with names like ``"train/pde_250-100"``, and
    ``names()``, every such name in the file."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            yield _NpzReader(z)
    else:
        if h5py is None:
            raise RuntimeError(f"{path}: reading .h5 files needs h5py; "
                               "generate the .npz with the port's datagen")
        with h5py.File(path, "r") as f:
            yield _H5Reader(f)
