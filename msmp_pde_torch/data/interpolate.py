"""RPU's re-gridding (counterpart of msmp_pde_tpu/data/interpolate.py):
every trajectory of an unstructured-grid AD dataset interpolated onto the
uniform grid ``linspace(x0, xL, nx)`` of its resolution, written as the
``_I`` dataset:

    python -m msmp_pde_torch.data.interpolate --experiment=RPU \
        [--data_dir=data --device=cuda]

reads ``{data_dir}/AD_RPU.npz`` (or the ``.h5``; datagen/hdf5_io.py) and
writes ``{data_dir}/AD_RPU_I.npz`` (and ``.h5`` where ``h5py`` imports)
in the same schema: each resolution's attributes dt, nt, tmin and tmax
copied, dx = xL / nx, nx and the uniform x; the per-sample scalars (a,
b) copied, as the JAX package copies them (the reference left them
zero). One ``interp1d`` call a resolution and mode, in float64, on
``--device`` (cuda by default; raises without it).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def interpolate_file(src: str, dst_stem: str, x0: float = 0.0,
                     xL: float = 16.0, device=None):
    """Writes ``{dst_stem}.npz`` (and ``.h5``) from the dataset file
    ``src``; returns the writer's paths (npz, h5 or None)."""
    from msmp_pde_torch.datagen.hdf5_io import DatasetWriter, open_dataset
    from msmp_pde_torch.device import resolve_device
    from msmp_pde_torch.ops.interp import interp1d

    dev = resolve_device(device)
    with open_dataset(src) as fin:
        by_mode = {}
        for name in fin.names():
            mode, key = name.split("/")
            by_mode.setdefault(mode, []).append(key)
        with DatasetWriter(dst_stem) as out:
            for mode, keys in by_mode.items():
                trajs = {k: fin.array(f"{mode}/{k}") for k in keys
                         if "-" in k}
                scalars = {k: fin.array(f"{mode}/{k}") for k in keys
                           if "-" not in k}
                meta, out_u = {}, {}
                for key, u in trajs.items():
                    nx = u.shape[-1]
                    attrs = fin.attrs(f"{mode}/{key}")
                    x_struct = np.linspace(x0, xL, nx)
                    flat = torch.as_tensor(u.reshape(-1, nx),
                                           dtype=torch.float64, device=dev)
                    x_rand = torch.as_tensor(np.asarray(attrs["x"]),
                                             dtype=torch.float64, device=dev)
                    onto = interp1d(x_rand[None], flat,
                                    torch.as_tensor(x_struct, device=dev)[None])
                    out_u[key] = onto.cpu().numpy().reshape(u.shape)
                    meta[key] = {**{a: attrs[a] for a in
                                    ("dt", "nt", "tmin", "tmax")},
                                 "dx": xL / nx, "nx": nx, "x": x_struct}
                    print(f"{mode}/{key}: interpolated {u.shape}")
                u0 = next(iter(out_u.values()))
                w = out.mode(mode, u0.shape[0], meta, tuple(scalars),
                             components=u0.shape[1] if u0.ndim == 4 else 1,
                             scalar_dtypes={k: v.dtype.type
                                            for k, v in scalars.items()})
                for key, u in out_u.items():
                    w.write(key, 0, u)
                for key, v in scalars.items():
                    w.write_scalar(key, 0, v)
    return out.npz_path, out.h5_path


def main(args):
    from msmp_pde_torch.training.setup import resolve_data_path

    src = resolve_data_path(args.data_dir, "AD", args.experiment, "",
                            "train")
    if not os.path.exists(src):
        raise FileNotFoundError(f"no dataset {src}; generate it first")
    paths = interpolate_file(src, f"{args.data_dir}/AD_{args.experiment}_I",
                             0.0, args.domain_length, args.device)
    print("Wrote " + " and ".join(p for p in paths if p))
    return paths


def build_parser():
    p = argparse.ArgumentParser(description="Interpolate an unstructured "
                                "AD dataset onto the uniform grid")
    p.add_argument("--experiment", type=str, default="RPU")
    p.add_argument("--domain_length", type=float, default=16.0)
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without it) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
