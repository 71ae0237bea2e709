#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (an orbax directory, written by
its train CLI or params-only) into the ``.npz`` of flax paths that the
PyTorch port serves, evaluates and resumes from
(msmp_pde_torch/utils/convert.py::load_npz).

    python convert_jax_checkpoint.py --checkpoint=models/<run> \
        --out=<run>.npz --experiment=E1 --model=MSMP-PDE \
        [--time_window=25 --neighbors=3 --n_graph_layers=6 \
         --base_resolution 250 100 --super_resolution 250 200 \
         --data_dir=data --data_suffix= --dtype=float32]

then ``python -m msmp_pde_torch.serving.serve --checkpoint=<run>.npz``
with the same model arguments. Runs where JAX and orbax are installed (not
on a machine that has the port alone): it builds the JAX serving trainer
from the server's arguments, restores the parameters with
``msmp_pde_tpu.utils.checkpoint.restore_params`` (the train CLI's layout
or params-only) into the template of ``--dtype``, and writes one array a
leaf under its ``/``-joined flax path (``params/gnn_0/...``).
"""
import argparse
import os

import numpy as np


def flax_arrays(tree, prefix=()):
    """{"/"-joined path: numpy array} of a nested mapping of arrays."""
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(flax_arrays(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def convert(args):
    """Restore ``args.checkpoint`` and write ``args.out``; returns the
    arrays written."""
    import jax

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    from msmp_pde_tpu.serving.engine import build_serving_trainer
    from msmp_pde_tpu.training.setup import data_family, resolve_data_path
    from msmp_pde_tpu.utils.checkpoint import restore_params

    data_path = None
    if args.data_dir:
        p = resolve_data_path(args.data_dir, data_family(args.experiment),
                              args.experiment, args.data_suffix, "test")
        data_path = p if os.path.exists(p) else None
    trainer = build_serving_trainer(
        args.experiment, args.model,
        base_resolution=tuple(args.base_resolution),
        super_resolution=tuple(args.super_resolution),
        neighbors=args.neighbors, time_window=args.time_window,
        n_graph_layers=args.n_graph_layers, data_path=data_path,
        mp_precision=args.mp_precision, data_suffix=args.data_suffix)
    template = jax.tree.map(lambda a: np.asarray(a, args.dtype),
                            trainer.init_params(jax.random.PRNGKey(0)))
    params = restore_params(args.checkpoint, trainer, template)
    arrays = flax_arrays(params)
    if not all(k.startswith("params/") for k in arrays):
        arrays = {f"params/{k}": v for k, v in arrays.items()}
    np.savez(args.out, **arrays)
    print(f"{args.checkpoint} -> {args.out}: {len(arrays)} arrays, "
          f"{sum(a.size for a in arrays.values())} parameters")
    return arrays


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", type=str, required=True,
                   help="the JAX checkpoint directory")
    p.add_argument("--out", type=str, required=True, help="the .npz to write")
    p.add_argument("--experiment", type=str, required=True)
    p.add_argument("--model", type=str, default="MSMP-PDE")
    p.add_argument("--base_resolution", type=int, nargs=2, default=[250, 100])
    p.add_argument("--super_resolution", type=int, nargs=2,
                   default=[250, 200])
    p.add_argument("--neighbors", type=int, default=3)
    p.add_argument("--time_window", type=int, default=25)
    p.add_argument("--n_graph_layers", type=int, default=6)
    p.add_argument("--data_dir", type=str, default="data",
                   help="the grid's dataset, as the server reads it ('' or "
                        "a directory without it: the uniform grid)")
    p.add_argument("--data_suffix", type=str, default="")
    p.add_argument("--mp_precision", type=str, default="float32")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64"],
                   help="the restore template's dtype: the checkpoint's")
    return p


if __name__ == "__main__":
    convert(build_parser().parse_args())
