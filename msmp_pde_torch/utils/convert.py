"""Weights carried across from the flax param tree.

The port's modules keep the flax names and layouts (Dense kernels
``[in, out]``, conv kernels ``(O, I, K)``, LEM blocks ``[3H, I+H]``), so a
leaf at flax path ``params/gnn_0/TorchDense_1/kernel`` is the state-dict
entry ``gnn_0.TorchDense_1.kernel``, unchanged; the 2-D models' leaves
(``double_mlp``, and an attention layer's ``lin``, ``lin_edge``,
``att_q``, ``att_k`` and ``bias``) carry across the same way.

An ``.npz`` checkpoint holds one array per leaf under its ``/``-joined flax
path (``params/embedding_lem/weights``, ...).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Nested mapping of numpy arrays (flax ``{"params": {...}}`` or its
    inner dict) -> state dict of CPU tensors."""
    if isinstance(tree, Mapping) and set(tree) == {"params"}:
        tree = tree["params"]
    return {".".join(path): torch.from_numpy(np.array(leaf))
            for path, leaf in _flatten(tree)}


def save_npz(path: str, state_dict: Mapping[str, torch.Tensor]):
    """State dict -> ``.npz`` with ``/``-joined flax paths as keys."""
    arrays = {"params/" + k.replace(".", "/"): v.detach().cpu().numpy()
              for k, v in state_dict.items()}
    np.savez(path, **arrays)


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """``.npz`` keyed by ``/``-joined flax paths -> state dict."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return params_from_flax(tree)
