"""Checkpoints (counterpart of msmp_pde_tpu/utils/checkpoint.py): one
``torch.save`` file with the model's state dict, and for a training
checkpoint AdamW's state, the learning-rate schedule's state and the
epoch, so that a run resumes where it stopped.

A checkpoint is written to a temporary file beside its path and moved
there with ``os.replace``, so a file under the checkpoint's name is always
complete (the orbax checkpoints of the JAX package mark completion with a
metadata file instead).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(path: str, model, tx=None, epoch: Optional[int] = None):
    """``tx`` the (AdamW, LambdaLR) pair of ``Trainer.make_optimizer``."""
    payload = {"model": model.state_dict()}
    if tx is not None:
        opt, sched = tx
        payload["optimizer"] = opt.state_dict()
        payload["scheduler"] = sched.state_dict()
    if epoch is not None:
        payload["epoch"] = epoch
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, model, tx=None) -> int:
    """Load a training checkpoint into ``model`` (and ``tx``'s optimizer
    and schedule); returns its epoch."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    if tx is not None:
        opt, sched = tx
        opt.load_state_dict(payload["optimizer"])
        sched.load_state_dict(payload["scheduler"])
    return int(payload["epoch"])


def restore_params(path: str) -> Dict[str, torch.Tensor]:
    """The model's state dict from a training checkpoint or from a
    params-only one (a bare state dict)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["model"] if "model" in payload else payload
