"""Ahead-of-time export of a rollout program (counterpart of
msmp_pde_tpu/serving/export.py) with ``torch.export``.

``export_rollout`` freezes the model, the engine's weights, the horizon
and the batch into one artifact (``torch.export.save``'s archive): the
engine's ``RolloutProgram``, traced under ``torch.no_grad`` through the
kernels' ``torch.library`` ops (ops/library.py), so that a replay launches
the same kernels in the same order as ``RolloutEngine.rollout``. The
loader needs torch and the op registrations (``import
msmp_pde_torch.ops``) only: it builds no model and reads no checkpoint.

The artifact runs on the device it was exported on (the JAX export's
``platforms``): ``load_exported(..., device=...)`` moves its weights,
constants and device arguments elsewhere with
``torch.export.passes.move_to_device_pass``, and each op then dispatches
by its tensors' device (the kernels on a card, the plain versions on the
CPU).
"""
from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as np
import torch


def export_rollout(engine, batch: int, n_windows: int,
                   path: Optional[str] = None) -> bytes:
    """Export ``engine``'s rollout of ``n_windows`` windows at a fixed
    ``batch`` on its first replica's device, the weights in the artifact.
    Returns the artifact's bytes; also writes ``path`` when given."""
    trainer = engine.trainer
    dev = trainer.device
    nx, dtw = int(trainer.spec.nx), trainer.d * trainer.tw
    args = (torch.zeros((batch, nx, dtw), dtype=torch.float32, device=dev),
            torch.full((batch,), trainer.tw, dtype=torch.int64, device=dev),
            {k: torch.zeros((batch,), dtype=torch.float32, device=dev)
             for k in trainer.eq_norms})
    with torch.no_grad():
        exported = torch.export.export(engine.program(n_windows), args)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


class ExportedRollout:
    """Callable over a loaded artifact, numpy in and out as
    ``RolloutEngine.rollout`` (the artifact's batch and horizon):
    (window [B, nx, d*tw], steps [B], {name: [B]}) -> [B, S, nx, d*tw]."""

    def __init__(self, blob: bytes, device=None):
        import msmp_pde_torch.ops  # noqa: F401  (the msmp ops)

        exported = torch.export.load(io.BytesIO(bytes(blob)))
        if device is not None:
            from torch.export.passes import move_to_device_pass

            exported = move_to_device_pass(exported, torch.device(device))
        self.exported = exported
        self._module = exported.module()
        # where its weights are, which is where it runs
        self.device = next(iter(exported.state_dict.values())).device

    def __call__(self, window, steps, variables: Dict) -> np.ndarray:
        dev = self.device
        with torch.no_grad():
            out = self._module(
                torch.as_tensor(np.asarray(window, np.float32), device=dev),
                torch.as_tensor(np.asarray(steps), dtype=torch.int64,
                                device=dev),
                {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                 for k, v in variables.items()})
        return out.cpu().numpy()


def load_exported(path_or_bytes, device=None) -> ExportedRollout:
    """The artifact of ``export_rollout``, from its bytes or a path; on
    ``device`` where given, else where it was exported."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return ExportedRollout(path_or_bytes, device)
    with open(path_or_bytes, "rb") as f:
        return ExportedRollout(f.read(), device)
