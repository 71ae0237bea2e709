"""Long Expressive Memory (LEM) cell scanned over the time window
(counterpart of msmp_pde_tpu/models/lem.py, its hoisted path).

Parameters keep the reference binding's layout: ``weights`` [3H, I+H]
computes both multi-scale gates and the z-candidate from [x_t, y];
``weights_lin_z`` [H, I+H] computes the y-candidate from [x_t, z'].

The input halves of both products are hoisted out of the recurrence as one
``[T*N, I] @ [I, 4H]`` product with plain autograd, as the JAX package
leaves them to XLA; the recurrence runs through ``ops/lem_scan.py`` (the
kernels on CUDA tensors; with grad, the ``LemScan`` Function's stash
forward and BPTT backward).
"""
from __future__ import annotations

import torch
from torch import nn

from msmp_pde_torch.models.common import uniform_param
from msmp_pde_torch.ops import lem_scan as lem_ops


class LEM(nn.Module):
    """inputs [T, N, I] -> (y_T [N, H], (y_T, z_T))."""

    def __init__(self, input_size: int, hidden: int,
                 generator: torch.Generator, dt: float = 1.0):
        super().__init__()
        H, I = hidden, input_size
        self.hidden, self.dt = hidden, dt
        # stdv = 1/sqrt(H) for every parameter
        self.weights = uniform_param((3 * H, I + H), H, generator)
        self.weights_lin_z = uniform_param((H, I + H), H, generator)
        self.bias = uniform_param((3 * H,), H, generator)
        self.bias_lin_z = uniform_param((H,), H, generator)

    def forward(self, inputs, initial_state=None):
        T, N, I = inputs.shape
        H = self.hidden
        W, Wz = self.weights, self.weights_lin_z
        if initial_state is None:
            zeros = inputs.new_zeros((N, H))
            initial_state = (zeros, zeros)
        proj = (inputs.reshape(T * N, I)
                @ torch.cat([W[:, :I], Wz[:, :I]], dim=0).T
                + torch.cat([self.bias, self.bias_lin_z]))
        gx = proj[:, :3 * H].reshape(T, N, 3 * H)
        zx = proj[:, 3 * H:].reshape(T, N, H)
        wy = W[:, I:].T.contiguous()
        wzz = Wz[:, I:].T.contiguous()
        yT, zT = lem_ops.lem_scan(gx, zx, initial_state[0], initial_state[1],
                                  wy, wzz, dt=float(self.dt))
        return yT, (yT, zT)
