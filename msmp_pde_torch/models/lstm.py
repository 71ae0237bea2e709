"""LSTM temporal encoder (counterpart of msmp_pde_tpu/models/gnn.py::
MPSolver._lstm, a scan of flax's ``OptimizedLSTMCell``).

Per step: i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of x Wi_q + h Wh_q +
b_q (gate order i, f, g, o); c' = f c + i g; h' = o tanh(c'). The carry
starts at zeros and the encoder returns the last h. The parameters keep the
flax tree, ``lstm/{ii,if,ig,io}/kernel`` [I, H] (no bias) and
``lstm/{hi,hf,hg,ho}/{kernel,bias}``, every one U(+-1/sqrt(H)).

The input products are hoisted out of the recurrence as one
``[T*N, I] @ [I, 4H]`` product; the 25 steps are plain torch ops with
autograd on every device. The JAX package leaves the LSTM to XLA (it has
no Pallas kernel), so the port has no kernel for it either.
"""
from __future__ import annotations

import torch
from torch import nn

from msmp_pde_torch.models.common import uniform_param

GATES = "ifgo"


class _Kernel(nn.Module):
    """A flax ``DenseParams``: kernel [in, out] and, with ``bias``, a bias;
    U(+-1/sqrt(fan)) with the LSTM's fan, the hidden width."""

    def __init__(self, in_features: int, features: int, bias: bool,
                 fan: int, generator: torch.Generator):
        super().__init__()
        self.kernel = uniform_param((in_features, features), fan, generator)
        if bias:
            self.bias = uniform_param((features,), fan, generator)


class LSTM(nn.Module):
    """inputs [T, N, I] -> h_T [N, H]."""

    def __init__(self, input_size: int, hidden: int,
                 generator: torch.Generator):
        super().__init__()
        self.hidden = hidden
        for q in GATES:
            # "if" is a Python keyword: the children are registered by name
            self.add_module(f"i{q}", _Kernel(input_size, hidden, False,
                                             hidden, generator))
            self.add_module(f"h{q}", _Kernel(hidden, hidden, True, hidden,
                                             generator))

    def forward(self, inputs):
        T, N, I = inputs.shape
        H = self.hidden
        part = lambda name: [getattr(self, f"{name}{q}") for q in GATES]
        w_i = torch.cat([m.kernel for m in part("i")], dim=1)  # [I, 4H]
        w_h = torch.cat([m.kernel for m in part("h")], dim=1)  # [H, 4H]
        b_h = torch.cat([m.bias for m in part("h")])
        gx = (inputs.reshape(T * N, I) @ w_i).reshape(T, N, 4 * H)
        h = c = inputs.new_zeros((N, H))
        for t in range(T):
            g = h @ w_h + b_h + gx[t]
            i = torch.sigmoid(g[:, :H])
            f = torch.sigmoid(g[:, H:2 * H])
            c = f * c + i * torch.tanh(g[:, 2 * H:3 * H])
            h = torch.sigmoid(g[:, 3 * H:]) * torch.tanh(c)
        return h
