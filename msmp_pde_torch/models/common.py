"""Shared model building blocks (counterpart of msmp_pde_tpu/models/common.py).

Parameters keep the flax layout so that converted weights load as they
are: a Dense kernel is ``[in, out]`` and applies as ``x @ w + b``; a conv
kernel is ``(O, I, K)``, which is already PyTorch's layout. Every
parameter initializes U(-1/sqrt(fan_in), +1/sqrt(fan_in)) from an explicit
``torch.Generator``, but for the Xavier option of ``Conv1d`` (BaseCNN's
kernels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def uniform_param(shape, fan_in: int, generator: torch.Generator):
    bound = 1.0 / (fan_in ** 0.5)
    return nn.Parameter(
        torch.empty(shape).uniform_(-bound, bound, generator=generator))


def swish(x, beta: float = 1.0):
    """x * sigmoid(beta x)."""
    return x * torch.sigmoid(beta * x)


class Dense(nn.Module):
    """Dense layer, kernel ``[in, out]`` (flax ``TorchDense``)."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator):
        super().__init__()
        self.kernel = uniform_param((in_features, features), in_features,
                                    generator)
        self.bias = uniform_param((features,), in_features, generator)

    def forward(self, x):
        return x @ self.kernel + self.bias


class Conv1d(nn.Module):
    """1-D convolution over the last axis, valid padding: input
    ``[..., C_in, W]`` -> ``[..., C_out, W_out]`` (flax ``TorchConv1d``).
    With ``xavier`` the kernel draws U(+-sqrt(6 / (fan_in + fan_out))),
    fan_out = features * kernel_size; the bias keeps the fan-in bound."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int, generator: torch.Generator,
                 xavier: bool = False):
        super().__init__()
        fan_in = in_channels * kernel_size
        self.stride = stride
        shape = (features, in_channels, kernel_size)
        if xavier:
            b = (6.0 / (fan_in + features * kernel_size)) ** 0.5
            self.kernel = nn.Parameter(
                torch.empty(shape).uniform_(-b, b, generator=generator))
        else:
            self.kernel = uniform_param(shape, fan_in, generator)
        self.bias = uniform_param((features,), fan_in, generator)

    def forward(self, x):
        lead = x.shape[:-2]
        out = F.conv1d(x.reshape((-1,) + x.shape[-2:]), self.kernel,
                       self.bias, stride=self.stride)
        return out.reshape(lead + out.shape[-2:])


def instance_norm(h, eps: float = 1e-5):
    """Per-graph, per-feature normalization over the node axis of
    ``[B, nx, F]`` (biased variance)."""
    mean = h.mean(dim=1, keepdim=True)
    var = ((h - mean) ** 2).mean(dim=1, keepdim=True)
    return (h - mean) * torch.rsqrt(var + eps)


# Decoder CNN per time window: (channels, kernel, stride) of the first conv;
# the second conv's kernel is derived so that exactly tw outputs remain.
DECODER_CONV = {
    20: (8, 15, 4),
    25: (8, 16, 3),
    50: (8, 12, 2),
}


class WindowDecoder(nn.Module):
    """Two-conv decoder: the hidden vector as a length-H signal -> tw
    values per output channel."""

    def __init__(self, tw: int, hidden: int, generator: torch.Generator,
                 out_channels: int = 1, in_channels: int = 1):
        super().__init__()
        c1, k1, s1 = DECODER_CONV[tw]
        L1 = (hidden - k1) // s1 + 1
        k2 = L1 - tw + 1
        if k2 < 1:
            raise ValueError(
                f"hidden width {hidden} too small for the tw={tw} decoder "
                f"(first conv leaves {L1} < tw positions); need H >= "
                f"{k1 + s1 * (tw - 1)}"
            )
        self.TorchConv1d_0 = Conv1d(in_channels, c1, k1, s1, generator)
        self.TorchConv1d_1 = Conv1d(c1, out_channels, k2, 1, generator)

    def forward(self, x):
        return self.TorchConv1d_1(swish(self.TorchConv1d_0(x)))


class GLUConv(nn.Module):
    """Half-hidden decoder conv of the GLU variants (flax ``GLUConv``): at
    hidden 164, 82 -> (k 6, s 2) -> 39 -> (k 15) -> 25 outputs."""

    def __init__(self, tw: int, half: int, generator: torch.Generator,
                 out_channels: int = 1, in_channels: int = 1):
        super().__init__()
        if ((half - 6) // 2 + 1) - 15 + 1 != tw:
            raise ValueError(f"the GLU decoder maps {half} features to "
                             f"{(half - 6) // 2 - 13} outputs, not tw={tw}; "
                             "it takes hidden 164 at tw=25")
        self.TorchConv1d_0 = Conv1d(in_channels, 8, 6, 2, generator)
        self.TorchConv1d_1 = Conv1d(8, out_channels, 15, 1, generator)

    def forward(self, x):
        return self.TorchConv1d_1(swish(self.TorchConv1d_0(x)))


_VAR_ORDER = ("alpha", "beta", "gamma", "bc_left", "bc_right", "c", "D",
              "r", "a", "b")


def assemble_variables(t, eq_vars: dict, norms: dict, tmax: float):
    """``[B, V]`` model variables: normalized time first, then each equation
    parameter over its norm, in the reference's key order; ``beta`` is
    negated and the boundary flags are not normalized."""
    cols = [t / tmax]
    for name in _VAR_ORDER:
        if name in norms:
            v = eq_vars[name]
            if name == "beta":
                v = -v
            if name not in ("bc_left", "bc_right"):
                v = v / norms[name]
            cols.append(v)
    return torch.stack(cols, dim=-1)
