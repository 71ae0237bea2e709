"""Residual CNN baselines, BaseCNN and BaseCNN2D (counterpart of
msmp_pde_tpu/models/cnn.py).

Eight circular-padded 1-D convolutions with kernels 3, 5, 5, 5, 7, 7, 7, 9,
ELU activations and residuals from the second on; Xavier kernels. Time is
stacked in channels (tw, or 2 tw t-major for the two-component system).
The convolutions are ``torch.nn.functional.conv1d`` (cuDNN on the card),
as the JAX package leaves them to XLA.

The output quirks of the reference stay:
  * d = 1: ``u_last + cumsum(dt) * diff``;
  * d = 2: ``u + cumsum(dt) * diff``, a residual from the whole window.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from msmp_pde_torch.models.common import Conv1d

KERNELS = (3, 5, 5, 5, 7, 7, 7, 9)


class _CircularConv(nn.Module):
    """Circular padding, then a valid convolution (torch's
    ``padding_mode='circular'``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 generator: torch.Generator):
        super().__init__()
        self.p = kernel_size // 2
        self.TorchConv1d_0 = Conv1d(in_channels, features, kernel_size, 1,
                                    generator, xavier=True)

    def forward(self, x):
        p = self.p
        return self.TorchConv1d_0(
            torch.cat([x[..., -p:], x, x[..., :p]], dim=-1))


class BaseCNN(nn.Module):
    """Input and output ``[B, tw, nx]`` (d = 1) or ``[B, tw, 2, nx]``
    (d = 2). Hidden width 40 at d = 1 and 128 at d = 2, whatever
    ``hidden_channels`` says (the reference's 2-D model fixes it)."""

    def __init__(self, tw: int, dt: float, generator: torch.Generator,
                 hidden_channels: int = 40, n_components: int = 1):
        super().__init__()
        self.tw, self.dt, self.d = tw, dt, n_components
        hidden = hidden_channels if n_components == 1 else 128
        c_in = c_out = n_components * tw
        widths = [c_in] + [hidden] * 7 + [c_out]
        for i, k in enumerate(KERNELS):
            setattr(self, f"_CircularConv_{i}",
                    _CircularConv(widths[i], widths[i + 1], k, generator))

    def forward(self, u, var_cols=None):
        """``var_cols`` is not read (the CNN takes no equation
        variables)."""
        d, tw = self.d, self.tw
        x = u if d == 1 else u.reshape(u.shape[0], 2 * tw, u.shape[-1])
        x = F.elu(self._CircularConv_0(x))
        for i in range(1, 7):
            x = x + F.elu(getattr(self, f"_CircularConv_{i}")(x))
        diff = self._CircularConv_7(x)
        dt_cum = torch.cumsum(
            torch.full((tw,), self.dt, dtype=u.dtype, device=u.device), 0)
        if d == 1:
            return u[:, -1:, :] + dt_cum[None, :, None] * diff
        diff = diff.reshape(diff.shape[0], tw, 2, diff.shape[-1])
        return u + dt_cum[None, :, None, None] * diff
