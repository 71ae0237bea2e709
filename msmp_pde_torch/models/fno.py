"""Fourier Neural Operator baselines: FNO, FNOP, VNO, FNO2D, FNO2DP and
FNO2DPU (counterpart of msmp_pde_tpu/models/fno.py).

Four spectral and pointwise layers with exact GELU, 16 modes, the grid
coordinate ``linspace(0, L, nx)`` (endpoint included, whatever the data
grid) appended to the input channels; the Param variants also append the
normalized equation variables. The spectral layer is ``torch.fft.rfft``,
a complex channel mix of the first modes (``torch.einsum``) and
``torch.fft.irfft`` (cuFFT and cuBLAS on the card), as the JAX package
leaves it to XLA. VNO1d's transform is a Vandermonde matrix of the grid's
positions, its cos and sin rounded to float32 as the JAX module rounds
them (held in non-persistent buffers, so the state dict is the flax
leaves alone).

Spectral weights are one real parameter ``[c_in, c_out, modes, 2]`` (real
and imaginary parts), as flax stores them; the complex weight is formed in
the forward, so the gradients are real.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msmp_pde_torch.models.common import Dense
from msmp_pde_torch.ops.interp import interp_matrix


def spectral_param(c_in: int, c_out: int, modes: int,
                   generator: torch.Generator):
    """``scale * U(0, 1)`` real and imaginary parts, scale = 1 / (c_in
    c_out) (the reference's ``torch.rand`` on a complex dtype)."""
    scale = 1.0 / (c_in * c_out)
    return nn.Parameter(
        scale * torch.rand((c_in, c_out, modes, 2), generator=generator))


def spectral_conv(x, w, modes: int):
    """x ``[B, nx, C]`` (real) -> ``[B, nx, O]``: rfft over nx, the first
    ``modes`` coefficients mixed by the complex ``w`` ``[C, O, modes, 2]``,
    irfft with the rest zero. The imaginary part of the zero frequency is
    dropped before the inverse, as a real inverse transform drops it
    (numpy's and the JAX package's do; cuFFT's result for such input is
    unspecified). The experiments' nx (40-100) keep the Nyquist frequency
    out of the 16 modes."""
    nx = x.shape[1]
    if nx // 2 + 1 < modes:
        raise ValueError(f"nx={nx} has {nx // 2 + 1} frequencies, fewer "
                         f"than the {modes} modes")
    x_ft = torch.fft.rfft(x, dim=1)[:, :modes]
    out = torch.einsum("bxi,iox->bxo", x_ft,
                       torch.complex(w[..., 0], w[..., 1]))
    imag = torch.cat([torch.zeros_like(out.imag[:, :1]), out.imag[:, 1:]], 1)
    return torch.fft.irfft(torch.complex(out.real, imag), n=nx, dim=1)


class SpectralConv1d(nn.Module):
    """The spectral layer with its weights (flax ``SpectralConv1d``)."""

    def __init__(self, in_channels: int, features: int, modes: int,
                 generator: torch.Generator):
        super().__init__()
        self.modes = modes
        self.weights = spectral_param(in_channels, features, modes,
                                      generator)

    def forward(self, x):
        return spectral_conv(x, self.weights, self.modes)


class _FNOCore(nn.Module):
    """Lift, 4 x (spectral + pointwise), project: ``[B, nx, C_in]`` ->
    ``[B, nx, out]``. The pointwise ``Conv1d(k=1)`` is a Dense over the
    channels."""

    def __init__(self, in_features: int, width: int, modes: int,
                 out_features: int, generator: torch.Generator):
        super().__init__()
        self.fc0 = Dense(in_features, width, generator)
        for i in range(4):
            setattr(self, f"conv{i}",
                    SpectralConv1d(width, width, modes, generator))
            setattr(self, f"w{i}", Dense(width, width, generator))
        self.fc1 = Dense(width, 128, generator)
        self.fc2 = Dense(128, out_features, generator)

    def forward(self, x):
        x = self.fc0(x)
        for i in range(4):
            x = getattr(self, f"conv{i}")(x) + getattr(self, f"w{i}")(x)
            if i < 3:
                x = F.gelu(x)
        return self.fc2(F.gelu(self.fc1(x)))


def _grid_channel(B: int, nx: int, domain, like):
    g = torch.linspace(domain[0], domain[1], nx, dtype=like.dtype,
                       device=like.device)
    return g[None, :, None].expand(B, nx, 1)


def _with_columns(x, var_cols, domain):
    """``[B, nx, C]`` with the variables (where given) and the grid
    coordinate appended as channels."""
    B, nx, _ = x.shape
    cols = [x]
    if var_cols is not None:
        cols.append(var_cols[:, None, :].expand(B, nx, var_cols.shape[-1]))
    cols.append(_grid_channel(B, nx, domain, x))
    return torch.cat(cols, dim=-1)


class FNO1d(nn.Module):
    """Input and output ``[B, tw, nx]``, no temporal residual. ``n_vars``
    > 0 is the Param variant (FNOP): ``var_cols`` ``[B, n_vars]``."""

    def __init__(self, tw: int, generator: torch.Generator, modes: int = 16,
                 width: int = 64, domain=(0.0, 16.0), n_vars: int = 0):
        super().__init__()
        self.domain, self.n_vars = tuple(domain), n_vars
        self._FNOCore_0 = _FNOCore(tw + n_vars + 1, width, modes, tw,
                                   generator)

    def forward(self, u, var_cols=None):
        x = _with_columns(u.transpose(1, 2),
                          var_cols if self.n_vars else None, self.domain)
        return self._FNOCore_0(x).transpose(1, 2)


class FNO2d(nn.Module):
    """The two-component system: input and output ``[B, tw, 2, nx]``,
    channels stacked t-major (``u.reshape(B, 2 tw, nx)``). ``n_vars`` > 0
    is FNO2DP. ``unstructured`` is FNO2DPU: the input is resampled from
    the grid ``x_coords`` [nx] onto the uniform ``linspace(*domain, nx)``
    before the core and the output back onto ``x_coords`` after it, each
    through ``ops/interp.py::interp_matrix``'s dense operator (built per
    call from ``x_coords``, as the JAX module builds it)."""

    def __init__(self, tw: int, generator: torch.Generator, modes: int = 16,
                 width: int = 128, domain=(0.0, 16.0), n_vars: int = 0,
                 unstructured: bool = False):
        super().__init__()
        self.domain, self.n_vars = tuple(domain), n_vars
        self.unstructured = unstructured
        self._FNOCore_0 = _FNOCore(2 * tw + n_vars + 1, width, modes, 2 * tw,
                                   generator)

    def forward(self, u, var_cols=None, x_coords=None):
        B, tw, d, nx = u.shape
        if self.unstructured:
            uniform = torch.linspace(self.domain[0], self.domain[1], nx,
                                     dtype=u.dtype, device=u.device)
            w_in = interp_matrix(x_coords, uniform).to(u.dtype)
            u = torch.einsum("ij,btdj->btdi", w_in, u)
        x = _with_columns(u.reshape(B, tw * d, nx).transpose(1, 2),
                          var_cols if self.n_vars else None, self.domain)
        out = self._FNOCore_0(x).transpose(1, 2).reshape(B, tw, d, nx)
        if self.unstructured:
            w_out = interp_matrix(uniform, x_coords).to(u.dtype)
            out = torch.einsum("ij,btdj->btdi", w_out, out)
        return out


class VNO1d(nn.Module):
    """Nonequispaced FNO on the grid ``positions`` [nx]: the forward
    transform ``x @ V^T`` and its inverse ``real(m @ conj(V))``, V = exp(-i
    k x) / sqrt(nx), written out in real and imaginary parts."""

    def __init__(self, tw: int, positions, generator: torch.Generator,
                 modes: int = 16, width: int = 64, domain=(0.0, 16.0)):
        super().__init__()
        if positions is None:
            raise ValueError("VNO needs the grid's positions")
        pos = np.asarray(positions, np.float64)
        nx = pos.shape[0]
        theta = np.outer(np.arange(modes), pos)  # [modes, nx]
        for name, f in (("c", np.cos), ("s", np.sin)):
            # float32, as the JAX module rounds them, in any dtype
            m = (f(theta) / np.sqrt(nx)).T.astype(np.float32)
            self.register_buffer(name, torch.from_numpy(m), persistent=False)
        self.domain = tuple(domain)
        self.fc0 = Dense(tw + 1, width, generator)
        for i in range(4):
            setattr(self, f"spec{i}",
                    spectral_param(width, width, modes, generator))
            setattr(self, f"w{i}", Dense(width, width, generator))
        self.fc1 = Dense(width, 128, generator)
        self.fc2 = Dense(128, tw, generator)

    def forward(self, u, var_cols=None):
        """``var_cols`` is not read."""
        x = self.fc0(_with_columns(u.transpose(1, 2), None, self.domain))
        x = x.transpose(1, 2)  # [B, W, nx]
        c, s = self.c.to(x.dtype), self.s.to(x.dtype)
        mix = lambda a, w: torch.einsum("bix,iox->box", a, w)  # noqa: E731
        for i in range(4):
            w = getattr(self, f"spec{i}")
            wr, wi = w[..., 0], w[..., 1]
            a, b = x @ c, -(x @ s)  # Re and Im of the forward transform
            mr = mix(a, wr) - mix(b, wi)
            mi = mix(a, wi) + mix(b, wr)
            x1 = mr @ c.T - mi @ s.T
            x2 = getattr(self, f"w{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = x1 + x2
            if i < 3:
                x = F.gelu(x)
        x = F.gelu(self.fc1(x.transpose(1, 2)))
        return self.fc2(x).transpose(1, 2)
