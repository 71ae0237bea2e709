"""Fused gated message-passing pair, forward (counterpart of
msmp_pde_tpu/ops/mp_pallas.py::fused_gated_pair).

``fused_gated_pair`` runs the hand-written kernel ``csrc/mp_pair_fwd.cu``
on CUDA tensors and the plain PyTorch version ``fused_gated_pair_plain``
on CPU tensors. A layer's weights are the 12-tuple
``(w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4)`` in the flax
layout (models/gnn.py::GNNLayer.weights).
"""
from __future__ import annotations

import ctypes

import torch

from msmp_pde_torch.models.common import instance_norm, swish
from msmp_pde_torch.ops import _build

launches = 0  # kernel launches since the last reset


def layer_plain(h, u, px, v, idx, mask, W):
    """One GNN_LayerLin: h [B, nx, H], u [B, nx, D], px [B, nx, 1],
    v [B, nx, V], idx/mask [nx, K] -> normalized output [B, nx, H]."""
    (w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4) = W
    mix = u @ w_du + px @ w_dx
    side_i = h @ w_hi + mix + v @ w_v + b1
    side_j = h @ w_hj - mix
    m = swish(side_i[:, :, None, :] + side_j[:, idx.long()])  # [B,nx,K,H]
    m = swish(m @ w2 + b2)
    deg = torch.clamp(mask.sum(-1), min=1.0)
    agg = (m * mask[None, :, :, None]).sum(2) / deg[None, :, None]
    upd = swish(torch.cat([h, agg, v], dim=-1) @ w3 + b3) @ w4 + b4
    return instance_norm(upd)


def fused_gated_pair_plain(h, u, px, v, idx, mask, Wg, Wl):
    """(1 - sigmoid(gn)) h + sigmoid(gn) swish(ln) with gn/ln the gate and
    main layers' normalized outputs."""
    tau = torch.sigmoid(layer_plain(h, u, px, v, idx, mask, Wg))
    ln = layer_plain(h, u, px, v, idx, mask, Wl)
    return (1.0 - tau) * h + tau * swish(ln)


def _lib():
    lib = _build.load("mp_pair_fwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mp_pair_fwd.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.mp_pair_fwd.restype = i
        lib._typed = True
    return lib


def _f32_cuda(name, x, shape):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"fused_gated_pair: {name} is {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"fused_gated_pair kernel: {name} must be a "
                         "float32 CUDA tensor")
    return x.contiguous()


def _weights(W, H, D, V, tag):
    shapes = [(H, H), (H, H), (D, H), (1, H), (V, H), (H,), (H, H), (H,),
              (2 * H + V, H), (H,), (H, H), (H,)]
    if len(W) != 12:
        raise ValueError("fused_gated_pair: a layer has 12 weight tensors")
    return [_f32_cuda(f"{tag}[{k}]", w, s)
            for k, (w, s) in enumerate(zip(W, shapes))]


def fused_gated_pair_kernel(h, u, px, v, idx, mask, Wg, Wl):
    """Launch ``csrc/mp_pair_fwd.cu``; raises on anything it does not take."""
    global launches
    B, nx, H = h.shape
    D, V, K = u.shape[-1], v.shape[-1], idx.shape[-1]
    h = _f32_cuda("h", h, (B, nx, H))
    u = _f32_cuda("u", u, (B, nx, D))
    px = _f32_cuda("px", px, (B, nx, 1))
    v = _f32_cuda("v", v, (B, nx, V))
    mask = _f32_cuda("mask", mask, (nx, K))
    if tuple(idx.shape) != (nx, K) or idx.device != h.device:
        raise ValueError("fused_gated_pair kernel: idx must be [nx, K] on "
                         "the inputs' device")
    idx = idx.to(torch.int32).contiguous()
    wg = _weights(Wg, H, D, V, "Wg")
    wl = _weights(Wl, H, D, V, "Wl")
    out = torch.empty_like(h)
    scratch = torch.empty(B * (6 * nx + nx * K) * H, device=h.device,
                          dtype=torch.float32)
    # The launch copies the pointer arrays into the kernel's arguments. The
    # tensors freed on return (scratch, contiguous copies) are reused only by
    # later work on this stream, which runs after the kernel.
    ptrs = lambda ws: (ctypes.c_void_p * 12)(*[w.data_ptr() for w in ws])
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = _lib().mp_pair_fwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), ptrs(wg), ptrs(wl),
            out.data_ptr(), scratch.data_ptr(), B, nx, H, D, V, K, stream)
    _build.check(err, "mp_pair_fwd")
    launches += 1
    return out


def fused_gated_pair(h, u, px, v, idx, mask, Wg, Wl):
    """CPU tensors -> ``fused_gated_pair_plain``; CUDA tensors -> the
    kernel."""
    if h.is_cuda:
        return fused_gated_pair_kernel(h, u, px, v, idx, mask, Wg, Wl)
    return fused_gated_pair_plain(h, u, px, v, idx, mask, Wg, Wl)
