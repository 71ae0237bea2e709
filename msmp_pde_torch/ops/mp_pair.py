"""Fused gated message-passing pair, forward and backward (counterpart of
msmp_pde_tpu/ops/mp_pallas.py::fused_gated_pair and its custom VJP).

``fused_gated_pair`` runs the hand-written kernels ``csrc/mp_pair_fwd.cu``
and ``csrc/mp_pair_bwd.cu`` on CUDA tensors and the plain PyTorch versions
``fused_gated_pair_plain`` / ``fused_gated_pair_bwd_plain`` on CPU tensors.
With grad enabled it goes through the ``torch.autograd.Function``
``FusedGatedPair``. Its backward takes one of two routes, chosen per shape
(``pair_bwd_fused_fits``) where the TPU's VJP chooses by its VMEM fit
(mp_pallas.py:700-730):
- the fused backward, which recomputes both layers from the saved inputs;
- where its workspace does not fit, the fallback: the
  forward's stash variant also returns the layers' normalized outputs gn
  and ln, the combine is differentiated in torch ops, and each layer's
  backward is one single-layer backward (ops/mp_layer.py).
Both layers are GNN_LayerLin (no final activation, no residual). A layer's
weights are the 12-tuple ``(w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3,
b3, w4, b4)`` in the flax layout (models/gnn.py::GNNLayer.weights).
"""
from __future__ import annotations

import torch

from msmp_pde_torch.models.common import swish
from msmp_pde_torch.ops import _build, mp_layer
from msmp_pde_torch.ops.mp_layer import (
    _dswish,
    _instnorm_bwd,
    _kernel_inputs,
    _layer_backward,
    _layer_forward,
    _lib,
    _ptrs,
    _split_grads,
    _weight_shapes,
    fused_mp_layer_plain,
)

launches = 0        # forward kernel launches since the last reset
stash_launches = 0  # of which with the gn/ln stash
bwd_launches = 0    # fused backward kernel launches since the last reset


def fused_gated_pair_plain(h, u, px, v, idx, mask, Wg, Wl, stash=False):
    """(1 - sigmoid(gn)) h + sigmoid(gn) swish(ln) with gn/ln the gate and
    main layers' normalized outputs; with ``stash`` returns (out, gn, ln)."""
    gn = fused_mp_layer_plain(h, u, px, v, idx, mask, Wg)
    ln = fused_mp_layer_plain(h, u, px, v, idx, mask, Wl)
    tau = torch.sigmoid(gn)
    out = (1.0 - tau) * h + tau * swish(ln)
    return (out, gn, ln) if stash else out


def fused_gated_pair_bwd_plain(h, u, px, v, idx, mask, Wg, Wl, g):
    """The pair's backward in the kernel's order: both layers' forwards,
    each once, with their intermediates kept; the combine's backward; each
    layer's InstanceNorm and layer backward. (The TPU kernel,
    mp_pallas.py:291-349, runs the gate's forward again after the main
    layer's backward, to hold one layer's intermediates at a time.) g is the
    output cotangent. Returns (dh, gate 12-tuple, main 12-tuple); u, px and
    v get none."""
    gn, rs_g, saved_g = _layer_forward(h, u, px, v, idx, mask, Wg)
    ln, rs_l, saved_l = _layer_forward(h, u, px, v, idx, mask, Wl)
    tau = torch.sigmoid(gn)
    dln = g * tau * _dswish(ln)
    dgn = g * (swish(ln) - h) * tau * (1.0 - tau)
    dh_l, dwl = _layer_backward(_instnorm_bwd(dln, ln, rs_l), h, u, px, v,
                                idx, mask, Wl, saved_l)
    dh_g, dwg = _layer_backward(_instnorm_bwd(dgn, gn, rs_g), h, u, px, v,
                                idx, mask, Wg, saved_g)
    return g * (1.0 - tau) + dh_g + dh_l, dwg, dwl


def fallback_bwd(h, u, px, v, idx, mask, Wg, Wl, gn, ln, g):
    """The fallback backward from the stashed gn, ln (mp_pallas.py:
    716-730): the combine's backward in torch ops, then one single-layer
    backward per layer (kernels on CUDA tensors). Returns (dh, gate
    12-tuple, main 12-tuple)."""
    tau = torch.sigmoid(gn)
    dgn = g * (swish(ln) - h) * tau * (1.0 - tau)
    dln = g * tau * _dswish(ln)
    dh_g, dwg = mp_layer.layer_backward(h, u, px, v, idx, mask, Wg, dgn,
                                        False, False)
    dh_l, dwl = mp_layer.layer_backward(h, u, px, v, idx, mask, Wl, dln,
                                        False, False)
    return g * (1.0 - tau) + dh_g + dh_l, dwg, dwl


# ---- the kernels ---------------------------------------------------------
def pair_bwd_fused_fits(B, nx, H, D, V, K, device) -> bool:
    """Whether the pair's backward takes the fused kernel for this shape.
    On the H100 the fused kernel is the faster route at every batch
    measured (PERF.md section 6: chip_smoke.py phase 16 prints both routes
    at batches 16 and 48). It holds both layers' intermediates at once, so
    its workspace is twice a single-layer backward's (~4 MB a graph at E1):
    the pair falls back to two single-layer backwards only where that
    workspace would pass a quarter of the card's memory (from batch ~5,000
    at E1 on an 80 GB card). True on the CPU, whose plain versions have no
    such limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    workspace = 4 * _lib("mp_pair_bwd").mp_pair_bwd_scratch_floats(
        B, nx, H, D, V, K)
    total = torch.cuda.get_device_properties(device).total_memory
    return workspace <= total // 4


def fused_gated_pair_kernel(h, u, px, v, idx, mask, Wg, Wl, stash=False):
    """Launch ``csrc/mp_pair_fwd.cu``; raises on anything it does not take.
    With ``stash`` returns (out, gn, ln)."""
    global launches, stash_launches
    (h, u, px, v, idx, mask), (wg, wl), (B, nx, H, D, V, K) = \
        _kernel_inputs("fused_gated_pair", h, u, px, v, idx, mask, Wg, Wl)
    out = torch.empty_like(h)
    gn, ln = (torch.empty_like(h), torch.empty_like(h)) if stash else (
        None, None)
    scratch = torch.empty(B * (6 * nx + nx * K) * H, device=h.device,
                          dtype=torch.float32)
    # The launch copies the pointer arrays into the kernel's arguments. The
    # tensors freed on return (scratch, contiguous copies) are reused only by
    # later work on this stream, which runs after the kernel.
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = _lib("mp_pair_fwd").mp_pair_fwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), _ptrs(wg), _ptrs(wl),
            out.data_ptr(), gn.data_ptr() if stash else None,
            ln.data_ptr() if stash else None, scratch.data_ptr(), B, nx, H,
            D, V, K, stream)
    _build.check(err, "mp_pair_fwd")
    launches += 1
    if stash:
        stash_launches += 1
        return out, gn, ln
    return out


def fused_gated_pair_bwd_kernel(h, u, px, v, idx, mask, Wg, Wl, g):
    """Launch ``csrc/mp_pair_bwd.cu``, one cooperative kernel over the
    whole batch; raises on anything it does not take. Returns (dh, gate
    12-tuple, main 12-tuple)."""
    global bwd_launches
    idx_in, mask_in = idx, mask
    (h, u, px, v, idx, mask), (wg, wl), (B, nx, H, D, V, K) = \
        _kernel_inputs("fused_gated_pair", h, u, px, v, idx, mask, Wg, Wl)
    rev_ptr, rev_e = mp_layer._inverse_of(idx_in, mask_in)
    g = mp_layer._f32_cuda("fused_gated_pair", "g", g, (B, nx, H))
    per_layer = sum(torch.Size(s).numel() for s in _weight_shapes(H, D, V))
    lib = _lib("mp_pair_bwd")
    f32 = dict(device=h.device, dtype=torch.float32)
    dh = torch.empty_like(h)
    dw = torch.empty(2 * per_layer, **f32)
    scratch = torch.empty(lib.mp_pair_bwd_scratch_floats(B, nx, H, D, V, K),
                          **f32)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = lib.mp_pair_bwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), rev_ptr.data_ptr(),
            rev_e.data_ptr(), _ptrs(wg), _ptrs(wl), g.data_ptr(),
            dh.data_ptr(), dw.data_ptr(), scratch.data_ptr(), B, nx, H, D,
            V, K, stream)
    _build.check(err, "mp_pair_bwd")
    bwd_launches += 1
    dwg, dwl = _split_grads(dw, H, D, V, 2)
    return dh, dwg, dwl


# ---- dispatch and autograd -----------------------------------------------
def _forward(h, u, px, v, idx, mask, Wg, Wl, stash=False):
    if h.is_cuda:
        return fused_gated_pair_kernel(h, u, px, v, idx, mask, Wg, Wl, stash)
    return fused_gated_pair_plain(h, u, px, v, idx, mask, Wg, Wl, stash)


def _backward(h, u, px, v, idx, mask, Wg, Wl, g):
    if h.is_cuda:
        return fused_gated_pair_bwd_kernel(h, u, px, v, idx, mask, Wg, Wl, g)
    return fused_gated_pair_bwd_plain(h, u, px, v, idx, mask, Wg, Wl, g)


class FusedGatedPair(torch.autograd.Function):
    """apply(h, u, px, v, idx, mask, *Wg, *Wl): the 24 weights are separate
    arguments so that autograd sees each. The backward returns dh and the
    24 weight gradients; u, px, v, idx and mask get none (the TPU VJP
    returns zeros for them, mp_pallas.py:715). Where the fused backward
    does not fit, the forward stashes gn and ln for the fallback."""

    @staticmethod
    def forward(ctx, h, u, px, v, idx, mask, *W):
        B, nx, H = h.shape
        ctx.fused = pair_bwd_fused_fits(B, nx, H, u.shape[-1], v.shape[-1],
                                        idx.shape[-1], h.device)
        if ctx.fused:
            ctx.save_for_backward(h, u, px, v, idx, mask, *W)
            return _forward(h, u, px, v, idx, mask, W[:12], W[12:])
        out, gn, ln = _forward(h, u, px, v, idx, mask, W[:12], W[12:],
                               stash=True)
        ctx.save_for_backward(h, u, px, v, idx, mask, *W, gn, ln)
        return out

    @staticmethod
    def backward(ctx, g):
        h, u, px, v, idx, mask, *rest = ctx.saved_tensors
        Wg, Wl = rest[:12], rest[12:24]
        if ctx.fused:
            dh, dwg, dwl = _backward(h, u, px, v, idx, mask, Wg, Wl, g)
        else:
            dh, dwg, dwl = fallback_bwd(h, u, px, v, idx, mask, Wg, Wl,
                                        *rest[24:], g)
        return (dh, None, None, None, None, None) + tuple(dwg) + tuple(dwl)


def fused_gated_pair(h, u, px, v, idx, mask, Wg, Wl):
    """CPU tensors -> the plain versions; CUDA tensors -> the kernels. With
    grad enabled and a differentiable input, through ``FusedGatedPair``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, *Wg, *Wl)):
        return FusedGatedPair.apply(h, u, px, v, idx, mask, *Wg, *Wl)
    return _forward(h, u, px, v, idx, mask, Wg, Wl)
