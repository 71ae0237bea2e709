"""Fused gated message-passing pair, forward and backward (counterpart of
msmp_pde_tpu/ops/mp_pallas.py::fused_gated_pair and its custom VJP).

``fused_gated_pair`` runs the hand-written kernels ``csrc/mp_pair_fwd.cu``
and ``csrc/mp_pair_bwd.cu`` on CUDA tensors and the plain PyTorch versions
``fused_gated_pair_plain`` / ``fused_gated_pair_bwd_plain`` on CPU tensors,
each direction through its ``torch.library`` op (``msmp::pair_fwd``,
``msmp::pair_bwd``; ops/library.py). With grad enabled it goes through the ``torch.autograd.Function``
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
``mp_precision`` is the single layer's (ops/mp_layer.py): in the storage
mode ``bfloat16s`` the combine and the fused backward's dgn take the
rounded h, while the fallback's combine backward, in torch ops outside the
kernels, takes the caller's float32 h, as the TPU's fallback does
(mp_pallas.py:718-720).
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
    _scratch,
    _split_grads,
    _weight_shapes,
    mode_of,
    plain_inputs,
)
from msmp_pde_torch import tracing

launches = 0        # forward kernel launches since the last reset
stash_launches = 0  # of which with the gn/ln stash
bwd_launches = 0    # fused backward kernel launches since the last reset


def fused_gated_pair_plain(h, u, px, v, idx, mask, Wg, Wl, stash=False,
                           mp_precision="float32"):
    """(1 - sigmoid(gn)) h + sigmoid(gn) swish(ln) with gn/ln the gate and
    main layers' normalized outputs; with ``stash`` returns (out, gn, ln)."""
    mode = mode_of(mp_precision)
    h, u, px, v, Wg, Wl = plain_inputs(mode, h, u, px, v, Wg, Wl)
    gn = _layer_forward(h, u, px, v, idx, mask, Wg, mode=mode)[0]
    ln = _layer_forward(h, u, px, v, idx, mask, Wl, mode=mode)[0]
    tau = torch.sigmoid(gn)
    out = (1.0 - tau) * h + tau * swish(ln)
    return (out, gn, ln) if stash else out


def fused_gated_pair_bwd_plain(h, u, px, v, idx, mask, Wg, Wl, g,
                               mp_precision="float32"):
    """The pair's backward in the kernel's order: both layers' forwards,
    each once, with their intermediates kept; the combine's backward; each
    layer's InstanceNorm and layer backward. (The TPU kernel,
    mp_pallas.py:291-349, runs the gate's forward again after the main
    layer's backward, to hold one layer's intermediates at a time.) g is the
    output cotangent. Returns (dh, gate 12-tuple, main 12-tuple); u, px and
    v get none."""
    mode = mode_of(mp_precision)
    h, u, px, v, Wg, Wl = plain_inputs(mode, h, u, px, v, Wg, Wl)
    gn, rs_g, saved_g = _layer_forward(h, u, px, v, idx, mask, Wg, mode=mode)
    ln, rs_l, saved_l = _layer_forward(h, u, px, v, idx, mask, Wl, mode=mode)
    tau = torch.sigmoid(gn)
    dln = g * tau * _dswish(ln)
    dgn = g * (swish(ln) - h) * tau * (1.0 - tau)
    dh_l, dwl = _layer_backward(_instnorm_bwd(dln, ln, rs_l), h, u, px, v,
                                idx, mask, Wl, saved_l, mode=mode)
    dh_g, dwg = _layer_backward(_instnorm_bwd(dgn, gn, rs_g), h, u, px, v,
                                idx, mask, Wg, saved_g, mode=mode)
    return g * (1.0 - tau) + dh_g + dh_l, dwg, dwl


def fallback_bwd(h, u, px, v, idx, mask, Wg, Wl, gn, ln, g,
                 mp_precision="float32"):
    """The fallback backward from the stashed gn, ln (mp_pallas.py:
    716-730): the combine's backward in torch ops, on the caller's h also
    in the storage mode, then one single-layer backward per layer (kernels
    on CUDA tensors). Returns (dh, gate 12-tuple, main 12-tuple)."""
    tau = torch.sigmoid(gn)
    dgn = g * (swish(ln) - h) * tau * (1.0 - tau)
    dln = g * tau * _dswish(ln)
    dh_g, dwg = mp_layer.layer_backward(h, u, px, v, idx, mask, Wg, dgn,
                                        False, False, mp_precision)
    dh_l, dwl = mp_layer.layer_backward(h, u, px, v, idx, mask, Wl, dln,
                                        False, False, mp_precision)
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


def fused_gated_pair_kernel(h, u, px, v, idx, mask, Wg, Wl, stash=False,
                            mp_precision="float32", workspace=None):
    """Launch ``csrc/mp_pair_fwd.cu``, one cooperative kernel over the whole
    batch, in ``mp_precision``; raises on anything it does not take. With
    ``stash`` returns (out, gn, ln). A ``workspace`` (float32,
    ``mp_pair_fwd_scratch_floats``) is used as the kernel's and then holds
    the intermediates it leaves there (csrc/mp_phases.cuh::layer_bufs)."""
    global launches, stash_launches
    mode = mode_of(mp_precision)
    (h, u, px, v, idx, mask), (wg, wl), (B, nx, H, D, V, K) = \
        _kernel_inputs("fused_gated_pair", h, u, px, v, idx, mask, Wg, Wl,
                       mode=mode)
    lib = _lib("mp_pair_fwd")
    rows = lambda: torch.empty((B, nx, H), device=h.device,  # noqa: E731
                               dtype=torch.float32)
    out = rows()
    gn, ln = (rows(), rows()) if stash else (None, None)
    scratch = _scratch(lib, "mp_pair_fwd", B, nx, H, D, V, K, h.device,
                       workspace)
    # The launch copies the pointer arrays into the kernel's arguments. The
    # tensors freed on return (scratch, contiguous copies) are reused only by
    # later work on this stream, which runs after the kernel.
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device), tracing.span("launch.pair_fwd"):
        err = lib.mp_pair_fwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), _ptrs(wg), _ptrs(wl),
            out.data_ptr(), gn.data_ptr() if stash else None,
            ln.data_ptr() if stash else None, scratch.data_ptr(), B, nx, H,
            D, V, K, mode, stream)
    _build.check(err, "mp_pair_fwd")
    launches += 1
    if stash:
        stash_launches += 1
        return out, gn, ln
    return out


def fused_gated_pair_bwd_kernel(h, u, px, v, idx, mask, Wg, Wl, g,
                                mp_precision="float32", workspace=None):
    """Launch ``csrc/mp_pair_bwd.cu``, one cooperative kernel over the
    whole batch, in ``mp_precision``; raises on anything it does not take.
    Returns (dh, gate 12-tuple, main 12-tuple). ``workspace`` as
    ``fused_gated_pair_kernel``'s (``mp_pair_bwd_scratch_floats``)."""
    global bwd_launches
    mode = mode_of(mp_precision)
    idx_in, mask_in = idx, mask
    (h, u, px, v, idx, mask), (wg, wl), (B, nx, H, D, V, K) = \
        _kernel_inputs("fused_gated_pair", h, u, px, v, idx, mask, Wg, Wl,
                       mode=mode)
    rev_ptr, rev_e = mp_layer._inverse_of(idx_in, mask_in)
    g = mp_layer._f32_cuda("fused_gated_pair", "g", g, (B, nx, H))
    per_layer = sum(torch.Size(s).numel() for s in _weight_shapes(H, D, V))
    lib = _lib("mp_pair_bwd")
    f32 = dict(device=h.device, dtype=torch.float32)
    dh = torch.empty_like(g)
    dw = torch.empty(2 * per_layer, **f32)
    scratch = _scratch(lib, "mp_pair_bwd", B, nx, H, D, V, K, h.device,
                       workspace)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device), tracing.span("launch.pair_bwd"):
        err = lib.mp_pair_bwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), rev_ptr.data_ptr(),
            rev_e.data_ptr(), _ptrs(wg), _ptrs(wl), g.data_ptr(),
            dh.data_ptr(), dw.data_ptr(), scratch.data_ptr(), B, nx, H, D,
            V, K, mode, stream)
    _build.check(err, "mp_pair_bwd")
    bwd_launches += 1
    dwg, dwl = _split_grads(dw, H, D, V, 2)
    return dh, dwg, dwl


# ---- dispatch and autograd -----------------------------------------------
# through the ops of ops/library.py: the kernels on CUDA tensors, the plain
# versions on CPU tensors
def _forward(h, u, px, v, idx, mask, Wg, Wl, stash=False,
             mp_precision="float32"):
    out, gn, ln = torch.ops.msmp.pair_fwd(h, u, px, v, idx, mask, list(Wg),
                                          list(Wl), stash, mp_precision)
    return (out, gn, ln) if stash else out


def _backward(h, u, px, v, idx, mask, Wg, Wl, g, mp_precision):
    dh, dw = torch.ops.msmp.pair_bwd(h, u, px, v, idx, mask, list(Wg),
                                     list(Wl), g, mp_precision)
    dwg, dwl = _split_grads(dw, h.shape[-1], u.shape[-1], v.shape[-1], 2)
    return dh, dwg, dwl


class FusedGatedPair(torch.autograd.Function):
    """apply(h, u, px, v, idx, mask, mp_precision, *Wg, *Wl): the 24
    weights are separate arguments so that autograd sees each. The backward
    returns dh and the 24 weight gradients; u, px, v, idx and mask get none
    (the TPU VJP returns zeros for them, mp_pallas.py:715). Where the fused
    backward does not fit, the forward stashes gn and ln for the
    fallback."""

    @staticmethod
    def forward(ctx, h, u, px, v, idx, mask, mp_precision, *W):
        B, nx, H = h.shape
        ctx.mp_precision = mp_precision
        ctx.fused = pair_bwd_fused_fits(B, nx, H, u.shape[-1], v.shape[-1],
                                        idx.shape[-1], h.device)
        if ctx.fused:
            ctx.save_for_backward(h, u, px, v, idx, mask, *W)
            return _forward(h, u, px, v, idx, mask, W[:12], W[12:],
                            mp_precision=mp_precision)
        out, gn, ln = _forward(h, u, px, v, idx, mask, W[:12], W[12:],
                               True, mp_precision)
        ctx.save_for_backward(h, u, px, v, idx, mask, *W, gn, ln)
        return out

    @staticmethod
    def backward(ctx, g):
        h, u, px, v, idx, mask, *rest = ctx.saved_tensors
        Wg, Wl = rest[:12], rest[12:24]
        if ctx.fused:
            with tracing.span("op.pair_bwd"):
                dh, dwg, dwl = _backward(h, u, px, v, idx, mask, Wg, Wl, g,
                                         ctx.mp_precision)
        else:
            dh, dwg, dwl = fallback_bwd(h, u, px, v, idx, mask, Wg, Wl,
                                        *rest[24:], g, ctx.mp_precision)
        return (dh,) + (None,) * 6 + tuple(dwg) + tuple(dwl)


def fused_gated_pair(h, u, px, v, idx, mask, Wg, Wl, mp_precision="float32"):
    """CPU tensors -> the plain versions; CUDA tensors -> the kernels, in
    ``mp_precision``. With grad enabled and a differentiable input, through
    ``FusedGatedPair``. Its span: ``op.pair_fwd``; the backward's
    ``op.pair_bwd`` (the fallback's, two ``op.layer_bwd``)."""
    with tracing.span("op.pair_fwd"):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (h, *Wg, *Wl)):
            return FusedGatedPair.apply(h, u, px, v, idx, mask,
                                        mp_precision, *Wg, *Wl)
        return _forward(h, u, px, v, idx, mask, Wg, Wl,
                        mp_precision=mp_precision)
