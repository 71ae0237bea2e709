"""Fused gated message-passing pair, forward and backward (counterpart of
msmp_pde_tpu/ops/mp_pallas.py::fused_gated_pair and its custom VJP).

``fused_gated_pair`` runs the hand-written kernels ``csrc/mp_pair_fwd.cu``
and ``csrc/mp_pair_bwd.cu`` on CUDA tensors and the plain PyTorch versions
``fused_gated_pair_plain`` / ``fused_gated_pair_bwd_plain`` on CPU tensors.
With grad enabled it goes through the ``torch.autograd.Function``
``FusedGatedPair``, which saves its inputs and recomputes in the backward,
as the TPU's fused pair backward does. A layer's weights are the 12-tuple
``(w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4)`` in the flax
layout (models/gnn.py::GNNLayer.weights).
"""
from __future__ import annotations

import ctypes

import torch

from msmp_pde_torch.models.common import swish
from msmp_pde_torch.ops import _build

launches = 0      # forward kernel launches since the last reset
bwd_launches = 0  # backward kernel launches since the last reset


def _dswish(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _instnorm(o, eps: float = 1e-5):
    """Per-graph, per-feature InstanceNorm over the node axis of [B, nx, H]
    (biased variance) -> (normalized, rsqrt factors [B, 1, H])."""
    mean = o.mean(dim=1, keepdim=True)
    var = ((o - mean) ** 2).mean(dim=1, keepdim=True)
    rs = torch.rsqrt(var + eps)
    return (o - mean) * rs, rs


def _instnorm_bwd(g, xh, rs):
    return rs * (g - g.mean(dim=1, keepdim=True)
                 - xh * (g * xh).mean(dim=1, keepdim=True))


def _layer_forward(h, u, px, v, idx, mask, W):
    """One GNN_LayerLin: h [B, nx, H], u [B, nx, D], px [B, nx, 1],
    v [B, nx, V], idx/mask [nx, K] -> (normalized output, rsqrt factors,
    the intermediates its backward reads)."""
    (w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4) = W
    mix = u @ w_du + px @ w_dx
    s_i = h @ w_hi + mix + v @ w_v + b1
    s_j = h @ w_hj - mix
    m0 = s_i[:, :, None, :] + s_j[:, idx.long()]  # [B, nx, K, H]
    m1 = swish(m0)
    z2 = m1 @ w2 + b2
    deg = torch.clamp(mask.sum(-1), min=1.0)
    agg = (swish(z2) * mask[None, :, :, None]).sum(2) / deg[None, :, None]
    x3 = torch.cat([h, agg, v], dim=-1)
    z3 = x3 @ w3 + b3
    a3 = swish(z3)
    xh, rs = _instnorm(a3 @ w4 + b4)
    return xh, rs, (m0, m1, z2, x3, z3, a3)


def layer_plain(h, u, px, v, idx, mask, W):
    """One GNN_LayerLin -> normalized output [B, nx, H]."""
    return _layer_forward(h, u, px, v, idx, mask, W)[0]


def _layer_backward(dxo, h, u, px, v, idx, mask, W, saved):
    """Backward through the layer math (pre-norm), mp_pallas.py:185-225:
    dxo is the cotangent of the pre-norm output. Returns (dh, 12 weight
    gradients summed over the batch, in parameter shapes)."""
    (w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4) = W
    m0, m1, z2, x3, z3, a3 = saved
    B, nx, H = h.shape
    K = idx.shape[-1]
    rows = lambda x: x.reshape(-1, x.shape[-1])
    outer = lambda a, b: rows(a).T @ rows(b)
    colsum = lambda x: rows(x).sum(0)
    dw4, db4 = outer(a3, dxo), colsum(dxo)
    dz3 = (dxo @ w4.T) * _dswish(z3)
    dw3, db3 = outer(x3, dz3), colsum(dz3)
    dh = dz3 @ w3[:H].T
    dagg = dz3 @ w3[H:2 * H].T
    deg = torch.clamp(mask.sum(-1), min=1.0)
    dz2 = (dagg[:, :, None, :] * (mask / deg[:, None])[None, :, :, None]
           * _dswish(z2))
    dw2, db2 = outer(m1, dz2), colsum(dz2)
    dm0 = (dz2 @ w2.T) * _dswish(m0)
    ds_i = dm0.sum(2)
    # the masked gather's transpose: each valid edge (i, k) adds into idx[i, k]
    ds_j = torch.zeros_like(ds_i).index_add_(
        1, idx.reshape(-1).long(),
        (dm0 * mask[None, :, :, None]).reshape(B, nx * K, H))
    dh = dh + ds_i @ w_hi.T + ds_j @ w_hj.T
    dmix = ds_i - ds_j
    dws = (outer(h, ds_i), outer(h, ds_j), outer(u, dmix), outer(px, dmix),
           outer(v, ds_i), colsum(ds_i), dw2, db2, dw3, db3, dw4, db4)
    return dh, dws


def fused_gated_pair_plain(h, u, px, v, idx, mask, Wg, Wl):
    """(1 - sigmoid(gn)) h + sigmoid(gn) swish(ln) with gn/ln the gate and
    main layers' normalized outputs."""
    tau = torch.sigmoid(layer_plain(h, u, px, v, idx, mask, Wg))
    ln = layer_plain(h, u, px, v, idx, mask, Wl)
    return (1.0 - tau) * h + tau * swish(ln)


def fused_gated_pair_bwd_plain(h, u, px, v, idx, mask, Wg, Wl, g):
    """The pair's backward in the kernel's recompute order
    (mp_pallas.py:291-349): gate forward for gn; main layer forward and
    backward; gate forward again and backward. g is the output cotangent.
    Returns (dh, gate 12-tuple, main 12-tuple); u, px and v get none."""
    gn, _, _ = _layer_forward(h, u, px, v, idx, mask, Wg)
    tau = torch.sigmoid(gn)
    ln, rs_l, saved_l = _layer_forward(h, u, px, v, idx, mask, Wl)
    dln = g * tau * _dswish(ln)
    dgn = g * (swish(ln) - h) * tau * (1.0 - tau)
    dh_l, dwl = _layer_backward(_instnorm_bwd(dln, ln, rs_l), h, u, px, v,
                                idx, mask, Wl, saved_l)
    gn, rs_g, saved_g = _layer_forward(h, u, px, v, idx, mask, Wg)
    dh_g, dwg = _layer_backward(_instnorm_bwd(dgn, gn, rs_g), h, u, px, v,
                                idx, mask, Wg, saved_g)
    return g * (1.0 - tau) + dh_g + dh_l, dwg, dwl


# ---- the kernels ---------------------------------------------------------
def _lib(name):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, name)
        if name == "mp_pair_fwd":
            fn.argtypes = [p] * 10 + [i] * 6 + [p]
        else:
            fn.argtypes = [p] * 13 + [i] * 6 + [p]
            lib.mp_pair_bwd_scratch_floats.argtypes = [i] * 5
            lib.mp_pair_bwd_scratch_floats.restype = ctypes.c_long
        fn.restype = i
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


def _weight_shapes(H, D, V):
    return [(H, H), (H, H), (D, H), (1, H), (V, H), (H,), (H, H), (H,),
            (2 * H + V, H), (H,), (H, H), (H,)]


def _weights(W, H, D, V, tag):
    if len(W) != 12:
        raise ValueError("fused_gated_pair: a layer has 12 weight tensors")
    return [_f32_cuda(f"{tag}[{k}]", w, s)
            for k, (w, s) in enumerate(zip(W, _weight_shapes(H, D, V)))]


def _kernel_inputs(h, u, px, v, idx, mask, Wg, Wl):
    """Checked contiguous float32 CUDA operands, idx as int32."""
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
    return (h, u, px, v, idx, mask, wg, wl), (B, nx, H, D, V, K)


def _ptrs(ws):
    return (ctypes.c_void_p * 12)(*[w.data_ptr() for w in ws])


def fused_gated_pair_kernel(h, u, px, v, idx, mask, Wg, Wl):
    """Launch ``csrc/mp_pair_fwd.cu``; raises on anything it does not take."""
    global launches
    (h, u, px, v, idx, mask, wg, wl), (B, nx, H, D, V, K) = _kernel_inputs(
        h, u, px, v, idx, mask, Wg, Wl)
    out = torch.empty_like(h)
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
            out.data_ptr(), scratch.data_ptr(), B, nx, H, D, V, K, stream)
    _build.check(err, "mp_pair_fwd")
    launches += 1
    return out


def fused_gated_pair_bwd_kernel(h, u, px, v, idx, mask, Wg, Wl, g):
    """Launch ``csrc/mp_pair_bwd.cu`` (the fused backward and its fixed-order
    reduction of the per-graph weight gradients); raises on anything it
    does not take. Returns (dh, gate 12-tuple, main 12-tuple)."""
    global bwd_launches
    (h, u, px, v, idx, mask, wg, wl), (B, nx, H, D, V, K) = _kernel_inputs(
        h, u, px, v, idx, mask, Wg, Wl)
    g = _f32_cuda("g", g, (B, nx, H))
    shapes = _weight_shapes(H, D, V)
    per_layer = sum(torch.Size(s).numel() for s in shapes)
    lib = _lib("mp_pair_bwd")
    f32 = dict(device=h.device, dtype=torch.float32)
    dh = torch.empty_like(h)
    dw = torch.empty(2 * per_layer, **f32)
    partial = torch.empty(B * 2 * per_layer, **f32)
    scratch = torch.empty(B * lib.mp_pair_bwd_scratch_floats(nx, H, D, V, K),
                          **f32)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = lib.mp_pair_bwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), _ptrs(wg), _ptrs(wl),
            g.data_ptr(), dh.data_ptr(), dw.data_ptr(), partial.data_ptr(),
            scratch.data_ptr(), B, nx, H, D, V, K, stream)
    _build.check(err, "mp_pair_bwd")
    bwd_launches += 1
    grads, off = [], 0
    for s in shapes + shapes:
        n = torch.Size(s).numel()
        grads.append(dw[off:off + n].view(s))
        off += n
    return dh, tuple(grads[:12]), tuple(grads[12:])


# ---- dispatch and autograd -----------------------------------------------
def _forward(h, u, px, v, idx, mask, Wg, Wl):
    if h.is_cuda:
        return fused_gated_pair_kernel(h, u, px, v, idx, mask, Wg, Wl)
    return fused_gated_pair_plain(h, u, px, v, idx, mask, Wg, Wl)


def _backward(h, u, px, v, idx, mask, Wg, Wl, g):
    if h.is_cuda:
        return fused_gated_pair_bwd_kernel(h, u, px, v, idx, mask, Wg, Wl, g)
    return fused_gated_pair_bwd_plain(h, u, px, v, idx, mask, Wg, Wl, g)


class FusedGatedPair(torch.autograd.Function):
    """apply(h, u, px, v, idx, mask, *Wg, *Wl): the 24 weights are separate
    arguments so that autograd sees each. The backward returns dh and the
    24 weight gradients; u, px, v, idx and mask get none (the TPU VJP
    returns zeros for them, mp_pallas.py:715)."""

    @staticmethod
    def forward(ctx, h, u, px, v, idx, mask, *W):
        ctx.save_for_backward(h, u, px, v, idx, mask, *W)
        return _forward(h, u, px, v, idx, mask, W[:12], W[12:])

    @staticmethod
    def backward(ctx, g):
        h, u, px, v, idx, mask, *W = ctx.saved_tensors
        dh, dwg, dwl = _backward(h, u, px, v, idx, mask, W[:12], W[12:], g)
        return (dh, None, None, None, None, None) + tuple(dwg) + tuple(dwl)


def fused_gated_pair(h, u, px, v, idx, mask, Wg, Wl):
    """CPU tensors -> the plain versions; CUDA tensors -> the kernels. With
    grad enabled and a differentiable input, through ``FusedGatedPair``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, *Wg, *Wl)):
        return FusedGatedPair.apply(h, u, px, v, idx, mask, *Wg, *Wl)
    return _forward(h, u, px, v, idx, mask, Wg, Wl)
