"""One message-passing layer, forward and backward (counterpart of
msmp_pde_tpu/ops/mp_pallas.py::fused_mp_layer and make_fused_layer's custom
VJP), and what the gated pair (ops/mp_pair.py) shares with it: the layer
math and the checks and pointers of the kernel wrappers.

``fused_mp_layer`` runs the hand-written kernels ``csrc/mp_layer_fwd.cu``
and ``csrc/mp_layer_bwd.cu`` on CUDA tensors and the plain PyTorch versions
``fused_mp_layer_plain`` / ``fused_mp_layer_bwd_plain`` on CPU tensors. With
grad enabled it goes through the ``torch.autograd.Function``
``FusedMPLayer``, which saves its inputs and recomputes in the backward, as
the TPU's layer backward does. ``final_act`` and ``residual`` are
GNN_Layer's switches (both for the ungated models, neither for
GNN_LayerLin). A layer's weights are the 12-tuple
``(w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4)`` in the flax
layout (models/gnn.py::GNNLayer.weights).
"""
from __future__ import annotations

import ctypes
import weakref

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


def _layer_forward(h, u, px, v, idx, mask, W, final_act=False,
                   residual=False):
    """One layer (mp_pallas.py:110-137): h [B, nx, H], u [B, nx, D],
    px [B, nx, 1], v [B, nx, V], idx/mask [nx, K] -> (normalized output,
    rsqrt factors, the intermediates its backward reads)."""
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
    z4 = a3 @ w4 + b4
    o = swish(z4) if final_act else z4
    xh, rs = _instnorm(h + o if residual else o)
    return xh, rs, (m0, m1, z2, x3, z3, a3, z4)


def fused_mp_layer_plain(h, u, px, v, idx, mask, W, final_act=False,
                         residual=False):
    """One layer -> normalized output [B, nx, H]."""
    return _layer_forward(h, u, px, v, idx, mask, W, final_act, residual)[0]


def _layer_backward(dxo, h, u, px, v, idx, mask, W, saved, final_act=False,
                    residual=False):
    """Backward through the layer math (pre-norm), mp_pallas.py:185-225:
    dxo is the cotangent of the pre-norm output. Returns (dh, 12 weight
    gradients summed over the batch, in parameter shapes)."""
    (w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4) = W
    m0, m1, z2, x3, z3, a3, z4 = saved
    B, nx, H = h.shape
    K = idx.shape[-1]
    rows = lambda x: x.reshape(-1, x.shape[-1])
    outer = lambda a, b: rows(a).T @ rows(b)
    colsum = lambda x: rows(x).sum(0)
    dz4 = dxo * _dswish(z4) if final_act else dxo
    dw4, db4 = outer(a3, dz4), colsum(dz4)
    dz3 = (dz4 @ w4.T) * _dswish(z3)
    dw3, db3 = outer(x3, dz3), colsum(dz3)
    dh = dz3 @ w3[:H].T
    if residual:
        dh = dxo + dh
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


def fused_mp_layer_bwd_plain(h, u, px, v, idx, mask, W, g, final_act=False,
                             residual=False):
    """The layer's backward as the TPU kernel runs it (mp_pallas.py:
    228-257): forward again, InstanceNorm backward, layer backward. g is
    the output cotangent. Returns (dh, 12-tuple); u, px and v get none."""
    xh, rs, saved = _layer_forward(h, u, px, v, idx, mask, W, final_act,
                                   residual)
    return _layer_backward(_instnorm_bwd(g, xh, rs), h, u, px, v, idx, mask,
                           W, saved, final_act, residual)


# ---- the kernels (this layer's and the pair's) ---------------------------
# pointer and int arguments of each C entry point before its stream
_ARGS = {"mp_pair_fwd": (12, 6), "mp_pair_bwd": (14, 6),
         "mp_layer_fwd": (9, 8), "mp_layer_bwd": (13, 8)}
# int arguments of <name>_grid, the kernel's cooperative grid
_GRID_ARGS = {"mp_pair_fwd": 1, "mp_pair_bwd": 0, "mp_layer_fwd": 1,
              "mp_layer_bwd": 1}


def _lib(name):
    """The typed library of one of the message-passing sources: the kernel's
    entry point, ``<name>_scratch_floats(B, nx, H, D, V, K)`` (its
    workspace) and ``<name>_grid`` (its cooperative grid)."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        n_ptr, n_int = _ARGS[name]
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = i
        sf = getattr(lib, f"{name}_scratch_floats")
        sf.argtypes = [i] * 6
        sf.restype = ctypes.c_long
        gr = getattr(lib, f"{name}_grid")
        gr.argtypes = [i] * _GRID_ARGS[name]
        gr.restype = i
        lib._typed = True
    return lib


def _scratch(lib, name, B, nx, H, D, V, K, device):
    """The kernel's float32 workspace for this shape."""
    n = getattr(lib, f"{name}_scratch_floats")(B, nx, H, D, V, K)
    return torch.empty(n, device=device, dtype=torch.float32)


def inverse_neighbors(idx, mask):
    """The inverse neighbour list of the graph ``idx``/``mask`` [nx, K]: for
    each node n, the valid edges e = i K + k (mask[e] != 0) with
    idx[e] = n, in increasing e. Returns int32 (rev_ptr [nx + 1], rev_e
    [nx K]): node n's edges are rev_e[rev_ptr[n]:rev_ptr[n + 1]], the
    ``rev_ptr[nx]`` valid edges come first and the masked slots after them.
    A stable sort of the edges by target (the masked slots keyed past the
    last node), then each node's start in the sorted targets. Deterministic
    on the card, and no step reads a value back to the host (``bincount``
    on a CUDA tensor does, to size its output), so the wrapper does not
    wait for the card. It turns the scatter of the gather's transpose into
    a gather-sum in a fixed order (the backward kernels' ds_j)."""
    nx = idx.shape[0]
    key = torch.where(mask.reshape(-1) != 0, idx.reshape(-1).long(), nx)
    sorted_key, rev_e = torch.sort(key, stable=True)
    rev_ptr = torch.searchsorted(
        sorted_key, torch.arange(nx + 1, device=idx.device))
    return rev_ptr.to(torch.int32), rev_e.to(torch.int32)


_inverse_memo = {}  # id(idx) -> (idx ref, mask ref, versions, lists)


def _inverse_of(idx, mask):
    """``inverse_neighbors(idx, mask)``, remembered for the same idx and
    mask tensors while neither has changed (same objects, same version
    counters): the model passes its graph's own tensors to every backward,
    and the list costs a few launches and their host time each call."""
    hit = _inverse_memo.get(id(idx))
    versions = (idx._version, mask._version)
    if (hit is not None and hit[0]() is idx and hit[1]() is mask
            and hit[2] == versions):
        return hit[3]
    lists = inverse_neighbors(idx, mask)
    if len(_inverse_memo) >= 8:
        _inverse_memo.pop(next(iter(_inverse_memo)))
    _inverse_memo[id(idx)] = (weakref.ref(idx), weakref.ref(mask), versions,
                              lists)
    return lists


def grid_blocks(name, variant=False):
    """The blocks of the cooperative launch of one of the message-passing
    kernels (``mp_pair_fwd``, ``mp_pair_bwd``, ``mp_layer_fwd``,
    ``mp_layer_bwd``) on the current card: its SMs times the blocks that
    fit on one at once. ``variant`` picks the template: ``stash`` for
    ``mp_pair_fwd``, ``final_act`` for the single layer's kernels. Raises
    where the grid cannot be formed."""
    lib = _lib(name)
    args = (int(variant),) * _GRID_ARGS[name]
    n = getattr(lib, f"{name}_grid")(*args)
    if n <= 0:
        raise RuntimeError(f"{name}: no cooperative grid (CUDA error {-n})")
    return n


def _f32_cuda(op, name, x, shape):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} is {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"{op} kernel: {name} must be a float32 CUDA "
                         "tensor")
    return x.contiguous()


def _weight_shapes(H, D, V):
    return [(H, H), (H, H), (D, H), (1, H), (V, H), (H,), (H, H), (H,),
            (2 * H + V, H), (H,), (H, H), (H,)]


def _kernel_inputs(op, h, u, px, v, idx, mask, *Ws):
    """Checked contiguous float32 CUDA operands, idx as int32: (h, u, px,
    v, idx, mask), a list per 12-tuple of weights, (B, nx, H, D, V, K)."""
    B, nx, H = h.shape
    D, V, K = u.shape[-1], v.shape[-1], idx.shape[-1]
    h = _f32_cuda(op, "h", h, (B, nx, H))
    u = _f32_cuda(op, "u", u, (B, nx, D))
    px = _f32_cuda(op, "px", px, (B, nx, 1))
    v = _f32_cuda(op, "v", v, (B, nx, V))
    mask = _f32_cuda(op, "mask", mask, (nx, K))
    if tuple(idx.shape) != (nx, K) or idx.device != h.device:
        raise ValueError(f"{op} kernel: idx must be [nx, K] on the inputs' "
                         "device")
    idx = idx.to(torch.int32).contiguous()
    ws = []
    for n, W in enumerate(Ws):
        if len(W) != 12:
            raise ValueError(f"{op}: a layer has 12 weight tensors")
        ws.append([_f32_cuda(op, f"W{n}[{k}]", w, s) for k, (w, s)
                   in enumerate(zip(W, _weight_shapes(H, D, V)))])
    return (h, u, px, v, idx, mask), ws, (B, nx, H, D, V, K)


def _ptrs(ws):
    return (ctypes.c_void_p * 12)(*[w.data_ptr() for w in ws])


def _split_grads(dw, H, D, V, n_layers):
    """Flat gradients in parameter order and shapes -> one 12-tuple of
    views per layer."""
    grads, off = [], 0
    for _ in range(n_layers):
        for s in _weight_shapes(H, D, V):
            n = torch.Size(s).numel()
            grads.append(dw[off:off + n].view(s))
            off += n
    return [tuple(grads[12 * k:12 * k + 12]) for k in range(n_layers)]


def _switches(final_act, residual):
    """The kernels build GNN_Layer (both switches) and GNN_LayerLin
    (neither), the two layers the models use."""
    if bool(final_act) != bool(residual):
        raise ValueError("fused_mp_layer kernel: final_act and residual "
                         "must be equal (GNN_Layer or GNN_LayerLin)")
    return int(final_act), int(residual)


def fused_mp_layer_kernel(h, u, px, v, idx, mask, W, final_act=False,
                          residual=False):
    """Launch ``csrc/mp_layer_fwd.cu``, one cooperative kernel over the
    whole batch; raises on anything it does not take."""
    global launches
    switches = _switches(final_act, residual)
    (h, u, px, v, idx, mask), (w,), (B, nx, H, D, V, K) = _kernel_inputs(
        "fused_mp_layer", h, u, px, v, idx, mask, W)
    lib = _lib("mp_layer_fwd")
    out = torch.empty_like(h)
    scratch = _scratch(lib, "mp_layer_fwd", B, nx, H, D, V, K, h.device)
    # The tensors freed on return (scratch, contiguous copies) are reused
    # only by later work on this stream, which runs after the kernel.
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = lib.mp_layer_fwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), _ptrs(w), out.data_ptr(),
            scratch.data_ptr(), B, nx, H, D, V, K, *switches, stream)
    _build.check(err, "mp_layer_fwd")
    launches += 1
    return out


def fused_mp_layer_bwd_kernel(h, u, px, v, idx, mask, W, g, final_act=False,
                              residual=False):
    """Launch ``csrc/mp_layer_bwd.cu``, one cooperative kernel over the
    whole batch; raises on anything it does not take. Returns (dh,
    12-tuple)."""
    global bwd_launches
    switches = _switches(final_act, residual)
    idx_in, mask_in = idx, mask
    (h, u, px, v, idx, mask), (w,), (B, nx, H, D, V, K) = _kernel_inputs(
        "fused_mp_layer", h, u, px, v, idx, mask, W)
    rev_ptr, rev_e = _inverse_of(idx_in, mask_in)
    g = _f32_cuda("fused_mp_layer", "g", g, (B, nx, H))
    lib = _lib("mp_layer_bwd")
    f32 = dict(device=h.device, dtype=torch.float32)
    per_layer = sum(torch.Size(s).numel() for s in _weight_shapes(H, D, V))
    dh = torch.empty_like(h)
    dw = torch.empty(per_layer, **f32)
    scratch = _scratch(lib, "mp_layer_bwd", B, nx, H, D, V, K, h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = lib.mp_layer_bwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), rev_ptr.data_ptr(),
            rev_e.data_ptr(), _ptrs(w), g.data_ptr(), dh.data_ptr(),
            dw.data_ptr(), scratch.data_ptr(), B, nx, H, D, V, K, *switches,
            stream)
    _build.check(err, "mp_layer_bwd")
    bwd_launches += 1
    return dh, _split_grads(dw, H, D, V, 1)[0]


# ---- dispatch and autograd -----------------------------------------------
def _forward(h, u, px, v, idx, mask, W, final_act, residual):
    if h.is_cuda:
        return fused_mp_layer_kernel(h, u, px, v, idx, mask, W, final_act,
                                     residual)
    return fused_mp_layer_plain(h, u, px, v, idx, mask, W, final_act,
                                residual)


def layer_backward(h, u, px, v, idx, mask, W, g, final_act, residual):
    """(dh, 12-tuple) of one layer: the kernel on CUDA tensors, the plain
    version on CPU tensors. The gated pair's fallback backward calls it
    once per layer."""
    if h.is_cuda:
        return fused_mp_layer_bwd_kernel(h, u, px, v, idx, mask, W, g,
                                         final_act, residual)
    return fused_mp_layer_bwd_plain(h, u, px, v, idx, mask, W, g, final_act,
                                    residual)


class FusedMPLayer(torch.autograd.Function):
    """apply(h, u, px, v, idx, mask, final_act, residual, *W): the 12
    weights are separate arguments so that autograd sees each. The backward
    returns dh and the 12 weight gradients; u, px, v, idx and mask get none
    (the TPU VJP returns zeros for them, mp_pallas.py:570-571)."""

    @staticmethod
    def forward(ctx, h, u, px, v, idx, mask, final_act, residual, *W):
        ctx.save_for_backward(h, u, px, v, idx, mask, *W)
        ctx.switches = (final_act, residual)
        return _forward(h, u, px, v, idx, mask, W, final_act, residual)

    @staticmethod
    def backward(ctx, g):
        h, u, px, v, idx, mask, *W = ctx.saved_tensors
        dh, dws = layer_backward(h, u, px, v, idx, mask, W, g,
                                 *ctx.switches)
        return (dh,) + (None,) * 7 + tuple(dws)


def fused_mp_layer(h, u, px, v, idx, mask, W, final_act=False,
                   residual=False):
    """CPU tensors -> the plain versions; CUDA tensors -> the kernels. With
    grad enabled and a differentiable input, through ``FusedMPLayer``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, *W)):
        return FusedMPLayer.apply(h, u, px, v, idx, mask, final_act,
                                  residual, *W)
    return _forward(h, u, px, v, idx, mask, W, final_act, residual)
