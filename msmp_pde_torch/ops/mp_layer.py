"""One message-passing layer, forward and backward (counterpart of
msmp_pde_tpu/ops/mp_pallas.py::fused_mp_layer and make_fused_layer's custom
VJP), and what the gated pair (ops/mp_pair.py) shares with it: the layer
math and the checks and pointers of the kernel wrappers.

``fused_mp_layer`` runs the hand-written kernels ``csrc/mp_layer_fwd.cu``
and ``csrc/mp_layer_bwd.cu`` on CUDA tensors and the plain PyTorch versions
``fused_mp_layer_plain`` / ``fused_mp_layer_bwd_plain`` on CPU tensors,
through the ``torch.library`` ops ``msmp::layer_fwd`` and
``msmp::layer_bwd`` (ops/library.py). With grad enabled it goes through the ``torch.autograd.Function``
``FusedMPLayer``, which saves its inputs and recomputes in the backward, as
the TPU's layer backward does. ``final_act`` and ``residual`` are
GNN_Layer's switches (both for the ungated models, neither for
GNN_LayerLin). A layer's weights are the 12-tuple
``(w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4)`` in the flax
layout (models/gnn.py::GNNLayer.weights).

``mp_precision`` is the TPU kernels' operand precision (mp_pallas.py::
_parse_mm): ``float32``; ``bfloat16``, where every product rounds both
operands to bf16 (to nearest even) and sums their exact products in
float32; ``bfloat16s``, the same products on h, u, px, v and the weight
matrices cast to bf16 once before the kernel (``storage_cast``), so that
the residual and the pair's combine take the rounded h. Biases, the
elementwise passes, the InstanceNorm and the sums of the gradients stay
float32, and the output keeps the caller's float32. The TPU kernel gathers
and averages with 0/1 and 1/deg matrices on its matrix unit, so their
operands round too; here they are gathers and sums, each rounding written
out (``_edge_in``, ``_aggregate``, ``_aggregate_bwd``, ``_gather_bwd``).
The plain versions round with ``.to(torch.bfloat16)`` and back and multiply
in float32: a matmul of bf16 tensors would round its output to bf16, which
the TPU's float32 accumulation does not.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from msmp_pde_torch.models.common import swish
from msmp_pde_torch.ops import _build
from msmp_pde_torch import tracing

launches = 0      # forward kernel launches since the last reset
bwd_launches = 0  # backward kernel launches since the last reset

# mp_precision -> the kernels' mode (csrc/bf16_mma.cuh)
MODES = {"float32": 0, "bfloat16": 1, "bfloat16s": 2}
_BIAS_IDX = frozenset((5, 7, 9, 11))  # b1, b2, b3, b4 in the 12-tuple


def mode_of(mp_precision: str) -> int:
    """The kernels' mode of ``mp_precision`` (mp_pallas.py::_parse_mm):
    0 float32, 1 bfloat16, 2 bfloat16s (storage); raises on any other."""
    try:
        return MODES[mp_precision]
    except KeyError:
        raise ValueError(f"unknown mp_precision {mp_precision!r}") from None


def _bf16(x):
    """x rounded to bf16 (to nearest even), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _rounding(mode: int):
    """The operand rounding of a product in ``mode``."""
    return _bf16 if mode else (lambda x: x)


def storage_cast(h, u, px, v, *Ws, dtype=None):
    """The storage mode's cast (mp_pallas.py::_cast_tree): h, u, px, v and
    each 12-tuple's weight matrices to bf16, the biases kept. ``dtype``
    None returns bf16 tensors (the kernels' operands); a float dtype the
    rounded values in it (the plain versions')."""
    cast = ((lambda x: x.to(torch.bfloat16)) if dtype is None
            else (lambda x: x.to(torch.bfloat16).to(dtype)))
    return (cast(h), cast(u), cast(px), cast(v)) + tuple(
        tuple(w if i in _BIAS_IDX else cast(w) for i, w in enumerate(W))
        for W in Ws)


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


# ---- the products and the gathers, each with its rounding ---------------
def _mm(a, b, r):
    """a @ b on operands rounded by r (_dot of mp_pallas.py:84-90)."""
    return r(a) @ r(b)


def _rows(x):
    return x.reshape(-1, x.shape[-1])


def _outer(a, b, r):
    """A weight gradient a^T b over all rows, operands rounded by r
    (_dot_t, mp_pallas.py:93-100)."""
    return r(_rows(a)).T @ r(_rows(b))


def _edge_in(s_i, s_j, idx, r):
    """m0 [B, nx, K, H] = s_i[i] + s_j[idx[i, k]]: E s_i + G s_j
    (mp_pallas.py:119), each side's operand rounded by r."""
    return r(s_i)[:, :, None, :] + r(s_j)[:, idx.long()]


def _a_entries(mask, r):
    """mask / max(deg, 1) [nx, K], the entries of the TPU's A matrix,
    rounded by r."""
    return r(mask / torch.clamp(mask.sum(-1), min=1.0)[:, None])


def _aggregate(z2, mask, mode):
    """agg [B, nx, H], the masked mean of swish(z2) over the K slots: A m2
    (mp_pallas.py:124). In the bf16 modes a sum of products of
    bf16(mask / deg) and bf16(swish(z2)), as the TPU's bf16 A computes it
    (bf16(1/6) = 0.16699..., 0.2% above 1/6, kept)."""
    if mode:
        return (_a_entries(mask, _bf16)[None, :, :, None]
                * _bf16(swish(z2))).sum(2)
    deg = torch.clamp(mask.sum(-1), min=1.0)
    return (swish(z2) * mask[None, :, :, None]).sum(2) / deg[None, :, None]


def _aggregate_bwd(dagg, mask, z2, mode):
    """dz2 [B, nx, K, H] = (A^T dagg) swish'(z2) (mp_pallas.py:207-208), in
    the bf16 modes from bf16(dagg) and bf16(mask / deg)."""
    r = _rounding(mode)
    return (r(dagg)[:, :, None, :] * _a_entries(mask, r)[None, :, :, None]
            * _dswish(z2))


def _gather_bwd(dm0, idx, mask, r):
    """(ds_i, ds_j) [B, nx, H]: E^T dm0 and G^T dm0 (mp_pallas.py:213-214)
    on dm0 rounded by r; ds_j is the masked gather's transpose, each valid
    edge (i, k) adding into idx[i, k]."""
    B, nx, K, H = dm0.shape
    dm0 = r(dm0)
    ds_i = dm0.sum(2)
    ds_j = torch.zeros_like(ds_i).index_add_(
        1, idx.reshape(-1).long(),
        (dm0 * mask[None, :, :, None]).reshape(B, nx * K, H))
    return ds_i, ds_j


def _mix_grads(u, px, ds_i, ds_j, r):
    """(dw_du, dw_dx): u^T dmix and px^T dmix with dmix = ds_i - ds_j
    (mp_pallas.py:218-220), rounded by r after the difference, as _dot_t
    rounds it."""
    dmix = ds_i - ds_j
    return _outer(u, dmix, r), _outer(px, dmix, r)


def _sides(h, u, px, v, W, r):
    """(s_i, s_j) [B, nx, H], the node sides of the edge input: s_i = h w_hi
    + mix + v w_v + b1, s_j = h w_hj - mix, mix = u w_du + px w_dx
    (mp_pallas.py:115-117), operands rounded by r."""
    w_hi, w_hj, w_du, w_dx, w_v, b1 = W[:6]
    mix = _mm(u, w_du, r) + _mm(px, w_dx, r)
    return (_mm(h, w_hi, r) + mix + _mm(v, w_v, r) + b1,
            _mm(h, w_hj, r) - mix)


def _layer_forward(h, u, px, v, idx, mask, W, final_act=False,
                   residual=False, mode=0):
    """One layer (mp_pallas.py:110-137): h [B, nx, H], u [B, nx, D],
    px [B, nx, 1], v [B, nx, V], idx/mask [nx, K] -> (normalized output,
    rsqrt factors, the intermediates its backward reads). ``mode`` rounds
    the products' operands (``mode_of``); the storage mode's cast is the
    caller's (``storage_cast``)."""
    w2, b2, w3, b3, w4, b4 = W[6:]
    r = _rounding(mode)
    s_i, s_j = _sides(h, u, px, v, W, r)
    m0 = _edge_in(s_i, s_j, idx, r)  # [B, nx, K, H]
    m1 = swish(m0)
    z2 = _mm(m1, w2, r) + b2
    agg = _aggregate(z2, mask, mode)
    x3 = torch.cat([h, agg, v], dim=-1)
    z3 = _mm(x3, w3, r) + b3
    a3 = swish(z3)
    z4 = _mm(a3, w4, r) + b4
    o = swish(z4) if final_act else z4
    xh, rs = _instnorm(h + o if residual else o)
    return xh, rs, (m0, m1, z2, x3, z3, a3, z4)


def plain_inputs(mode, h, u, px, v, *Ws):
    """The plain versions' inputs in ``mode``: the storage mode's rounded
    h, u, px, v and weight matrices, else the inputs."""
    if mode == 2:
        return storage_cast(h, u, px, v, *Ws, dtype=h.dtype)
    return (h, u, px, v) + Ws


def fused_mp_layer_plain(h, u, px, v, idx, mask, W, final_act=False,
                         residual=False, mp_precision="float32"):
    """One layer -> normalized output [B, nx, H]."""
    mode = mode_of(mp_precision)
    h, u, px, v, W = plain_inputs(mode, h, u, px, v, W)
    return _layer_forward(h, u, px, v, idx, mask, W, final_act, residual,
                          mode)[0]


def _layer_backward(dxo, h, u, px, v, idx, mask, W, saved, final_act=False,
                    residual=False, mode=0):
    """Backward through the layer math (pre-norm), mp_pallas.py:185-225:
    dxo is the cotangent of the pre-norm output. Returns (dh, 12 weight
    gradients summed over the batch, in parameter shapes). In the bf16
    modes every product rounds its operands, the bias gradients sum the
    unrounded cotangents."""
    (w_hi, w_hj, w_du, w_dx, w_v, b1, w2, b2, w3, b3, w4, b4) = W
    m0, m1, z2, x3, z3, a3, z4 = saved
    H = h.shape[-1]
    r = _rounding(mode)
    colsum = lambda x: _rows(x).sum(0)
    dz4 = dxo * _dswish(z4) if final_act else dxo
    dw4, db4 = _outer(a3, dz4, r), colsum(dz4)
    dz3 = _mm(dz4, w4.T, r) * _dswish(z3)
    dw3, db3 = _outer(x3, dz3, r), colsum(dz3)
    dh = _mm(dz3, w3[:H].T, r)
    if residual:
        dh = dxo + dh
    dagg = _mm(dz3, w3[H:2 * H].T, r)
    dz2 = _aggregate_bwd(dagg, mask, z2, mode)
    dw2, db2 = _outer(m1, dz2, r), colsum(dz2)
    dm0 = _mm(dz2, w2.T, r) * _dswish(m0)
    ds_i, ds_j = _gather_bwd(dm0, idx, mask, r)
    dh = dh + _mm(ds_i, w_hi.T, r) + _mm(ds_j, w_hj.T, r)
    dws = (_outer(h, ds_i, r), _outer(h, ds_j, r),
           *_mix_grads(u, px, ds_i, ds_j, r), _outer(v, ds_i, r),
           colsum(ds_i), dw2, db2, dw3, db3, dw4, db4)
    return dh, dws


def fused_mp_layer_bwd_plain(h, u, px, v, idx, mask, W, g, final_act=False,
                             residual=False, mp_precision="float32"):
    """The layer's backward as the TPU kernel runs it (mp_pallas.py:
    228-257): forward again, InstanceNorm backward, layer backward. g is
    the output cotangent. Returns (dh, 12-tuple); u, px and v get none."""
    mode = mode_of(mp_precision)
    h, u, px, v, W = plain_inputs(mode, h, u, px, v, W)
    xh, rs, saved = _layer_forward(h, u, px, v, idx, mask, W, final_act,
                                   residual, mode)
    return _layer_backward(_instnorm_bwd(g, xh, rs), h, u, px, v, idx, mask,
                           W, saved, final_act, residual, mode)


# ---- the kernels (this layer's and the pair's) ---------------------------
# pointer and int arguments of each C entry point before its stream (the
# last int the mode)
_ARGS = {"mp_pair_fwd": (12, 7), "mp_pair_bwd": (14, 7),
         "mp_layer_fwd": (9, 9), "mp_layer_bwd": (13, 9)}
# int arguments of <name>_grid, the kernel's cooperative grid (the last the
# mode)
_GRID_ARGS = {"mp_pair_fwd": 2, "mp_pair_bwd": 1, "mp_layer_fwd": 2,
              "mp_layer_bwd": 2}


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


def _scratch(lib, name, B, nx, H, D, V, K, device, workspace=None):
    """The kernel's float32 workspace for this shape: ``workspace`` where
    the caller passes one (checked), else a new one."""
    n = getattr(lib, f"{name}_scratch_floats")(B, nx, H, D, V, K)
    if workspace is None:
        return torch.empty(n, device=device, dtype=torch.float32)
    if (workspace.device != torch.device(device) or workspace.numel() < n
            or workspace.dtype != torch.float32
            or not workspace.is_contiguous()):
        raise ValueError(f"{name}: the workspace must be a contiguous "
                         f"float32 tensor of >= {n} floats on {device}")
    return workspace


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
    with tracing.span("op.inverse_lists"):
        lists = inverse_neighbors(idx, mask)
    if len(_inverse_memo) >= 8:
        _inverse_memo.pop(next(iter(_inverse_memo)))
    _inverse_memo[id(idx)] = (weakref.ref(idx), weakref.ref(mask), versions,
                              lists)
    return lists


def grid_blocks(name, variant=False, mp_precision="float32"):
    """The blocks of the cooperative launch of one of the message-passing
    kernels (``mp_pair_fwd``, ``mp_pair_bwd``, ``mp_layer_fwd``,
    ``mp_layer_bwd``) on the current card: its SMs times the blocks that
    fit on one at once. ``variant`` picks the template: ``stash`` for
    ``mp_pair_fwd``, ``final_act`` for the single layer's kernels; each
    ``mp_precision`` is a kernel of its own. Raises where the grid cannot
    be formed."""
    lib = _lib(name)
    args = (int(variant),) * (_GRID_ARGS[name] - 1) + (
        mode_of(mp_precision),)
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


def _kernel_inputs(op, h, u, px, v, idx, mask, *Ws, mode=0):
    """Checked contiguous float32 CUDA operands, idx as int32: (h, u, px,
    v, idx, mask), a list per 12-tuple of weights, (B, nx, H, D, V, K). In
    the storage mode (2) h, u, px, v and the weight matrices come back cast
    to bf16 (``storage_cast``), once, before the launch."""
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
    if mode == 2:
        h, u, px, v, *ws = storage_cast(h, u, px, v, *ws)
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
                          residual=False, mp_precision="float32",
                          workspace=None):
    """Launch ``csrc/mp_layer_fwd.cu``, one cooperative kernel over the
    whole batch, in ``mp_precision``; raises on anything it does not
    take. A ``workspace`` (float32, ``mp_layer_fwd_scratch_floats``) is
    used as the kernel's and then holds the intermediates it leaves there
    (csrc/mp_phases.cuh::layer_bufs)."""
    global launches
    switches = _switches(final_act, residual)
    mode = mode_of(mp_precision)
    (h, u, px, v, idx, mask), (w,), (B, nx, H, D, V, K) = _kernel_inputs(
        "fused_mp_layer", h, u, px, v, idx, mask, W, mode=mode)
    lib = _lib("mp_layer_fwd")
    out = torch.empty((B, nx, H), device=h.device, dtype=torch.float32)
    scratch = _scratch(lib, "mp_layer_fwd", B, nx, H, D, V, K, h.device,
                       workspace)
    # The tensors freed on return (scratch, contiguous copies) are reused
    # only by later work on this stream, which runs after the kernel.
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device), tracing.span("launch.layer_fwd"):
        err = lib.mp_layer_fwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), _ptrs(w), out.data_ptr(),
            scratch.data_ptr(), B, nx, H, D, V, K, *switches, mode, stream)
    _build.check(err, "mp_layer_fwd")
    launches += 1
    return out


def fused_mp_layer_bwd_kernel(h, u, px, v, idx, mask, W, g, final_act=False,
                              residual=False, mp_precision="float32",
                              workspace=None):
    """Launch ``csrc/mp_layer_bwd.cu``, one cooperative kernel over the
    whole batch, in ``mp_precision``; raises on anything it does not take.
    Returns (dh, 12-tuple). ``workspace`` as ``fused_mp_layer_kernel``'s
    (``mp_layer_bwd_scratch_floats``)."""
    global bwd_launches
    switches = _switches(final_act, residual)
    mode = mode_of(mp_precision)
    idx_in, mask_in = idx, mask
    (h, u, px, v, idx, mask), (w,), (B, nx, H, D, V, K) = _kernel_inputs(
        "fused_mp_layer", h, u, px, v, idx, mask, W, mode=mode)
    rev_ptr, rev_e = _inverse_of(idx_in, mask_in)
    g = _f32_cuda("fused_mp_layer", "g", g, (B, nx, H))
    lib = _lib("mp_layer_bwd")
    f32 = dict(device=h.device, dtype=torch.float32)
    per_layer = sum(torch.Size(s).numel() for s in _weight_shapes(H, D, V))
    dh = torch.empty_like(g)
    dw = torch.empty(per_layer, **f32)
    scratch = _scratch(lib, "mp_layer_bwd", B, nx, H, D, V, K, h.device,
                       workspace)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device), tracing.span("launch.layer_bwd"):
        err = lib.mp_layer_bwd(
            h.data_ptr(), u.data_ptr(), px.data_ptr(), v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), rev_ptr.data_ptr(),
            rev_e.data_ptr(), _ptrs(w), g.data_ptr(), dh.data_ptr(),
            dw.data_ptr(), scratch.data_ptr(), B, nx, H, D, V, K, *switches,
            mode, stream)
    _build.check(err, "mp_layer_bwd")
    bwd_launches += 1
    return dh, _split_grads(dw, H, D, V, 1)[0]


# ---- dispatch and autograd -----------------------------------------------
# through the ops of ops/library.py: the kernels on CUDA tensors, the plain
# versions on CPU tensors
def _forward(h, u, px, v, idx, mask, W, final_act, residual, mp_precision):
    return torch.ops.msmp.layer_fwd(h, u, px, v, idx, mask, list(W),
                                    final_act, residual, mp_precision)


def layer_backward(h, u, px, v, idx, mask, W, g, final_act, residual,
                   mp_precision="float32"):
    """(dh, 12-tuple) of one layer: the kernel on CUDA tensors, the plain
    version on CPU tensors. The gated pair's fallback backward calls it
    once per layer. Its span: ``op.layer_bwd``."""
    with tracing.span("op.layer_bwd"):
        dh, dw = torch.ops.msmp.layer_bwd(h, u, px, v, idx, mask, list(W),
                                          g, final_act, residual,
                                          mp_precision)
        return dh, _split_grads(dw, h.shape[-1], u.shape[-1], v.shape[-1],
                                1)[0]


class FusedMPLayer(torch.autograd.Function):
    """apply(h, u, px, v, idx, mask, final_act, residual, mp_precision,
    *W): the 12 weights are separate arguments so that autograd sees each.
    The backward returns dh and the 12 weight gradients; u, px, v, idx and
    mask get none (the TPU VJP returns zeros for them, mp_pallas.py:
    570-571)."""

    @staticmethod
    def forward(ctx, h, u, px, v, idx, mask, final_act, residual,
                mp_precision, *W):
        ctx.save_for_backward(h, u, px, v, idx, mask, *W)
        ctx.switches = (final_act, residual, mp_precision)
        return _forward(h, u, px, v, idx, mask, W, final_act, residual,
                        mp_precision)

    @staticmethod
    def backward(ctx, g):
        h, u, px, v, idx, mask, *W = ctx.saved_tensors
        dh, dws = layer_backward(h, u, px, v, idx, mask, W, g,
                                 *ctx.switches)
        return (dh,) + (None,) * 8 + tuple(dws)


def fused_mp_layer(h, u, px, v, idx, mask, W, final_act=False,
                   residual=False, mp_precision="float32"):
    """CPU tensors -> the plain versions; CUDA tensors -> the kernels, in
    ``mp_precision``. With grad enabled and a differentiable input, through
    ``FusedMPLayer``. Its span: ``op.layer_fwd``; the backward's
    ``op.layer_bwd``."""
    with tracing.span("op.layer_fwd"):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (h, *W)):
            return FusedMPLayer.apply(h, u, px, v, idx, mask, final_act,
                                      residual, mp_precision, *W)
        return _forward(h, u, px, v, idx, mask, W, final_act, residual,
                        mp_precision)
