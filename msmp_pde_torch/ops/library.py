"""The six kernel entry points as ``torch.library`` ops in the ``msmp``
namespace, so that ``torch.export`` traces a model through them
(serving/export.py) and a replayed program launches the same kernels.

| op | CUDA (the kernel) | CPU (the plain version) |
|---|---|---|
| ``msmp::pair_fwd`` | ``mp_pair.fused_gated_pair_kernel`` | ``fused_gated_pair_plain`` |
| ``msmp::pair_bwd`` | ``mp_pair.fused_gated_pair_bwd_kernel`` | ``fused_gated_pair_bwd_plain`` |
| ``msmp::layer_fwd`` | ``mp_layer.fused_mp_layer_kernel`` | ``fused_mp_layer_plain`` |
| ``msmp::layer_bwd`` | ``mp_layer.fused_mp_layer_bwd_kernel`` | ``fused_mp_layer_bwd_plain`` |
| ``msmp::lem_fwd`` | ``lem_scan.lem_scan_kernel`` | ``lem_scan_plain`` |
| ``msmp::lem_bwd`` | ``lem_scan.lem_scan_bwd_kernel`` | ``lem_scan_bwd_plain`` |

Each op also has a fake implementation, which gives its outputs' shapes and
dtypes from its inputs'. A CUDA implementation runs its kernel or raises
and never the plain version; the kernel functions count their launches,
so a replayed program counts too. Each implementation looks its function
up in its module at call time, so that a function replaced there (a test's
spy, ``chip_smoke.kept_launches``) is the one the op runs. The ops carry
no autograd formula: the ``autograd.Function``s of the three modules call
them, forward and backward.

The ops are defined on a ``torch.library.Library`` with an implementation
a dispatch key, not with ``torch.library.custom_op``, whose Python
autograd and aliasing wrappers cost about twice the host time a call.

The outputs have a fixed arity: ``pair_fwd`` returns (out, gn, ln) and
``lem_fwd`` (yT, zT, ys, zs), the stashed tensors empty without
``stash``; the backwards return their weight gradients as one flat tensor
in parameter order (``mp_layer._split_grads`` makes the views), since an
op's outputs may not alias each other. No op takes the kernels'
``workspace=``: the workspace is allocated inside the CUDA
implementation, and only the kernel functions, called directly, leave it
to a caller.
"""
from __future__ import annotations

import types

import torch

from msmp_pde_torch.ops import lem_scan, mp_layer, mp_pair

LIB = torch.library.Library("msmp", "DEF")

_MP = "Tensor h, Tensor u, Tensor px, Tensor v, Tensor idx, Tensor mask"
_LEM = "Tensor gx, Tensor zx, Tensor y0, Tensor z0, Tensor wy, Tensor wzz"
SCHEMAS = {
    "pair_fwd": f"({_MP}, Tensor[] Wg, Tensor[] Wl, bool stash, "
                "str mp_precision) -> (Tensor, Tensor, Tensor)",
    "pair_bwd": f"({_MP}, Tensor[] Wg, Tensor[] Wl, Tensor g, "
                "str mp_precision) -> (Tensor, Tensor)",
    "layer_fwd": f"({_MP}, Tensor[] W, bool final_act, bool residual, "
                 "str mp_precision) -> Tensor",
    "layer_bwd": f"({_MP}, Tensor[] W, Tensor g, bool final_act, "
                 "bool residual, str mp_precision) -> (Tensor, Tensor)",
    "lem_fwd": f"({_LEM}, float dt, bool stash) "
               "-> (Tensor, Tensor, Tensor, Tensor)",
    "lem_bwd": f"({_LEM}, Tensor ys, Tensor zs, Tensor dyT, Tensor dzT, "
               "float dt) -> (Tensor, Tensor, Tensor, Tensor, Tensor, "
               "Tensor)",
}


def _empty(x):
    return x.new_empty(0)


def _layer_numel(H, D, V):
    """Parameters of one layer's 12-tuple (``mp_layer._weight_shapes``)."""
    return 2 * H * H + D * H + H + V * H + H + H * H + H \
        + (2 * H + V) * H + H + H * H + H


def _flat(*tuples):
    """Weight gradients in parameter order as one flat tensor: the one
    the kernel's gradients are views of (``mp_layer._split_grads``), else
    their concatenation."""
    grads = [w for t in tuples for w in t]
    base = grads[0]._base
    if (base is not None and all(w._base is base for w in grads)
            and base.numel() == sum(w.numel() for w in grads)):
        return base
    return torch.cat([w.reshape(-1) for w in grads])


# ---- msmp::pair_fwd ---------------------------------------------------
def _pair_fwd(fn, h, u, px, v, idx, mask, Wg, Wl, stash, mp_precision):
    out = fn(h, u, px, v, idx, mask, Wg, Wl, stash, mp_precision)
    return out if stash else (out, _empty(out), _empty(out))


def _pair_fwd_fake(h, u, px, v, idx, mask, Wg, Wl, stash, mp_precision):
    if stash:
        return tuple(torch.empty_like(h) for _ in range(3))
    return torch.empty_like(h), _empty(h), _empty(h)


# ---- msmp::pair_bwd ---------------------------------------------------
def _pair_bwd(fn, h, u, px, v, idx, mask, Wg, Wl, g, mp_precision):
    dh, dwg, dwl = fn(h, u, px, v, idx, mask, Wg, Wl, g, mp_precision)
    return dh, _flat(dwg, dwl)


def _pair_bwd_fake(h, u, px, v, idx, mask, Wg, Wl, g, mp_precision):
    H, D, V = h.shape[-1], u.shape[-1], v.shape[-1]
    return torch.empty_like(g), h.new_empty(2 * _layer_numel(H, D, V))


# ---- msmp::layer_fwd --------------------------------------------------
def _layer_fwd(fn, h, u, px, v, idx, mask, W, final_act, residual,
               mp_precision):
    return fn(h, u, px, v, idx, mask, W, final_act, residual, mp_precision)


def _layer_fwd_fake(h, u, px, v, idx, mask, W, final_act, residual,
                    mp_precision):
    return torch.empty_like(h)


# ---- msmp::layer_bwd --------------------------------------------------
def _layer_bwd(fn, h, u, px, v, idx, mask, W, g, final_act, residual,
               mp_precision):
    dh, dws = fn(h, u, px, v, idx, mask, W, g, final_act, residual,
                 mp_precision)
    return dh, _flat(dws)


def _layer_bwd_fake(h, u, px, v, idx, mask, W, g, final_act, residual,
                    mp_precision):
    H, D, V = h.shape[-1], u.shape[-1], v.shape[-1]
    return torch.empty_like(g), h.new_empty(_layer_numel(H, D, V))


# ---- msmp::lem_fwd ----------------------------------------------------
def _lem_fwd(fn, gx, zx, y0, z0, wy, wzz, dt, stash):
    out = fn(gx, zx, y0, z0, wy, wzz, dt=dt, stash=stash)
    return tuple(out) if stash else (*out, _empty(gx), _empty(gx))


def _lem_fwd_fake(gx, zx, y0, z0, wy, wzz, dt, stash):
    stashed = ((torch.empty_like(zx), torch.empty_like(zx)) if stash
               else (_empty(gx), _empty(gx)))
    return (torch.empty_like(y0), torch.empty_like(z0)) + stashed


# ---- msmp::lem_bwd ----------------------------------------------------
def _lem_bwd(fn, gx, zx, y0, z0, wy, wzz, ys, zs, dyT, dzT, dt):
    return tuple(fn(gx, zx, y0, z0, wy, wzz, ys, zs, dyT, dzT, dt=dt))


def _lem_bwd_fake(gx, zx, y0, z0, wy, wzz, ys, zs, dyT, dzT, dt):
    return tuple(torch.empty_like(x) for x in (gx, zx, y0, z0, wy, wzz))


# op: (its body over a function, its fake implementation, (module, the
# kernel function's name), (module, the plain version's name))
_OPS = {
    "pair_fwd": (_pair_fwd, _pair_fwd_fake,
                 (mp_pair, "fused_gated_pair_kernel"),
                 (mp_pair, "fused_gated_pair_plain")),
    "pair_bwd": (_pair_bwd, _pair_bwd_fake,
                 (mp_pair, "fused_gated_pair_bwd_kernel"),
                 (mp_pair, "fused_gated_pair_bwd_plain")),
    "layer_fwd": (_layer_fwd, _layer_fwd_fake,
                  (mp_layer, "fused_mp_layer_kernel"),
                  (mp_layer, "fused_mp_layer_plain")),
    "layer_bwd": (_layer_bwd, _layer_bwd_fake,
                  (mp_layer, "fused_mp_layer_bwd_kernel"),
                  (mp_layer, "fused_mp_layer_bwd_plain")),
    "lem_fwd": (_lem_fwd, _lem_fwd_fake, (lem_scan, "lem_scan_kernel"),
                (lem_scan, "lem_scan_plain")),
    "lem_bwd": (_lem_bwd, _lem_bwd_fake, (lem_scan, "lem_scan_bwd_kernel"),
                (lem_scan, "lem_scan_bwd_plain")),
}


def _bound(body, mod, name):
    """``body`` over ``mod.name``, looked up at each call."""
    return lambda *a: body(getattr(mod, name), *a)


IMPLS = {}  # op -> SimpleNamespace(cuda, cpu, fake): what is registered
for _op, (_body, _fake, _kernel, _plain) in _OPS.items():
    LIB.define(_op + SCHEMAS[_op], tags=(torch.Tag.pt2_compliant_tag,))
    IMPLS[_op] = types.SimpleNamespace(cuda=_bound(_body, *_kernel),
                                       cpu=_bound(_body, *_plain),
                                       fake=_fake)
    LIB.impl(_op, IMPLS[_op].cuda, "CUDA")
    LIB.impl(_op, IMPLS[_op].cpu, "CPU")
    torch.library.register_fake(f"msmp::{_op}", _fake, lib=LIB)
