"""LEM recurrent scan, forward and backward (counterpart of
msmp_pde_tpu/ops/lem_pallas.py).

``lem_scan`` runs the hand-written kernels on CUDA tensors and the plain
PyTorch loops on CPU tensors: ``csrc/lem_fwd.cu`` (``lem_scan_plain``),
with the per-step stash when a gradient is needed, and ``csrc/lem_bwd.cu``
(``lem_scan_bwd_plain``), the BPTT reverse sweep, through the
``torch.autograd.Function`` ``LemScan``. The input projections (``gx``,
``zx``) are computed outside, by the caller (models/lem.py).
"""
from __future__ import annotations

import ctypes

import torch

from msmp_pde_torch.ops import _build

launches = 0        # lem_fwd launches (both variants) since the last reset
stash_launches = 0  # of which with the per-step stash
bwd_launches = 0    # lem_bwd launches


def lem_scan_plain(gx, zx, y0, z0, wy, wzz, *, dt: float = 1.0,
                   stash: bool = False):
    """gx [T, N, 3H], zx [T, N, H], y0/z0 [N, H], wy [H, 3H], wzz [H, H]
    -> (y_T, z_T), and with ``stash`` also the per-step states ys, zs
    [T, N, H] (ys[t] is y after step t)."""
    H = y0.shape[-1]
    y, z = y0, z0
    ys, zs = [], []
    for t in range(gx.shape[0]):
        g = gx[t] + y @ wy
        g1, g2, zc = g[:, :H], g[:, H:2 * H], g[:, 2 * H:]
        dt1 = dt * torch.sigmoid(g1)
        dt2 = dt * torch.sigmoid(g2)
        z = (1.0 - dt1) * z + dt1 * torch.tanh(zc)
        y = (1.0 - dt2) * y + dt2 * torch.tanh(zx[t] + z @ wzz)
        ys.append(y)
        zs.append(z)
    if stash:
        return y, z, torch.stack(ys), torch.stack(zs)
    return y, z


def lem_scan_bwd_plain(gx, zx, y0, z0, wy, wzz, ys, zs, dyT, dzT, *,
                       dt: float = 1.0):
    """BPTT reverse sweep (lem_pallas.py:73-138): recompute each step from
    the stashed states, carry (dy, dz). Returns (dgx, dzx, dy0, dz0, dwy,
    dwzz)."""
    T = gx.shape[0]
    H = y0.shape[-1]
    dy, dz = dyT, dzT
    dgx, dzx = torch.empty_like(gx), torch.empty_like(zx)
    dwy, dwzz = torch.zeros_like(wy), torch.zeros_like(wzz)
    for t in range(T - 1, -1, -1):
        y_prev = y0 if t == 0 else ys[t - 1]
        z_prev = z0 if t == 0 else zs[t - 1]
        z_cur = zs[t]
        g = gx[t] + y_prev @ wy
        s1 = torch.sigmoid(g[:, :H])
        s2 = torch.sigmoid(g[:, H:2 * H])
        th_zc = torch.tanh(g[:, 2 * H:])
        th_a = torch.tanh(zx[t] + z_cur @ wzz)
        dt1, dt2 = dt * s1, dt * s2
        da = dy * dt2 * (1.0 - th_a * th_a)
        dg2 = dy * (th_a - y_prev) * dt * s2 * (1.0 - s2)
        dz = dz + da @ wzz.T
        dwzz = dwzz + z_cur.T @ da
        dzx[t] = da
        dg1 = dz * (th_zc - z_prev) * dt * s1 * (1.0 - s1)
        dzc = dz * dt1 * (1.0 - th_zc * th_zc)
        dg = torch.cat([dg1, dg2, dzc], dim=1)
        dgx[t] = dg
        dy = dy * (1.0 - dt2) + dg @ wy.T
        dwy = dwy + y_prev.T @ dg
        dz = dz * (1.0 - dt1)
    return dgx, dzx, dy, dz, dwy, dwzz


# ---- the kernels ---------------------------------------------------------
def _lib(name):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "lem_fwd":
            lib.lem_fwd.argtypes = [p] * 10 + [i, i, i, ctypes.c_float, p]
        else:
            lib.lem_bwd.argtypes = [p] * 18 + [i, i, i, ctypes.c_float, p]
            lib.lem_bwd_partial_floats.argtypes = [i, i, i]
            lib.lem_bwd_partial_floats.restype = ctypes.c_long
        getattr(lib, name).restype = i
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.argtypes = [i]
        smem.restype = i
        lib._typed = True
    return lib


def _check(named, T, N, H):
    want = {"gx": (T, N, 3 * H), "zx": (T, N, H), "y0": (N, H),
            "z0": (N, H), "wy": (H, 3 * H), "wzz": (H, H),
            "ys": (T, N, H), "zs": (T, N, H), "dyT": (N, H), "dzT": (N, H)}
    for name, x in named.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"lem_scan: {name} is {tuple(x.shape)}, "
                             f"expected {want[name]}")
        if not x.is_cuda or x.dtype != torch.float32:
            raise ValueError(f"lem_scan kernel: {name} must be a float32 "
                             "CUDA tensor")
    if H % 32 or H > 1024:
        raise ValueError(f"lem_scan kernel: hidden {H} must be a multiple "
                         "of 32 and at most 1024")
    return [x.contiguous() for x in named.values()]


def _smem_ok(lib, name, H):
    if getattr(lib, f"{name}_smem_bytes")(H) > 232448:
        raise ValueError(f"lem_scan kernel: hidden {H} needs more shared "
                         "memory than a block has")


def lem_scan_kernel(gx, zx, y0, z0, wy, wzz, *, dt: float = 1.0,
                    stash: bool = False):
    """Launch ``csrc/lem_fwd.cu``; raises on anything it does not take.
    Returns (yT, zT), and with ``stash`` also (ys, zs)."""
    global launches, stash_launches
    T, N, H3 = gx.shape
    H = H3 // 3
    args = _check(dict(gx=gx, zx=zx, y0=y0, z0=z0, wy=wy, wzz=wzz), T, N, H)
    lib = _lib("lem_fwd")
    _smem_ok(lib, "lem_fwd", H)
    yT = torch.empty_like(args[2])
    zT = torch.empty_like(args[3])
    outs = [yT, zT]
    if stash:
        outs += [torch.empty_like(args[1]), torch.empty_like(args[1])]
    ptr = [x.data_ptr() for x in outs] + [None] * (4 - len(outs))
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    with torch.cuda.device(gx.device):
        err = lib.lem_fwd(*[x.data_ptr() for x in args], *ptr, T, N, H,
                          float(dt), stream)
    _build.check(err, "lem_fwd")
    launches += 1
    stash_launches += int(stash)
    return tuple(outs)


def lem_scan_bwd_kernel(gx, zx, y0, z0, wy, wzz, ys, zs, dyT, dzT, *,
                        dt: float = 1.0):
    """Launch ``csrc/lem_bwd.cu`` (the reverse sweep, then the weight
    gradients as per-chunk partials reduced in a fixed order); raises on
    anything it does not take. Returns (dgx, dzx, dy0, dz0, dwy, dwzz)."""
    global bwd_launches
    T, N, H3 = gx.shape
    H = H3 // 3
    args = _check(dict(gx=gx, zx=zx, y0=y0, z0=z0, wy=wy, wzz=wzz, ys=ys,
                       zs=zs, dyT=dyT, dzT=dzT), T, N, H)
    lib = _lib("lem_bwd")
    _smem_ok(lib, "lem_bwd", H)
    # the sweep reads wy's rows for dg @ wy^T: a transposed copy keeps those
    # reads coalesced
    wyT = args[4].t().contiguous()
    dgx, dzx = torch.empty_like(args[0]), torch.empty_like(args[1])
    dy0, dz0 = torch.empty_like(args[2]), torch.empty_like(args[3])
    dwy, dwzz = torch.empty_like(args[4]), torch.empty_like(args[5])
    partial = torch.empty(lib.lem_bwd_partial_floats(T, N, H),
                          device=gx.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    outs = (dgx, dzx, dy0, dz0, dwy, dwzz)
    with torch.cuda.device(gx.device):
        err = lib.lem_bwd(*[x.data_ptr() for x in args], wyT.data_ptr(),
                          *[x.data_ptr() for x in outs], partial.data_ptr(),
                          T, N, H, float(dt), stream)
    _build.check(err, "lem_bwd")
    bwd_launches += 1
    return outs


# ---- dispatch and autograd -----------------------------------------------
class LemScan(torch.autograd.Function):
    """apply(gx, zx, y0, z0, wy, wzz, dt) -> (y_T, z_T). The forward runs
    the stash variant and saves the per-step states; the backward is the
    BPTT sweep. CPU tensors take the plain loops, CUDA tensors the
    kernels."""

    @staticmethod
    def forward(ctx, gx, zx, y0, z0, wy, wzz, dt):
        if gx.is_cuda:
            yT, zT, ys, zs = lem_scan_kernel(gx, zx, y0, z0, wy, wzz, dt=dt,
                                             stash=True)
        else:
            yT, zT, ys, zs = lem_scan_plain(gx, zx, y0, z0, wy, wzz, dt=dt,
                                            stash=True)
        ctx.save_for_backward(gx, zx, y0, z0, wy, wzz, ys, zs)
        ctx.dt = dt
        return yT, zT

    @staticmethod
    def backward(ctx, dyT, dzT):
        bwd = lem_scan_bwd_kernel if dyT.is_cuda else lem_scan_bwd_plain
        return bwd(*ctx.saved_tensors, dyT, dzT, dt=ctx.dt) + (None,)


def lem_scan(gx, zx, y0, z0, wy, wzz, *, dt: float = 1.0):
    """CPU tensors -> the plain loops; CUDA tensors -> the kernels. With
    grad enabled and a differentiable input, through ``LemScan`` (stash
    forward, BPTT backward); otherwise the stash-free forward, as the TPU
    primal path (lem_pallas.py:260-263)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (gx, zx, y0, z0, wy, wzz)):
        return LemScan.apply(gx, zx, y0, z0, wy, wzz, float(dt))
    if gx.is_cuda:
        return lem_scan_kernel(gx, zx, y0, z0, wy, wzz, dt=dt)
    return lem_scan_plain(gx, zx, y0, z0, wy, wzz, dt=dt)
