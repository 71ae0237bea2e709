"""LEM recurrent scan, forward (counterpart of msmp_pde_tpu/ops/lem_pallas.py).

``lem_scan`` runs the hand-written kernel ``csrc/lem_fwd.cu`` on CUDA
tensors and the plain PyTorch loop ``lem_scan_plain`` on CPU tensors. The
input projections (``gx``, ``zx``) are computed outside, by the caller
(models/lem.py).
"""
from __future__ import annotations

import ctypes

import torch

from msmp_pde_torch.ops import _build

launches = 0  # kernel launches since the last reset


def lem_scan_plain(gx, zx, y0, z0, wy, wzz, *, dt: float = 1.0):
    """gx [T, N, 3H], zx [T, N, H], y0/z0 [N, H], wy [H, 3H], wzz [H, H]
    -> (y_T, z_T)."""
    H = y0.shape[-1]
    y, z = y0, z0
    for t in range(gx.shape[0]):
        g = gx[t] + y @ wy
        g1, g2, zc = g[:, :H], g[:, H:2 * H], g[:, 2 * H:]
        dt1 = dt * torch.sigmoid(g1)
        dt2 = dt * torch.sigmoid(g2)
        z = (1.0 - dt1) * z + dt1 * torch.tanh(zc)
        y = (1.0 - dt2) * y + dt2 * torch.tanh(zx[t] + z @ wzz)
    return y, z


def _lib():
    lib = _build.load("lem_fwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lem_fwd.argtypes = [p] * 8 + [i, i, i, ctypes.c_float, p]
        lib.lem_fwd.restype = i
        lib.lem_fwd_smem_bytes.argtypes = [i]
        lib.lem_fwd_smem_bytes.restype = i
        lib._typed = True
    return lib


def _check_inputs(gx, zx, y0, z0, wy, wzz):
    T, N, H3 = gx.shape
    H = H3 // 3
    want = {"gx": (T, N, 3 * H), "zx": (T, N, H), "y0": (N, H),
            "z0": (N, H), "wy": (H, 3 * H), "wzz": (H, H)}
    for name, x in zip(want, (gx, zx, y0, z0, wy, wzz)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"lem_scan: {name} is {tuple(x.shape)}, "
                             f"expected {want[name]}")
        if not x.is_cuda or x.dtype != torch.float32:
            raise ValueError(f"lem_scan kernel: {name} must be a float32 "
                             "CUDA tensor")
    if H % 32 or H > 1024:
        raise ValueError(f"lem_scan kernel: hidden {H} must be a multiple "
                         "of 32 and at most 1024")
    return T, N, H


def lem_scan_kernel(gx, zx, y0, z0, wy, wzz, *, dt: float = 1.0):
    """Launch ``csrc/lem_fwd.cu``; raises on anything it does not take."""
    global launches
    T, N, H = _check_inputs(gx, zx, y0, z0, wy, wzz)
    lib = _lib()
    if lib.lem_fwd_smem_bytes(H) > 232448:
        raise ValueError(f"lem_scan kernel: hidden {H} needs more shared "
                         "memory than a block has")
    args = [x.contiguous() for x in (gx, zx, y0, z0, wy, wzz)]
    yT = torch.empty_like(args[2])
    zT = torch.empty_like(args[3])
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    with torch.cuda.device(gx.device):
        err = lib.lem_fwd(*[x.data_ptr() for x in args], yT.data_ptr(),
                          zT.data_ptr(), T, N, H, float(dt), stream)
    _build.check(err, "lem_fwd")
    launches += 1
    return yT, zT


def lem_scan(gx, zx, y0, z0, wy, wzz, *, dt: float = 1.0):
    """CPU tensors -> ``lem_scan_plain``; CUDA tensors -> the kernel."""
    if gx.is_cuda:
        return lem_scan_kernel(gx, zx, y0, z0, wy, wzz, dt=dt)
    return lem_scan_plain(gx, zx, y0, z0, wy, wzz, dt=dt)
