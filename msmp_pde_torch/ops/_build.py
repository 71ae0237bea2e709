"""Build ``csrc/*.cu`` into shared libraries with a plain C interface and
load them with ctypes.

Each source compiles on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>.so csrc/<name>.cu

into ``build/torch_kernels/`` at the root of the checkout. A library newer
than its source and every shared header (``csrc/*.cuh``) is reused.
``build_all`` rebuilds every source, one ``nvcc`` each, all started
together. Every C entry point returns
``cudaGetLastError()``; ``check`` raises if it is not 0.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("lem_fwd", "lem_bwd", "mp_pair_fwd", "mp_pair_bwd", "mp_layer_fwd",
           "mp_layer_bwd")

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return not lib.exists() or lib.stat().st_mtime < newest


def _start(name: str, extra=(), lib=None):
    src, default = _paths(name)
    lib = Path(lib or default)
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    return out


def build_all() -> dict:
    """Compile every source, all in parallel; returns nvcc's output per
    source with ptxas's resource report (registers, shared memory,
    spills)."""
    with _lock:
        procs = {n: _start(n, ("-Xptxas", "-v")) for n in SOURCES}
        return {n: _finish(n, p) for n, p in procs.items()}


def build_variant(name: str, lib, extra) -> str:
    """Compile ``csrc/<name>.cu`` with the extra nvcc flags ``extra`` into
    the library ``lib`` (another path than the one ``load`` uses); returns
    nvcc's output. For measurement builds, e.g. ``-DMP_PHASE_TIMES``."""
    with _lock:
        return _finish(name, _start(name, ("-Xptxas", "-v", *extra), lib))


def use(name: str, lib) -> ctypes.CDLL:
    """Load ``lib`` as the library of ``csrc/<name>.cu`` for this process,
    in place of the one ``load`` builds."""
    with _lock:
        _libs[name] = ctypes.CDLL(str(lib))
        return _libs[name]


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        if name not in _libs:
            if _stale(name):
                _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _libs[name]


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
