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
import re
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


def build_variants(names, out_dir, extra) -> dict:
    """Compile each ``csrc/<name>.cu`` of ``names`` with the extra nvcc
    flags ``extra`` into ``out_dir/lib<name>.so`` (another directory than
    the one ``load`` uses), all in parallel; returns nvcc's output per
    source. For measurement builds, e.g. ``-DMP_PHASE_TIMES``."""
    out_dir = Path(out_dir)
    with _lock:
        procs = {n: _start(n, ("-Xptxas", "-v", *extra),
                           out_dir / f"lib{n}.so") for n in names}
        return {n: _finish(n, p) for n, p in procs.items()}


def demangle(names):
    """The demangled ``names`` (cu++filt), without return type, namespace
    and parameter list (``lem_fwd_kernel<(int)24, (bool)1>``); the names as
    they are where cu++filt is missing."""
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        full = out.stdout.splitlines()
    except OSError:
        full = []
    return [_short(n) for n in (full if len(full) == len(names) else names)]


def _short(name: str) -> str:
    if name.endswith(")"):  # cut the parameter list, the last (...) group
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    for junk in ("void ", "<unnamed>::", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    return name


def resources(report: str):
    """[(kernel, its resource lines)] from ``-Xptxas -v``'s report (as
    ``build_all`` returns it): registers, spills, shared memory."""
    found, cur = [], None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            if m.group(1) != cur:
                cur = m.group(1)
                found.append((cur, []))
        elif cur and ("registers" in line or "spill" in line):
            found[-1][1].append(line.split(":", 1)[-1].strip())
    names = demangle([n for n, _ in found])
    return [(n, lines) for n, (_, lines) in zip(names, found)]


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
                from msmp_pde_torch import tracing

                with tracing.span("op.build"):
                    _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _libs[name]


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
