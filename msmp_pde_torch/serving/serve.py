"""HTTP rollout server (counterpart of msmp_pde_tpu/serving/serve.py).

    python -m msmp_pde_torch.serving.serve --experiment=E1 --model=MSMP-PDE \
        --checkpoint=params.npz --port=8476 [--device=cuda]

Protocol (stdlib only, npz over HTTP):

* ``GET /healthz`` -> JSON {status, backend, experiment, model,
  mp_precision, buckets, devices, grid} (grid: the dataset file the grid
  came from, or "uniform").
* ``GET /metrics`` -> request counters and latency quantiles.
* ``POST /v1/rollout?n_windows=8[&format=trajectory]`` with an ``.npz``
  body containing ``window`` [B, nx, d*tw] float32, optional ``steps`` [B]
  int32 (label-window start indices; default time_window) and one optional
  float32 [B] array per equation variable. Response: ``.npz`` with
  ``preds`` [B, n_windows, nx, d*tw], or ``trajectory`` [B, n_windows*tw,
  d, nx] when ``format=trajectory``.

``--model`` is a ported registry name (models/registry.py::PORTED): one of
the nine 1-D graph models or the 1-D grid models BaseCNN, FNO, FNOP and
VNO (E1-E3, kdv; the 1-D models also on WE1-3, KF and KS), or the ten
2-D graph models or BaseCNN2D, FNO2D and FNO2DP (RP, MSWG, MSWG3; windows
[B, nx, 2 tw], the variables a and b). ``--checkpoint`` is the train
CLI's checkpoint (utils/checkpoint.py) or an ``.npz`` keyed by
``/``-joined flax paths (utils/convert.py). The grid comes from the test
mode of ``--data_dir``'s dataset file where there is one, else the
uniform grid is rebuilt from the PDE; the wave equation's Chebyshev grid
exists only in its data, so WE1-3 need ``--data_dir``. A JAX (orbax)
checkpoint directory is converted first, where JAX is installed, by
``convert_jax_checkpoint.py`` at the root of the repository. ``--dp`` is
the number of devices the engine holds a replica on (0: every visible
card, as the JAX server takes every device; with ``--device=cpu``, N CPU
replicas), a bucket they divide split across them. Device work is
serialized through a lock.

On the card the engine replays each rollout as a CUDA graph of its
(bucket, n_windows) on each replica, captured on the first request of that
pair (serving/engine.py::GraphedRollout) and kept for the server's life.
So a replica holds at most len(batch_buckets) x max_windows graphs, each
keeping its output, bucket x n_windows x nx x d*tw float32, on the card
and in a pinned host buffer of the same size: 41 MB each at bucket 64 and
64 windows on E1's 100 nodes, 1.3 GB each way for all 64 horizons of that
bucket. A key's first request also runs its capture (two eager rollouts
and the capture) under the device lock; ``--warmup_windows`` captures
every bucket at one horizon before the server listens.
"""
from __future__ import annotations

import io
import json
import sys
import threading
import zipfile
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np


class _Stats:
    """Thread-safe request counters + rolling latency quantiles (last 1024
    device-side latencies, seconds). Exposed at GET /metrics."""

    def __init__(self, window: int = 1024):
        from collections import deque

        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)
        self.requests = 0
        self.errors = 0
        self.samples = 0
        self.windows = 0

    def ok(self, batch: int, n_windows: int, latency_s: float):
        with self._lock:
            self.requests += 1
            self.samples += batch
            self.windows += batch * n_windows
            self._lat.append(latency_s)

    def err(self):
        with self._lock:
            self.requests += 1
            self.errors += 1

    def snapshot(self):
        import numpy as _np

        with self._lock:
            lat = list(self._lat)
            out = {
                "requests": self.requests,
                "errors": self.errors,
                "samples": self.samples,
                "windows": self.windows,
            }
        if lat:
            q50, q95, q99 = _np.percentile(lat, [50, 95, 99])
            out["latency_s"] = {
                "p50": round(float(q50), 4),
                "p95": round(float(q95), 4),
                "p99": round(float(q99), 4),
                "max": round(float(max(lat)), 4),
                "n": len(lat),
            }
        return out


def make_handler(engine, meta, max_windows: int = 64,
                 max_batch: int = 1024, max_body_mb: int = 256):
    lock = threading.Lock()
    stats = _Stats()
    known_vars = set(engine.trainer.eq_norms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; CLI prints its own line
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                return self._json(200, {"status": "ok", **meta})
            if path == "/metrics":
                return self._json(200, stats.snapshot())
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/v1/rollout":
                return self._json(404, {"error": "not found"})
            try:
                q = parse_qs(url.query)
                n_windows = int(q.get("n_windows", ["1"])[0])
                if not 1 <= n_windows <= max_windows:
                    # an unbounded horizon would hold the device lock for
                    # as long as a client likes
                    raise ValueError(
                        f"n_windows must be in [1, {max_windows}]"
                    )
                as_traj = q.get("format", [""])[0] == "trajectory"
                length = int(self.headers.get("Content-Length", "0"))
                if length > max_body_mb * 2**20:
                    # bound what a single request can buffer in RAM: drain
                    # the body in fixed-size chunks (so the client gets a
                    # clean 400 instead of a broken pipe mid-upload), then
                    # reject before np.load ever sees it
                    remaining = length
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    raise ValueError(
                        f"request body {length} bytes exceeds the "
                        f"{max_body_mb} MiB limit"
                    )
                with np.load(io.BytesIO(self.rfile.read(length))) as z:
                    window = z["window"]
                    steps = z["steps"] if "steps" in z.files else None
                    variables = {k: z[k] for k in z.files
                                 if k not in ("window", "steps")}
                unknown = set(variables) - known_vars
                if unknown:
                    raise ValueError(
                        f"unknown arrays {sorted(unknown)}; this model "
                        f"takes equation variables {sorted(known_vars)}"
                    )
                if window.ndim >= 1 and window.shape[0] > max_batch:
                    # oversize batches chunk over the largest bucket INSIDE
                    # the device lock — bound how long one client can hold it
                    raise ValueError(
                        f"batch {window.shape[0]} exceeds the {max_batch} "
                        "sample limit; split the request"
                    )
                # pass the parsed dict through even when empty: for a model
                # WITH equation variables an empty request must hit the
                # engine's strict mismatch check (400), not silently serve
                # zero-conditioned predictions via default_variables()
                start = steps if steps is not None else None
                req_vars = variables if known_vars else None
                import time as _time

                t0 = _time.perf_counter()
                with lock:
                    if as_traj:
                        out = engine.trajectory(
                            window, variables=req_vars,
                            start_step=start, n_windows=n_windows)
                        key = "trajectory"
                    else:
                        out = engine.rollout(
                            window, variables=req_vars,
                            start_step=start, n_windows=n_windows)
                        key = "preds"
                stats.ok(int(window.shape[0]), n_windows,
                         _time.perf_counter() - t0)
            except (ValueError, KeyError, TypeError, IndexError,
                    zipfile.BadZipFile, zlib.error, EOFError) as e:
                # malformed inputs surface as these; a closed socket
                # (what an uncaught exception produces here) is strictly
                # worse than a 400 with the message
                stats.err()
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                # genuine server-side faults (device errors, OOM, engine
                # bugs): 500 with a generic message; detail stays in the
                # server log, not the client response
                stats.err()
                import traceback

                traceback.print_exc(file=sys.stderr)
                return self._json(
                    500, {"error": f"internal server error ({type(e).__name__})"}
                )
            buf = io.BytesIO()
            np.savez(buf, **{key: out})
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-npz")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def request_rollout(host: str, port: int, window, *, steps=None,
                    variables=None, n_windows: int = 1,
                    as_trajectory: bool = False,
                    timeout: float = 600.0) -> np.ndarray:
    """Client helper (and the test harness): one POST /v1/rollout."""
    import http.client

    arrays = {"window": np.asarray(window, np.float32)}
    if steps is not None:
        arrays["steps"] = np.asarray(steps, np.int32)
    for k, v in (variables or {}).items():
        arrays[k] = np.asarray(v, np.float32)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    fmt = "&format=trajectory" if as_trajectory else ""
    # a finite timeout turns a wedged server into socket.timeout instead of
    # blocking the caller forever (the first request builds the kernels)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", f"/v1/rollout?n_windows={n_windows}{fmt}",
                     body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npz"})
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"server {resp.status}: {payload[:200]!r}")
    finally:
        conn.close()
    with np.load(io.BytesIO(payload)) as z:
        return z["trajectory" if as_trajectory else "preds"]


def load_checkpoint(path: str):
    """State dict from an ``.npz`` of flax paths or a ``torch.save``
    checkpoint of the train CLI. A directory is a JAX (orbax) checkpoint,
    which the port does not read: it raises, naming the converter."""
    import os

    from msmp_pde_torch.utils.checkpoint import restore_params
    from msmp_pde_torch.utils.convert import load_npz

    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, a JAX (orbax) checkpoint: convert it "
            "where JAX is installed with `python convert_jax_checkpoint.py "
            f"--checkpoint={path} --out=<file>.npz --experiment=... "
            "--model=...` (the server's model arguments) and serve the "
            ".npz")
    return load_npz(path) if path.endswith(".npz") else restore_params(path)


def serving_devices(device, dp: int):
    """The engine's devices for ``--dp``: on the card 0 takes every
    visible card and N the first N (more than there are raises); on the
    CPU N replicas (0 or 1: one)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * max(dp, 1)
    n = torch.cuda.device_count()
    if dp > n:
        raise ValueError(f"--dp {dp}: only {n} CUDA devices are visible")
    return [torch.device("cuda", i) for i in range(dp or n)]


def build_server(args):
    """(the HTTP server bound to ``args.host:args.port``, its engine) of
    the CLI's arguments; ``main`` serves it until interrupted."""
    import os

    from msmp_pde_torch.serving.engine import (
        RolloutEngine,
        build_serving_trainer,
    )
    from msmp_pde_torch.training.setup import data_family, resolve_data_path

    from msmp_pde_torch.parallel import mesh

    from msmp_pde_torch.device import resolve_device

    mesh.wait_for_backend(args.device)
    devices = serving_devices(resolve_device(args.device), args.dp)
    data_path = None
    if args.data_dir:
        p = resolve_data_path(args.data_dir, data_family(args.experiment),
                              args.experiment, args.data_suffix, "test")
        data_path = p if os.path.exists(p) else None
    trainer = build_serving_trainer(
        args.experiment, args.model, data_path=data_path,
        super_resolution=tuple(args.super_resolution),
        base_resolution=tuple(args.base_resolution),
        neighbors=args.neighbors, time_window=args.time_window,
        n_graph_layers=args.n_graph_layers,
        mp_precision=args.mp_precision, device=devices[0],
        data_suffix=args.data_suffix,
    )
    buckets = tuple(args.batch_buckets)
    engine = RolloutEngine(trainer, load_checkpoint(args.checkpoint),
                           batch_buckets=buckets, devices=devices)
    if len(devices) > 1:
        print(f"serving data parallelism over {len(devices)} devices")
    if args.warmup_windows:
        print(f"warming up buckets {buckets} at {args.warmup_windows} "
              "windows...")
        engine.warmup(args.warmup_windows)
    meta = {
        "backend": trainer.device.type,
        "experiment": args.experiment,
        "model": args.model,
        "mp_precision": args.mp_precision,
        "buckets": list(buckets),
        "devices": [str(d) for d in devices],
        "grid": data_path or "uniform",
    }
    srv = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(engine, meta, max_windows=args.max_windows,
                     max_batch=args.max_batch,
                     max_body_mb=args.max_body_mb),
    )
    return srv, engine


def main(args):
    srv, engine = build_server(args)
    print(f"serving {args.model} on {args.experiment} at "
          f"http://{args.host}:{srv.server_address[1]} (device "
          f"{engine.trainer.device})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


def build_parser():
    import argparse

    from msmp_pde_torch.models.registry import PORTED

    p = argparse.ArgumentParser(description="MP-PDE family rollout server")
    p.add_argument("--experiment", type=str, required=True)
    p.add_argument("--model", type=str, default="MSMP-PDE",
                   help="a ported registry name: " + ", ".join(PORTED))
    p.add_argument("--checkpoint", type=str, required=True,
                   help="the train CLI's checkpoint, or an .npz of the flax "
                        "params keyed by '/'-joined paths")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8476)
    p.add_argument("--base_resolution", type=int, nargs=2, default=[250, 100])
    p.add_argument("--super_resolution", type=int, nargs=2, default=[250, 200])
    p.add_argument("--neighbors", type=int, default=3)
    p.add_argument("--time_window", type=int, default=25)
    p.add_argument("--n_graph_layers", type=int, default=6)
    p.add_argument("--batch_buckets", type=int, nargs="+", default=[1, 4, 16])
    p.add_argument("--warmup_windows", type=int, default=8,
                   help="run every bucket once at this horizon (0 = lazy)")
    p.add_argument("--max_windows", type=int, default=64,
                   help="reject rollout requests beyond this horizon (on "
                        "the card each horizon served keeps a CUDA graph a "
                        "bucket and replica)")
    p.add_argument("--max_batch", type=int, default=1024,
                   help="reject requests with more samples than this (an "
                        "oversize batch holds the device lock while it "
                        "chunks)")
    p.add_argument("--max_body_mb", type=int, default=256,
                   help="reject request bodies larger than this many MiB")
    p.add_argument("--data_dir", type=str, default="data",
                   help="grid metadata source (attrs-only read); '' or a "
                        "directory without the dataset rebuilds the "
                        "uniform grid from the PDE")
    p.add_argument("--data_suffix", type=str, default="")
    p.add_argument("--mp_precision", type=str, default="float32",
                   choices=["float32", "bfloat16", "bfloat16s"],
                   help="the message-passing kernels' operand precision "
                        "(bfloat16: bf16 operands, float32 sums; "
                        "bfloat16s: the layers' inputs and weight matrices "
                        "stored in bf16 too)")
    p.add_argument("--dp", type=int, default=0,
                   help="devices holding a replica: 0 every visible card "
                        "(one with --device=cpu), N the first N")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without it) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
