"""Data parallelism over processes (counterpart of
msmp_pde_tpu/parallel/mesh.py).

The JAX package shards a batch over a 1-D 'dp' device mesh and lets GSPMD
insert the collectives. Here each device is a process of a
``torch.distributed`` group, started by ``torchrun`` (one process a card):

* ``init_distributed`` joins the group from torchrun's environment;
* every rank holds the whole model and data (same seed, same files) and
  takes its contiguous slice of each batch (``shard_rows``), as the mesh
  shards a batch axis in contiguous blocks;
* ``dp_sharded_step`` wraps a train step so that each rank runs its slice;
  the step's loss is the global one (``global_sum``) and the gradients are
  summed over the ranks (``sum_grads``), training/loop.py says why;
* ``gather_rows`` and ``gather_in_order`` bring results back in sample
  order.

Without a group every function is the single-process identity, so the
callers run one code path; in a group of one rank the collectives run.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def active() -> bool:
    """Whether this process is in a group (of any size: at world size 1
    the collectives run, each the identity)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def init_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
    as the JAX package's reads JAX_COORDINATOR_ADDRESS; a no-op without
    that environment. The backend is NCCL for a CUDA ``device`` (the
    default) and gloo for the CPU's; ``backend`` names another, and no
    other is ever taken in its place. On the card, rank r uses card
    LOCAL_RANK (``local_device``). Returns whether the process is in a
    group."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method="env://")
    return True


def local_device(device) -> torch.device:
    """This rank's device: under a group on the card, card LOCAL_RANK
    (``cuda`` alone names it, explicitly); any other device as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


_PROBE = "import torch; torch.cuda.init(); print(torch.cuda.device_count())"


def wait_for_backend(device="cuda", max_wait_s: Optional[float] = None,
                     interval_s: float = 30.0, log=print):
    """Wait until the card answers, before a CLI loads its data: the cards
    (``torch.device`` each).

    torch keeps the device count of the first CUDA call of a process
    (``c10::cuda::device_count``, a static), also the 0 of a failed
    initialisation, so a process cannot retry in itself, unlike JAX,
    whose cached failure ``clear_backends`` drops. Each try therefore
    probes in a child process, and this one touches CUDA only after a
    child saw the card. Budget: ``max_wait_s``, else the environment's
    MSMP_BACKEND_WAIT_S, else 1800 s; then raises with the last probe's
    error. A CPU ``device``, or a torch built without CUDA, has nothing to
    wait for: [] (``device.resolve_device`` then raises for the card)."""
    if torch.device(device).type != "cuda" or \
            not torch.backends.cuda.is_built():
        return []
    if not torch.cuda.is_initialized():
        if max_wait_s is None:
            max_wait_s = float(os.environ.get("MSMP_BACKEND_WAIT_S", "1800"))
        deadline = time.monotonic() + max_wait_s
        while True:
            probe = subprocess.run([sys.executable, "-c", _PROBE],
                                   capture_output=True, text=True)
            if probe.returncode == 0:
                break
            err = (probe.stderr.strip().splitlines() or ["no output"])[-1]
            if time.monotonic() >= deadline:
                raise RuntimeError(f"CUDA is unavailable: {err}")
            log(f"CUDA unavailable ({err}); retrying in {interval_s:.0f}s")
            time.sleep(interval_s)
    torch.cuda.init()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@contextlib.contextmanager
def rank0_stdout():
    """Print on rank 0 only: the other ranks' stdout goes to devnull."""
    if rank() == 0:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def shard_bounds(n: int, r: Optional[int] = None,
                 size: Optional[int] = None):
    """Rows [start, stop) of rank ``r`` (default this rank's) of ``n`` rows
    over ``size`` ranks: contiguous blocks, the first n % size one row
    longer."""
    r = rank() if r is None else r
    size = world_size() if size is None else size
    q, extra = divmod(n, size)
    start = r * q + min(r, extra)
    return start, start + q + (r < extra)


def shard_rows(x, axis: int = 0):
    """This rank's contiguous slice of ``x`` along ``axis``."""
    if not active():
        return x
    start, stop = shard_bounds(x.shape[axis])
    return x.narrow(axis, start, stop - start) if torch.is_tensor(x) \
        else x[(slice(None),) * axis + (slice(start, stop),)]


def gather_rows(x):
    """The ranks' equal-sized ``shard_rows`` slices (axis 0) of a tensor,
    concatenated in rank order: the whole batch, on every rank."""
    if not active():
        return x
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def gather_in_order(items: dict) -> dict:
    """{key: value} of every rank merged, for values any rank computed
    (the keys disjoint); tensors come back on the CPU."""
    if not active():
        return dict(items)
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
           for k, v in items.items()}
    parts = [None] * world_size()
    dist.all_gather_object(parts, cpu)
    merged = {}
    for p in parts:
        merged.update(p)
    return merged


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks; the backward passes each rank's cotangent
    through unchanged, since d(sum_r x_r)/d x_r = 1 and every rank holds
    the same cotangent of the sum."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    @staticmethod
    def backward(ctx, g):
        return g


def global_sum(x):
    """``x`` summed over the ranks, differentiably (``_GlobalSum``)."""
    return _GlobalSum.apply(x) if active() else x


def sum_grads(params):
    """Each parameter's gradient summed over the ranks (not averaged), in
    one all-reduce of their concatenation, copied back in one foreach
    launch (a copy a gradient cost 3.2 ms of host time a step at MSMP-PDE's
    156 tensors on an H100; PERF.md §6)."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(parts, grads)])


def broadcast_params(module):
    """Rank 0's parameters and buffers on every rank."""
    if not active():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


def dp_sharded_step(step_fn):
    """The counterpart of the JAX ``dp_sharded_step``: a step
    (u_all, var_all, idx, steps) -> loss that runs ``step_fn`` on this
    rank's slice of the batch (idx and steps sharded, the trajectories
    whole on every rank). ``step_fn`` makes the loss and gradients global
    (training/loop.py)."""
    if not active():
        return step_fn

    def step(u_all, var_all, idx, steps):
        return step_fn(u_all, var_all, shard_rows(idx), shard_rows(steps))

    return step
