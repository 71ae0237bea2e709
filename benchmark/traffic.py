"""The one generator of the benchmark's inputs: seeds, trajectories, the
training feed and the serving requests, all from ``--seed`` and the
parameters of a traffic file (benchmark/traffic/<name>.json).

Each input draws from a stream of its own (``stream_seed``), so that the
weights, the data and the order of the work do not depend on one another.
"""
from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = ("weights", "data", "feed", "sample")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of ``stream`` derived from ``seed`` (any integer)."""
    words = [int(w) for w in np.frombuffer(
        abs(int(seed)).to_bytes(16, "little"), np.uint32)]
    ss = np.random.SeedSequence(words + [int(seed < 0),
                                         STREAMS.index(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def smooth(n, t_grid, x, L, gen: torch.Generator):
    """[n, nt, nx] float32 on the generator's device: four Fourier modes a
    trajectory, amplitudes U(0.5, 1) / k, phases U(0, 2 pi) drifting with
    t at U(-1, 1) k. The device twin of msmp_pde_torch/tools/model_times.py
    ``smooth`` (the same formula; torch's generator in place of numpy's)."""
    dev = t_grid.device
    k = torch.arange(1, 5, device=dev, dtype=torch.float32)
    draws = torch.rand((3, n, 4), generator=gen, device=dev)
    amp = (0.5 + 0.5 * draws[0]) / k
    phase = 2 * math.pi * draws[1]
    speed = (2.0 * draws[2] - 1.0) * k
    u = torch.zeros((n, t_grid.numel(), x.numel()), device=dev)
    for m in range(4):
        arg = (2 * math.pi * (m + 1) / L * x[None, None, :]
               + phase[:, m, None, None]
               + speed[:, m, None, None] * t_grid[None, :, None])
        u.add_(amp[:, m, None, None] * torch.sin(arg))
    return u


class TrainFeed:
    """Batches in the order of msmp_pde_torch/training/loop.py
    ``train_epoch``: for each pass over the n trajectories a permutation,
    then one pushforward depth a batch (uniform over 0..min(epoch,
    unrolling)), then each batch's start steps in [tw, nt - tw - tw depth].
    ``next()`` -> (row indices [B], start steps [B], depth), the two
    tensors on ``device``."""

    def __init__(self, n, batch, nt, tw, epoch, unrolling, rng, device):
        self.n, self.batch, self.nt, self.tw = n, batch, nt, tw
        self.choices = list(range(min(epoch, unrolling) + 1))
        self.rng, self.device = rng, device
        self.n_batches = max(1, n // batch)
        self._pass = None
        self._b = 0

    def _draw_pass(self):
        rng, tw, nb, bs = self.rng, self.tw, self.n_batches, self.batch
        perm = rng.permutation(self.n)[: nb * bs].reshape(nb, bs)
        flags = [int(rng.choice(self.choices)) for _ in range(nb)]
        steps = np.stack([rng.integers(tw, self.nt - tw - tw * f + 1,
                                       size=bs) for f in flags])
        self._pass = (torch.as_tensor(perm, device=self.device),
                      torch.as_tensor(steps, device=self.device), flags)
        self._b = 0

    def next(self):
        if self._pass is None or self._b == self.n_batches:
            self._draw_pass()
        perm_d, steps_d, flags = self._pass
        b = self._b
        self._b += 1
        return perm_d[b], steps_d[b], flags[b]


class ServeFeed:
    """Closed-loop requests: each an ensemble of ``members`` initial
    windows drawn without replacement from the pool. ``next()`` -> (pool
    indices, the windows [members, nx, tw] as numpy)."""

    def __init__(self, pool_windows: np.ndarray, members: int, rng):
        self.pool, self.members, self.rng = pool_windows, members, rng

    def next(self):
        idx = self.rng.choice(self.pool.shape[0], self.members,
                              replace=False)
        return idx, self.pool[idx]


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``
    (Algorithm R): the window's answers are sampled evenly, however many
    it held, without keeping them all."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item
