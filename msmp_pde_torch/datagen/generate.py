"""Dataset generation CLI (counterpart of msmp_pde_tpu/datagen/generate.py):

    python -m msmp_pde_torch.datagen.generate --experiment=E1 \
        --train_samples=2048 --valid_samples=128 --test_samples=128

writes ``{data_dir}/{family}_{experiment}.npz``, and ``.h5`` where
``h5py`` imports (datagen/hdf5_io.py), with every resolution of the
family (``RES_CE``; ``RES_AD``, ``RES_KF`` and ``RES_KS`` are the same
list, ``RES_WE`` adds (250, 20)).

TaskIDs:
* E1, E2, E3 and kdv (family CE), which differ only in their coefficient
  ranges;
* RP, RPU, MSWG and MSWG3 (family AD, ``AD_EXPERIMENTS``), the
  two-component advection system solved exactly by characteristics
  (equations/ad.py), trajectories [n, 2, nt, nx] with the speeds a and b;
  RPU is RP on the unstructured LCG grid (``ics.pseudo_random_grid``, one
  grid a resolution, stored as that resolution's ``x``);
* KF, the Kolmogorov-Fisher equation (equations/kf.py), DOPRI45 at rtol
  1e-7, atol 1e-9 and at most 14 halvings an output interval, with r and
  D (log-uniform) by groups;
* KS, the Kuramoto-Sivashinsky equation at L = 22 / 2 pi (equations/ks.py):
  ETDRK4 at dt 0.00025 over tend 100, i.e. 400,000 fine steps, of which
  the 250 or 500 saved follow a transient of int(2 / dt) + 1 steps. Every
  sample of the three modes integrates in one batch a resolution (the rows
  are independent and the step fixed), on the card as replays of CUDA
  graphs;
* WE1, WE2 and WE3, the wave equation on a Chebyshev grid (equations/we.py)
  with Dirichlet, Neumann or mixed boundaries and speed ``--wave_speed``:
  249 products with the exact propagator (``--we_solver expm``) or scipy's
  Radau on the host (``--we_solver radau``), stored time-reversed as the
  reference stores them. WE3 draws bc_left per sample and keeps bc_right
  Dirichlet, the reference's quirk (its ``mixed`` branch assigns bc_left
  twice); bc_left and bc_right are written as ints.

A CE or KF chunk of ``--chunk`` samples integrates at once (the adaptive
solver's error max is shared across the chunk, so the chunk size is part
of what defines the data). Coefficients
are drawn once per ``--batch_size`` group. The random draws come from one
``numpy.random.Generator(seed)`` on the host, per chunk in the order
alpha, beta, gamma groups (a coefficient whose range is one value draws
nothing), then the sum-of-sines parameters (datagen/ics.py): one seed
gives the same data on the card and on the CPU, but not the JAX
package's numbers, which come from threefry keys. An AD chunk draws a
groups, then b groups, then its initial condition's parameters
(``draw_ad_chunk``); a KF chunk r groups, D groups, then the sines
(``draw_kf_chunk``); a KS chunk the sines; a WE mode (one chunk) WE3's
boundary draws, then the pulses' centres (``draw_we_mode``).

The sum of sines is both the initial condition, u0 = force(0), and a
forcing term added to the right-hand side at every stage time.

Precision: float64 by default, ``--dtype float32`` for speed.
``--device`` is cuda by default and raises without it.

Under ``torchrun --nproc_per_node N`` (parallel/mesh.py; the JAX CLI's
``_sharder``) every rank draws the same numbers and, where N divides a
CE or KF chunk, solves its contiguous rows of it, the adaptive solver's
maxima all-reduced on every trial step (temporal/erk.py), so the ranks
take the one process's steps; KS's rows, at fixed steps, split the same
way. The rows are gathered in order and rank 0 writes the files. A chunk
N does not divide is solved whole on every rank, as the sharder leaves
such an array whole; AD and WE, which the JAX CLI does not shard, run on
rank 0 alone.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from msmp_pde_torch.parallel import mesh

# resolutions (nt, nx) of the CE family, the super resolution first
RES_CE = [(250, 200), (250, 100), (250, 50), (250, 40)]
MODES = ("train", "valid", "test")

# experiment -> (tmax, alpha, beta, gamma ranges)
CE_EXPERIMENTS = {
    "E1": (4.0, (1.0, 1.0), (0.0, 0.0), (0.0, 0.0)),
    "E2": (4.0, (1.0, 1.0), (0.0, 0.2), (0.0, 0.0)),
    "E3": (2.0, (0.0, 6.0), (0.1, 0.4), (0.0, 1.0)),
    "kdv": (2.0, (3.0, 3.0), (0.0, 0.0), (1.0, 1.0)),
}
# resolutions of the AD family: the CE list
RES_AD = RES_CE
# experiment -> (tmax, a range, b range, initial condition); L is 2 pi for
# the gaussian families, 16 for the sum of sines
AD_EXPERIMENTS = {
    "RP": (4.0, (0.1, 1.0), (1.0, 10.0), "sinesum"),
    "RPU": (4.0, (0.1, 1.0), (1.0, 10.0), "sinesum"),
    "MSWG": (3.0, (0.1, 1.0), (1.0, 10.0), "gaussian"),
    "MSWG3": (1.0, (0.1, 0.5), (8.0, 10.0), "gaussian_triple"),
}
# KF: (tmax, r range, D range); KS: (tend, fine step); WE: the boundary
# family at tend 100
KF_EXPERIMENTS = {"KF": (5.0, (0.0, 2.0), (1e-6, 1e-2))}
KS_EXPERIMENTS = {"KS": (100.0, 0.00025)}
WE_EXPERIMENTS = {"WE1": "dirichlet", "WE2": "neumann", "WE3": "mixed"}
WE_TEND = 100.0
RES_KF = RES_CE
RES_KS = RES_CE
RES_WE = RES_CE + [(250, 20)]
DTYPES = {"float64": torch.float64, "float32": torch.float32}


class _NoWriter:
    """The writer of a rank other than 0: rank 0 writes the dataset."""

    npz_path = h5_path = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def mode(self, *a, **k):
        return self

    def write(self, *a, **k):
        pass

    def write_scalar(self, *a, **k):
        pass


def _writer(stem: str):
    from msmp_pde_torch.datagen.hdf5_io import DatasetWriter

    return DatasetWriter(stem) if mesh.rank() == 0 else _NoWriter()


def solve_chunk(solve, draws):
    """``solve(*draws)`` of one chunk (every draw [c, ...] on the device),
    on every rank: in a process group whose size divides c each rank
    solves its contiguous rows with the group's shared steps and the rows
    are gathered in order; otherwise the whole chunk here."""
    c = draws[0].shape[0]
    if mesh.active() and c % mesh.world_size() == 0:
        return mesh.gather_rows(solve(*[mesh.shard_rows(a) for a in draws],
                                      group=dist.group.WORLD))
    return solve(*draws)


def _chunks(total: int, chunk: int):
    start = 0
    while start < total:
        yield start, min(chunk, total - start)
        start += min(chunk, total - start)


def _group_draw(rng: np.random.Generator, n_groups: int, lo, hi,
                log_uniform: bool = False) -> np.ndarray:
    """One coefficient per group, U(lo, hi) or log-uniform on [lo, hi];
    fixed (and no draw) when lo == hi."""
    if np.isclose(lo, hi):
        return np.full((n_groups,), float(lo))
    u = rng.uniform(size=n_groups)
    if log_uniform:
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return lo + u * (hi - lo)


def _expand_groups(vals: np.ndarray, batch_size: int) -> np.ndarray:
    return np.repeat(vals, batch_size).reshape(-1, 1, 1)


def draw_chunk(rng: np.random.Generator, c: int, batch_size: int, alpha,
               beta, gamma, pde):
    """The random draws of one chunk of ``c`` samples, in their order:
    (alpha, beta, gamma) [c, 1, 1], one value a ``batch_size`` group, then
    the sum-of-sines (A, omega, phi, l) [c, 1, n_waves]; numpy float64."""
    from msmp_pde_torch.datagen import ics

    groups = -(-c // batch_size)
    coefs = [_expand_groups(_group_draw(rng, groups, *r), batch_size)[:c]
             for r in (alpha, beta, gamma)]
    return (*coefs, *ics.sample_sine_params(rng, c, pde.n_waves, pde.lmin,
                                            pde.lmax))


def ce_solver(pde, dtype: torch.dtype, device):
    """solve(alpha, beta, gamma, A, omega, phi, l, group=None) ->
    [B, nt, 1, nx]: the trajectories of one chunk on ``pde``'s grid, every
    argument a [B, 1, 1] or [B, 1, N] tensor on ``device``; ``group`` as
    ``solve_adaptive``'s."""
    from msmp_pde_torch.datagen import ics
    from msmp_pde_torch.temporal import DOPRI45, solve_adaptive

    x = torch.as_tensor(np.linspace(0.0, pde.L, pde.nx), dtype=dtype,
                        device=device)
    ts = np.linspace(pde.tmin, pde.tmax, pde.nt)

    def solve(alpha, beta, gamma, A, omega, phi, l, group=None):
        sines = ics.sum_of_sines(A, omega, phi, l, pde.L)

        def force(t):
            return sines(x, t)[:, None, :]

        rhs = pde.make_rhs(alpha, beta, gamma, force)
        return solve_adaptive(rhs, force(0.0), ts, DOPRI45, group=group)

    return solve


def generate_ce(args, tmax: float, alpha, beta, gamma):
    """Writes the dataset; returns {(mode, resolution key): seconds}."""
    from msmp_pde_torch.device import resolve_device
    from msmp_pde_torch.equations import CE

    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    pdes = {f"pde_{nt}-{nx}": CE(tmin=0.0, tmax=tmax, grid_size=(nt, nx))
            for nt, nx in RES_CE}
    solvers = {k: ce_solver(p, dtype, dev) for k, p in pdes.items()}
    res_meta = {
        k: dict(nt=p.nt, nx=p.nx, dt=p.dt, dx=p.dx, tmin=p.tmin,
                tmax=p.tmax, x=np.linspace(0.0, p.L, p.nx))
        for k, p in pdes.items()
    }
    pde0 = next(iter(pdes.values()))
    rng = np.random.default_rng(args.seed)
    counts = _counts(args)
    seconds = {}
    os.makedirs(args.data_dir, exist_ok=True)
    stem = os.path.join(args.data_dir, f"CE_{args.experiment}")
    with _writer(stem) as out:
        for mode in MODES:
            n = counts[mode]
            w = out.mode(mode, n, res_meta, ("alpha", "beta", "gamma"))
            print(f"Mode: {mode}  samples: {n}")
            for start, c in _chunks(n, args.chunk):
                draws = draw_chunk(rng, c, args.batch_size, alpha, beta,
                                   gamma, pde0)
                on_dev = [torch.as_tensor(a, dtype=dtype, device=dev)
                          for a in draws]
                for k, pde in pdes.items():
                    t1 = time.perf_counter()
                    traj = solve_chunk(solvers[k], on_dev).reshape(
                        c, pde.nt, pde.nx).cpu().numpy()
                    took = time.perf_counter() - t1
                    seconds[(mode, k)] = seconds.get((mode, k), 0.0) + took
                    print(f"{k}: {took:.4f}s")
                    w.write(k, start, traj)
                # beta is stored as drawn; the training pipeline negates it
                for name, vals in zip(("alpha", "beta", "gamma"), draws):
                    w.write_scalar(name, start, vals)
                print(f"Solved {start + c} / {n}")
                sys.stdout.flush()
    _saved(out)
    return seconds


def ad_pdes(tmax: float, initial_condition: str):
    """{resolution key: AD} of RES_AD: L = 2 pi for the gaussian families,
    16 for the sum of sines and the square."""
    from msmp_pde_torch.equations import AD

    gaussian = initial_condition in ("gaussian", "gaussian_triple")
    L = 2 * np.pi if gaussian else 16.0
    return {f"pde_{nt}-{nx}": AD(tmin=0.0, tmax=tmax, grid_size=(nt, nx),
                                 L=L) for nt, nx in RES_AD}


def draw_ad_chunk(rng: np.random.Generator, c: int, batch_size: int,
                  a_range, b_range, initial_condition: str, pde):
    """The random draws of one AD chunk of ``c`` samples, in their order:
    a [c] and b [c], one value a ``batch_size`` group, then the initial
    condition's parameters (datagen/ics.py); numpy float64."""
    from msmp_pde_torch.datagen import ics

    groups = -(-c // batch_size)
    a, b = (np.repeat(_group_draw(rng, groups, *r), batch_size)[:c]
            for r in (a_range, b_range))
    sample = ics.AD_ICS[initial_condition][0]
    if initial_condition == "sinesum":
        params = sample(rng, c, pde.n_waves, pde.lmin, pde.lmax)
    elif initial_condition == "square":
        params = sample(rng, c, pde.nx, pde.L)
    else:
        params = sample(rng, c)
    return (a, b, *params)


def ad_grid(pde, unstructured_grid: bool = False) -> np.ndarray:
    """The AD grid of ``pde``'s resolution, float64: ``linspace(0, L,
    nx)``, or with ``unstructured_grid`` (RPU) the LCG grid on [0, L]."""
    from msmp_pde_torch.datagen import ics

    if unstructured_grid:
        return ics.pseudo_random_grid(0.0, pde.L, pde.nx)
    return np.linspace(0.0, pde.L, pde.nx)


def ad_solver(pde, initial_condition: str, dtype: torch.dtype, device,
              unstructured_grid: bool = False):
    """solve(a, b, *ic parameters) -> [B, 2, nt, nx]: the exact
    trajectories of one chunk on ``pde``'s grid (``ad_grid``), every
    argument a tensor on ``device``."""
    from msmp_pde_torch.datagen import ics
    from msmp_pde_torch.equations.ad import exact_solution_batch

    x = torch.as_tensor(ad_grid(pde, unstructured_grid), dtype=dtype,
                        device=device)
    ts = torch.as_tensor(np.linspace(pde.tmin, pde.tmax, pde.nt),
                         dtype=dtype, device=device)
    build = ics.AD_ICS[initial_condition][1]

    def solve(a, b, *params):
        return exact_solution_batch(build(*params, pde.L), x, ts, a, b)

    return solve


def generate_rp(args, tmax: float, a_range, b_range, initial_condition,
                unstructured_grid: bool = False):
    """Writes the AD dataset, on the LCG grids with ``unstructured_grid``
    (RPU); returns {(mode, resolution key): seconds}."""
    from msmp_pde_torch.datagen.hdf5_io import DatasetWriter
    from msmp_pde_torch.device import resolve_device

    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    pdes = ad_pdes(tmax, initial_condition)
    solvers = {k: ad_solver(p, initial_condition, dtype, dev,
                            unstructured_grid)
               for k, p in pdes.items()}
    res_meta = {
        k: dict(nt=p.nt, nx=p.nx, dt=p.dt, dx=p.dx, tmin=p.tmin,
                tmax=p.tmax, x=ad_grid(p, unstructured_grid))
        for k, p in pdes.items()
    }
    pde0 = next(iter(pdes.values()))
    rng = np.random.default_rng(args.seed)
    counts = _counts(args)
    seconds = {}
    os.makedirs(args.data_dir, exist_ok=True)
    stem = os.path.join(args.data_dir, f"AD_{args.experiment}")
    with DatasetWriter(stem) as out:
        for mode in MODES:
            n = counts[mode]
            w = out.mode(mode, n, res_meta, ("a", "b"), components=2)
            print(f"Mode: {mode}  samples: {n}")
            for start, c in _chunks(n, args.chunk):
                draws = draw_ad_chunk(rng, c, args.batch_size, a_range,
                                      b_range, initial_condition, pde0)
                on_dev = [torch.as_tensor(a, dtype=dtype, device=dev)
                          for a in draws]
                for k in pdes:
                    t1 = time.perf_counter()
                    traj = solvers[k](*on_dev).cpu().numpy()
                    took = time.perf_counter() - t1
                    seconds[(mode, k)] = seconds.get((mode, k), 0.0) + took
                    print(f"{k}: {took:.4f}s")
                    w.write(k, start, traj)
                w.write_scalar("a", start, draws[0])
                w.write_scalar("b", start, draws[1])
                print(f"Solved {start + c} / {n}")
                sys.stdout.flush()
    _saved(out)
    return seconds


def _counts(args):
    return {"train": args.train_samples, "valid": args.valid_samples,
            "test": args.test_samples}


def _saved(out):
    print(f"Data saved to {out.npz_path}"
          + (f" and {out.h5_path}" if out.h5_path else ""))


# --------------------------------------------------------------------- KF
def kf_pdes(tmax: float):
    from msmp_pde_torch.equations import KF

    return {f"pde_{nt}-{nx}": KF(tmin=0.0, tmax=tmax, grid_size=(nt, nx))
            for nt, nx in RES_KF}


def draw_kf_chunk(rng: np.random.Generator, c: int, batch_size: int,
                  r_range, d_range, pde):
    """The random draws of one KF chunk of ``c`` samples, in their order:
    r [c] and D [c] (log-uniform), one value a ``batch_size`` group, then
    the sum-of-sines (A, omega, phi, l) [c, 1, n_waves] of which the
    initial condition reads A and l; numpy float64."""
    from msmp_pde_torch.datagen import ics

    groups = -(-c // batch_size)
    r = np.repeat(_group_draw(rng, groups, *r_range), batch_size)[:c]
    D = np.repeat(_group_draw(rng, groups, *d_range, log_uniform=True),
                  batch_size)[:c]
    return (r, D, *ics.sample_sine_params(rng, c, pde.n_waves, pde.lmin,
                                          pde.lmax))


def kf_solver(pde, dtype: torch.dtype, device):
    """solve(r, D, A, omega, phi, l, group=None) -> [B, nt, nx]: the
    trajectories of one chunk on ``pde``'s grid (DOPRI45 at rtol 1e-7,
    atol 1e-9, at most 14 halvings), r and D [B], the sines [B, 1, N],
    tensors on ``device``; ``group`` as ``solve_adaptive``'s."""
    import dataclasses

    from msmp_pde_torch.datagen import ics
    from msmp_pde_torch.temporal import DOPRI45, solve_adaptive

    tab = dataclasses.replace(DOPRI45, rtol=1e-7, atol=1e-9)
    x = torch.as_tensor(np.linspace(0.0, pde.L, pde.nx), dtype=dtype,
                        device=device)
    ts = np.linspace(pde.tmin, pde.tmax, pde.nt)

    def solve(r, D, A, omega, phi, l, group=None):
        u0 = ics.kf_ic(A, l, x, pde.L)
        rhs = pde.make_rhs(r=r[:, None], D=D[:, None])
        return solve_adaptive(rhs, u0, ts, tab, max_depth=14, group=group)

    return solve


def generate_kf(args, tmax: float, r_range, d_range):
    """Writes the KF dataset; returns {(mode, resolution key): seconds}."""
    from msmp_pde_torch.device import resolve_device

    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    pdes = kf_pdes(tmax)
    solvers = {k: kf_solver(p, dtype, dev) for k, p in pdes.items()}
    res_meta = {
        k: dict(nt=p.nt, nx=p.nx, dt=p.dt, dx=p.dx, tmin=p.tmin,
                tmax=p.tmax, x=np.linspace(0.0, p.L, p.nx))
        for k, p in pdes.items()
    }
    pde0 = next(iter(pdes.values()))
    rng = np.random.default_rng(args.seed)
    seconds = {}
    os.makedirs(args.data_dir, exist_ok=True)
    with _writer(os.path.join(args.data_dir,
                              f"KF_{args.experiment}")) as out:
        for mode, n in _counts(args).items():
            w = out.mode(mode, n, res_meta, ("r", "D"))
            print(f"Mode: {mode}  samples: {n}")
            for start, c in _chunks(n, args.chunk):
                draws = draw_kf_chunk(rng, c, args.batch_size, r_range,
                                      d_range, pde0)
                on_dev = [torch.as_tensor(a, dtype=dtype, device=dev)
                          for a in draws]
                for k in pdes:
                    t1 = time.perf_counter()
                    traj = solve_chunk(solvers[k], on_dev).cpu().numpy()
                    took = time.perf_counter() - t1
                    seconds[(mode, k)] = seconds.get((mode, k), 0.0) + took
                    print(f"{k}: {took:.4f}s")
                    w.write(k, start, traj)
                w.write_scalar("r", start, draws[0])
                w.write_scalar("D", start, draws[1])
                print(f"Solved {start + c} / {n}")
                sys.stdout.flush()
    _saved(out)
    return seconds


# --------------------------------------------------------------------- KS
def ks_pdes(tend: float, dt_fine: float, resolutions=None):
    """{resolution key: KS} at L = 22 / 2 pi, the chaotic regime."""
    from msmp_pde_torch.equations import KS

    L = 22.0 / (2.0 * np.pi)
    return {f"pde_{nt}-{nx}": KS(L=L, nx=nx, dt=dt_fine, tend=tend,
                                 tstart=0.0, dt_downsampled=tend / nt)
            for nt, nx in (resolutions or RES_KS)}


def ks_solve(kss, params, dtype: torch.dtype, device):
    """[(u_saved [B, nt, nx], valid [B])] of the sine parameters
    ``params`` (A, omega, phi, l; numpy [B, 1, N]) on each KS of ``kss``,
    the initial condition on x = linspace(0, 2 pi L, nx) (``ics.ks_ic``),
    saved at ``ks.save_steps()``; on the card the resolutions run on a
    stream each (``equations.ks.simulate_many``)."""
    from msmp_pde_torch.datagen import ics
    from msmp_pde_torch.equations.ks import simulate_many

    A, _, phi, l = (torch.as_tensor(a, dtype=dtype, device=device)
                    for a in params)
    jobs = []
    for ks in kss:
        x = torch.as_tensor(np.linspace(0.0, 2 * np.pi * ks.L, ks.nx),
                            dtype=dtype, device=device)
        jobs.append((ks, ics.ks_ic(A, phi, l, x, ks.L), ks.save_steps()))
    return simulate_many(jobs)


def generate_ks(args, tend: float, dt_fine: float, resolutions=None):
    """Writes the KS dataset at ``resolutions`` (default ``RES_KS``; the
    base and super resolution a ``fit`` reads suffice to train); returns
    {("all", "all resolutions"): seconds}: one batch of every sample of
    the three modes a resolution, the resolutions together."""
    from msmp_pde_torch.datagen import ics
    from msmp_pde_torch.device import resolve_device

    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    kss = ks_pdes(tend, dt_fine, resolutions)
    ks0 = next(iter(kss.values()))
    res_meta = {
        k: dict(nt=p.nsteps_downsampled, nx=p.nx, dt=p.dt_downsampled,
                dx=p.dx, tmin=p.tstart, tmax=p.tend,
                x=np.linspace(0.0, 2 * np.pi * p.L, p.nx))
        for k, p in kss.items()
    }
    rng = np.random.default_rng(args.seed)
    counts = _counts(args)
    draws = []  # (mode, start, the sines of the chunk), in draw order
    for mode, n in counts.items():
        for start, c in _chunks(n, args.chunk):
            draws.append((mode, start, ics.sample_sine_params(
                rng, c, ks0.n_waves, ks0.lmin, ks0.lmax)))
    params = [np.concatenate([d[2][i] for d in draws]) for i in range(4)]
    seconds = {}
    os.makedirs(args.data_dir, exist_ok=True)
    with _writer(os.path.join(args.data_dir,
                              f"KS_{args.experiment}")) as out:
        writers = {m: out.mode(m, n, res_meta) for m, n in counts.items()}
        t1 = time.perf_counter()
        if mesh.active() and len(params[0]) % mesh.world_size() == 0:
            # each rank its rows of every resolution, gathered in order
            solved = [(mesh.gather_rows(traj), mesh.gather_rows(
                valid.to(torch.uint8)).bool()) for traj, valid in ks_solve(
                    kss.values(), [mesh.shard_rows(p) for p in params],
                    dtype, dev)]
        else:
            solved = ks_solve(kss.values(), params, dtype, dev)
        solved = [(traj.cpu().numpy(), valid) for traj, valid in solved]
        took = time.perf_counter() - t1
        seconds[("all", "all resolutions")] = took
        print(f"{', '.join(kss)}: {took:.4f}s together "
              f"({ks0.nsteps} fine steps each)")
        for (k, ks), (traj, valid) in zip(kss.items(), solved):
            print(f"{k}: valid={int(valid.sum())}/{len(valid)}")
            row = 0
            for mode, start, p in draws:
                c = p[0].shape[0]
                writers[mode].write(k, start, traj[row:row + c])
                row += c
            sys.stdout.flush()
    _saved(out)
    return seconds


# --------------------------------------------------------------------- WE
def we_pdes(tend: float):
    from msmp_pde_torch.equations import WE

    return {f"pde_{nt}-{nx}": WE(tmin=0.0, tmax=tend, grid_size=(nt, nx))
            for nt, nx in RES_WE}


def draw_we_mode(rng: np.random.Generator, n: int, boundary: str):
    """The draws of one WE mode of ``n`` samples, in their order: bc_left
    and bc_right [n] (0 Dirichlet, 1 Neumann; WE3 draws two rows of bc_left
    and keeps the second, bc_right stays Dirichlet, the reference's
    quirk), then the pulses' centres [n] ~ U(-4, 4)."""
    if boundary == "dirichlet":
        bc_l = np.zeros(n, dtype=int)
    elif boundary == "neumann":
        bc_l = np.ones(n, dtype=int)
    elif boundary == "mixed":
        bc_l = rng.integers(0, 2, size=(2, n))[1]
    else:
        raise ValueError(boundary)
    bc_r = np.zeros(n, dtype=int) if boundary == "mixed" else bc_l
    starts = rng.uniform(-4.0, 4.0, size=n)
    return bc_l, bc_r, starts


def we_initial_state(x: np.ndarray, starts: np.ndarray, c: float):
    """The initial states [B, 2 nx] of Gaussian pulses at ``starts``
    travelling right: u = exp(-(x - s)^2), u_t = -2 c (x - s) u."""
    u = np.exp(-((x[None, :] - starts[:, None]) ** 2))
    v = -2.0 * c * (x[None, :] - starts[:, None]) * u
    return np.concatenate([u, v], axis=1)


def _we_radau_solve(pde, x, u0_state, t_eval, c, tol=1e-3):
    """scipy Radau on the Chebyshev right-hand side at the reference's
    tolerances: [nt, 2 nx]."""
    from scipy.integrate import solve_ivp

    sol = solve_ivp(pde.chebdx, [t_eval[0], t_eval[-1]], u0_state,
                    method="Radau", t_eval=t_eval, args=(x, c), rtol=tol,
                    atol=tol)
    return sol.y.T


def we_solve(pde, states: np.ndarray, c: float, dtype: torch.dtype, device,
             solver: str = "expm") -> np.ndarray:
    """The trajectories [B, nt, nx] of the initial states [B, 2 nx] under
    ``pde``'s boundary pair, in time order: nt - 1 products with the exact
    propagator on ``device``, or scipy's Radau on the host (threads across
    samples)."""
    from msmp_pde_torch.equations.we import we_rollout

    if solver == "radau":
        from concurrent.futures import ThreadPoolExecutor

        t_eval = np.linspace(pde.tmin, pde.tmax, pde.nt)
        one = lambda s: _we_radau_solve(pde, pde.x, s, t_eval, c)[:, :pde.nx]
        with ThreadPoolExecutor(max_workers=8) as ex:
            return np.stack(list(ex.map(one, states)))
    P = torch.as_tensor(pde.propagator(c=c), dtype=dtype, device=device)
    traj = we_rollout(P, torch.as_tensor(states, dtype=dtype, device=device),
                      pde.nt - 1)  # [nt, B, 2 nx]
    return traj[..., :pde.nx].transpose(0, 1).cpu().numpy()


def generate_we(args, boundary: str, tend: float, wave_speed: float):
    """Writes the WE dataset; returns {(mode, resolution key): seconds}."""
    from msmp_pde_torch.datagen.hdf5_io import DatasetWriter
    from msmp_pde_torch.device import resolve_device
    from msmp_pde_torch.equations.we import BC_NAMES

    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    pdes = we_pdes(tend)
    c = float(wave_speed)
    res_meta = {
        k: dict(nt=p.nt, nx=p.nx, dt=p.dt, dx=p.dx, tmin=p.tmin,
                tmax=p.tmax, x=p.x)
        for k, p in pdes.items()
    }
    rng = np.random.default_rng(args.seed)
    seconds = {}
    os.makedirs(args.data_dir, exist_ok=True)
    with DatasetWriter(os.path.join(args.data_dir,
                                    f"WE_{args.experiment}")) as out:
        for mode, n in _counts(args).items():
            w = out.mode(mode, n, res_meta, ("bc_left", "bc_right", "c"),
                         scalar_dtypes={"bc_left": int, "bc_right": int})
            print(f"Mode: {mode}  samples: {n}")
            bc_l, bc_r, starts = draw_we_mode(rng, n, boundary)
            for k, pde in pdes.items():
                t1 = time.perf_counter()
                traj = np.empty((n, pde.nt, pde.nx))
                for bl in np.unique(bc_l):
                    for br in np.unique(bc_r):
                        sel = np.where((bc_l == bl) & (bc_r == br))[0]
                        if len(sel) == 0:
                            continue
                        pde.bc_left, pde.bc_right = BC_NAMES[bl], BC_NAMES[br]
                        states = we_initial_state(pde.x, starts[sel], c)
                        # stored time-reversed, as the reference stores it
                        traj[sel] = we_solve(pde, states, c, dtype, dev,
                                             args.we_solver)[:, ::-1]
                took = time.perf_counter() - t1
                seconds[(mode, k)] = took
                print(f"{k}: {took:.4f}s")
                w.write(k, 0, traj)
            w.write_scalar("bc_left", 0, bc_l)
            w.write_scalar("bc_right", 0, bc_r)
            w.write_scalar("c", 0, np.full(n, c))
            print(f"Solved {n} / {n}")
            sys.stdout.flush()
    _saved(out)
    return seconds


def main(args):
    """Generate ``args.experiment``'s dataset; in a torchrun group (see
    the module's docstring) rank 0 prints and writes."""
    from msmp_pde_torch.device import resolve_device

    if args.experiment not in {**CE_EXPERIMENTS, **AD_EXPERIMENTS,
                               **KF_EXPERIMENTS, **KS_EXPERIMENTS,
                               **WE_EXPERIMENTS}:
        raise ValueError(f"unknown experiment {args.experiment!r}")
    mesh.init_distributed(args.device)
    mesh.wait_for_backend(args.device)
    args.device = str(mesh.local_device(resolve_device(args.device)))
    if mesh.rank() != 0 and args.experiment in {**AD_EXPERIMENTS,
                                                **WE_EXPERIMENTS}:
        return {}  # AD and WE are not sharded: rank 0 makes them
    with mesh.rank0_stdout():
        return _generate(args)


def _generate(args):
    e = args.experiment
    if e in AD_EXPERIMENTS:
        return generate_rp(args, *AD_EXPERIMENTS[e],
                           unstructured_grid=e == "RPU")
    if e in KF_EXPERIMENTS:
        return generate_kf(args, *KF_EXPERIMENTS[e])
    if e in KS_EXPERIMENTS:
        return generate_ks(args, *KS_EXPERIMENTS[e])
    if e in WE_EXPERIMENTS:
        return generate_we(args, WE_EXPERIMENTS[e], WE_TEND, args.wave_speed)
    return generate_ce(args, *CE_EXPERIMENTS[e])


def build_parser():
    p = argparse.ArgumentParser(description="Generate PDE training data")
    p.add_argument("--experiment", type=str, default="")
    p.add_argument("--train_samples", type=int, default=2**5)
    p.add_argument("--valid_samples", type=int, default=2**5)
    p.add_argument("--test_samples", type=int, default=2**5)
    p.add_argument("--batch_size", type=int, default=4,
                   help="coefficient-group size (distribution parity)")
    p.add_argument("--chunk", type=int, default=128,
                   help="samples integrated together (they share the "
                        "adaptive solver's steps)")
    p.add_argument("--wave_speed", type=float, default=2.0)
    p.add_argument("--we_solver", type=str, default="expm",
                   choices=["expm", "radau"],
                   help="wave equation: the exact propagator on the device "
                        "(default) or scipy's Radau on the host")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without it) or cpu")
    p.add_argument("--dtype", type=str, default="float64",
                   choices=sorted(DTYPES))
    p.add_argument("--data_dir", type=str, default="data",
                   help="output directory")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
