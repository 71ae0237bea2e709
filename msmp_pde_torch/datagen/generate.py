"""Dataset generation CLI (counterpart of msmp_pde_tpu/datagen/generate.py,
the combined-equation family and the linear advection system):

    python -m msmp_pde_torch.datagen.generate --experiment=E1 \
        --train_samples=2048 --valid_samples=128 --test_samples=128

writes ``{data_dir}/{family}_{experiment}.npz``, and ``.h5`` where
``h5py`` imports (datagen/hdf5_io.py), with all four resolutions of
``RES_CE`` (``RES_AD`` is the same list).

TaskIDs: E1, E2, E3 and kdv (family CE), which differ only in their
coefficient ranges; RP, MSWG and MSWG3 (family AD, ``AD_EXPERIMENTS``),
the two-component advection system solved exactly by characteristics
(equations/ad.py), trajectories [n, 2, nt, nx] with the speeds a and b.
RPU (the LCG grid) is not ported. A CE chunk of ``--chunk`` samples
integrates at once (the adaptive
solver's error max is shared across the chunk, so the chunk size is part
of what defines the data). Coefficients are drawn once per
``--batch_size`` group. The random draws come from one
``numpy.random.Generator(seed)`` on the host, per chunk in the order
alpha, beta, gamma groups (a coefficient whose range is one value draws
nothing), then the sum-of-sines parameters (datagen/ics.py): one seed
gives the same data on the card and on the CPU, but not the JAX
package's numbers, which come from threefry keys. An AD chunk draws a
groups, then b groups, then its initial condition's parameters
(``draw_ad_chunk``).

The sum of sines is both the initial condition, u0 = force(0), and a
forcing term added to the right-hand side at every stage time.

Precision: float64 by default, ``--dtype float32`` for speed.
``--device`` is cuda by default and raises without it.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

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
    "MSWG": (3.0, (0.1, 1.0), (1.0, 10.0), "gaussian"),
    "MSWG3": (1.0, (0.1, 0.5), (8.0, 10.0), "gaussian_triple"),
}
NOT_PORTED = ("WE1", "WE2", "WE3", "KF", "KS")
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _chunks(total: int, chunk: int):
    start = 0
    while start < total:
        yield start, min(chunk, total - start)
        start += min(chunk, total - start)


def _group_draw(rng: np.random.Generator, n_groups: int, lo,
                hi) -> np.ndarray:
    """One coefficient per group, U(lo, hi); fixed (and no draw) when
    lo == hi."""
    if np.isclose(lo, hi):
        return np.full((n_groups,), float(lo))
    return lo + rng.uniform(size=n_groups) * (hi - lo)


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
    """solve(alpha, beta, gamma, A, omega, phi, l) -> [B, nt, 1, nx]: the
    trajectories of one chunk on ``pde``'s grid, every argument a
    [B, 1, 1] or [B, 1, N] tensor on ``device``."""
    from msmp_pde_torch.datagen import ics
    from msmp_pde_torch.temporal import DOPRI45, solve_adaptive

    x = torch.as_tensor(np.linspace(0.0, pde.L, pde.nx), dtype=dtype,
                        device=device)
    ts = np.linspace(pde.tmin, pde.tmax, pde.nt)

    def solve(alpha, beta, gamma, A, omega, phi, l):
        sines = ics.sum_of_sines(A, omega, phi, l, pde.L)

        def force(t):
            return sines(x, t)[:, None, :]

        rhs = pde.make_rhs(alpha, beta, gamma, force)
        return solve_adaptive(rhs, force(0.0), ts, DOPRI45)

    return solve


def generate_ce(args, tmax: float, alpha, beta, gamma):
    """Writes the dataset; returns {(mode, resolution key): seconds}."""
    from msmp_pde_torch.datagen.hdf5_io import DatasetWriter
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
    counts = {"train": args.train_samples, "valid": args.valid_samples,
              "test": args.test_samples}
    seconds = {}
    os.makedirs(args.data_dir, exist_ok=True)
    stem = os.path.join(args.data_dir, f"CE_{args.experiment}")
    with DatasetWriter(stem) as out:
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
                    traj = solvers[k](*on_dev).reshape(c, pde.nt, pde.nx)
                    traj = traj.cpu().numpy()
                    took = time.perf_counter() - t1
                    seconds[(mode, k)] = seconds.get((mode, k), 0.0) + took
                    print(f"{k}: {took:.4f}s")
                    w.write(k, start, traj)
                # beta is stored as drawn; the training pipeline negates it
                for name, vals in zip(("alpha", "beta", "gamma"), draws):
                    w.write_scalar(name, start, vals)
                print(f"Solved {start + c} / {n}")
                sys.stdout.flush()
    print(f"Data saved to {out.npz_path}"
          + (f" and {out.h5_path}" if out.h5_path else ""))
    return seconds


def ad_pdes(tmax: float, initial_condition: str):
    """{resolution key: AD} of RES_AD: L = 2 pi for the gaussian families,
    16 for the sum of sines."""
    from msmp_pde_torch.equations import AD

    L = 16.0 if initial_condition == "sinesum" else 2 * np.pi
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
    else:
        params = sample(rng, c)
    return (a, b, *params)


def ad_solver(pde, initial_condition: str, dtype: torch.dtype, device):
    """solve(a, b, *ic parameters) -> [B, 2, nt, nx]: the exact
    trajectories of one chunk on ``pde``'s grid, every argument a tensor on
    ``device``."""
    from msmp_pde_torch.datagen import ics
    from msmp_pde_torch.equations.ad import exact_solution_batch

    x = torch.as_tensor(np.linspace(0.0, pde.L, pde.nx), dtype=dtype,
                        device=device)
    ts = torch.as_tensor(np.linspace(pde.tmin, pde.tmax, pde.nt),
                         dtype=dtype, device=device)
    build = ics.AD_ICS[initial_condition][1]

    def solve(a, b, *params):
        return exact_solution_batch(build(*params, pde.L), x, ts, a, b)

    return solve


def generate_rp(args, tmax: float, a_range, b_range, initial_condition):
    """Writes the AD dataset; returns {(mode, resolution key): seconds}."""
    from msmp_pde_torch.datagen.hdf5_io import DatasetWriter
    from msmp_pde_torch.device import resolve_device

    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    pdes = ad_pdes(tmax, initial_condition)
    solvers = {k: ad_solver(p, initial_condition, dtype, dev)
               for k, p in pdes.items()}
    res_meta = {
        k: dict(nt=p.nt, nx=p.nx, dt=p.dt, dx=p.dx, tmin=p.tmin,
                tmax=p.tmax, x=np.linspace(0.0, p.L, p.nx))
        for k, p in pdes.items()
    }
    pde0 = next(iter(pdes.values()))
    rng = np.random.default_rng(args.seed)
    counts = {"train": args.train_samples, "valid": args.valid_samples,
              "test": args.test_samples}
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
    print(f"Data saved to {out.npz_path}"
          + (f" and {out.h5_path}" if out.h5_path else ""))
    return seconds


def main(args):
    e = args.experiment
    if e in NOT_PORTED:
        raise NotImplementedError(
            f"experiment {e!r} is not ported yet (ROADMAP.md Queue 1 item "
            "15, the other datagen families)")
    if e == "RPU":
        raise NotImplementedError(
            "RPU (the LCG grid, its k-NN graph) is not ported yet "
            "(ROADMAP.md Queue 1 item 7)")
    if e in AD_EXPERIMENTS:
        return generate_rp(args, *AD_EXPERIMENTS[e])
    if e not in CE_EXPERIMENTS:
        raise ValueError(f"unknown experiment {e!r}")
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
