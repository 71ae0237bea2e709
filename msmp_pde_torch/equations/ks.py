"""Kuramoto-Sivashinsky equation, Fourier-spectral ETDRK4 (counterpart of
msmp_pde_tpu/equations/ks.py, its ``method='fft'`` path):

    u_t + u u_x + u_xx + u_xxxx = 0,   periodic on x in [0, 2 pi L]

The Kassam-Trefethen scheme: the linear term exact in Fourier space, the
ETDRK4 coefficients from complex contour means over M = 62 roots of unity
(``etdrk4_setup``, a numpy copy, float64 on the host), the nonlinear term
g = -0.5 i k applied to fft(real(ifft(v))^2).

``KS.simulate`` integrates a batch of initial conditions with torch.fft in
complex128 (complex64 at float32) and keeps only the requested fine steps.
Every row is independent of its batchmates and the step is fixed, so on
the card the fine steps run as replays of CUDA graphs, each a captured
chain of 2^j steps (j = 0 .. 9), a segment between two save points being
their binary decomposition; on the CPU they run as an eager loop of the
same step. ``simulate_many`` runs several batches (datagen's resolutions)
on a stream each, so that their launches overlap on the card. A replay runs the captured kernels on the same values, so it
agrees with the eager loop on the card to the bit (``chip_smoke.py``
phase 25 holds that). The step folds g into the ETDRK4 coefficients,
which changes the rounding against the JAX package's program and nothing
else.

A trajectory that blows up (NaN or Inf) is flagged in the ``valid`` mask.
``energy_spectrum``, ``space_filter`` and ``space_filter_int`` are the
reference's diagnostics (the eval CLI's ``--ks_spectrum``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

# the longest chain of fine steps a CUDA graph holds is 2^GRAPH_LOG2
GRAPH_LOG2 = 9


@dataclasses.dataclass
class KSCoeffs:
    """Precomputed ETDRK4 scalar fields (all shape [nx])."""

    k: np.ndarray
    E: np.ndarray
    E2: np.ndarray
    Q: np.ndarray
    f1: np.ndarray
    f2: np.ndarray
    f3: np.ndarray
    g: np.ndarray  # complex


def etdrk4_setup(L: float, nx: int, dt: float, M: int = 62) -> KSCoeffs:
    """Kassam-Trefethen coefficient setup (reference PDEs.py:615-641)."""
    k = np.concatenate(
        [np.arange(0, nx / 2), [0.0], np.arange(-nx / 2 + 1, 0)]
    ) / L
    lin = k**2 - k**4
    E = np.exp(dt * lin)
    E2 = np.exp(dt * lin / 2.0)
    r = np.exp(1j * np.pi * (np.arange(1, M + 1) - 0.5) / M)
    LR = dt * lin[:, None] + r[None, :]
    Q = dt * np.real(np.mean((np.exp(LR / 2.0) - 1.0) / LR, 1))
    f1 = dt * np.real(
        np.mean((-4.0 - LR + np.exp(LR) * (4.0 - 3.0 * LR + LR**2)) / LR**3, 1)
    )
    f2 = dt * np.real(
        np.mean((2.0 + LR + np.exp(LR) * (-2.0 + LR)) / LR**3, 1))
    f3 = dt * np.real(
        np.mean((-4.0 - 3.0 * LR - LR**2 + np.exp(LR) * (4.0 - LR)) / LR**3, 1)
    )
    g = -0.5j * k
    return KSCoeffs(k=k, E=E, E2=E2, Q=Q, f1=f1, f2=f2, f3=f3, g=g)


def _etdrk4_step(c):
    """step(v) -> v one fine step later, v [B, nx] complex; ``c`` the
    coefficients as complex tensors on v's device, g folded into those
    that multiply a nonlinear term."""
    E, E2, Qg, Qg2, F1, F2, F3 = c

    def w(v):  # the nonlinear term without g: fft(real(ifft(v))^2)
        return torch.fft.fft(torch.square(torch.fft.ifft(v).real))

    def step(v):
        Nv = w(v)
        E2v = E2 * v
        a = torch.addcmul(E2v, Qg, Nv)
        Na = w(a)
        b = torch.addcmul(E2v, Qg, Na)
        Nb = w(b)
        cc = torch.addcmul(E2 * a, Qg2, torch.add(Nb, Nv, alpha=-0.5))
        Nc = w(cc)
        out = torch.addcmul(E * v, F1, Nv)
        out = torch.addcmul(out, F2, Na + Nb)
        return torch.addcmul(out, F3, Nc)

    return step


class _GraphedSteps:
    """Chains of 2^j fine steps (j = 0 .. GRAPH_LOG2) captured as CUDA
    graphs on one static state; ``advance(n)`` replays n steps."""

    def __init__(self, step, v0: torch.Tensor):
        self.state = v0.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # cuFFT's plans exist before capture
            step(self.state)
        torch.cuda.current_stream().wait_stream(side)
        self.graphs = []
        for j in range(GRAPH_LOG2 + 1):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                v = self.state
                for _ in range(1 << j):
                    v = step(v)
                self.state.copy_(v)
            self.graphs.append(graph)

    def advance(self, n: int):
        top = self.graphs[-1]
        for _ in range(n >> GRAPH_LOG2):
            top.replay()
        for j in range(GRAPH_LOG2):
            if n >> j & 1:
                self.graphs[j].replay()
        return self.state


class _Simulation:
    """One batch's integration (``KS.simulate``), a segment between two
    save points at a time."""

    def __init__(self, ks, u0: torch.Tensor, save_steps, coeffs, graphs):
        c = coeffs or etdrk4_setup(ks.L, ks.nx, ks.dt)
        cdtype = (torch.complex128 if u0.dtype == torch.float64
                  else torch.complex64)
        dev = u0.device
        as_c = lambda a: torch.as_tensor(np.asarray(a, np.complex128),
                                         device=dev).to(cdtype)
        self.step = _etdrk4_step((as_c(c.E), as_c(c.E2), as_c(c.Q * c.g),
                                  as_c(2.0 * c.Q * c.g), as_c(c.f1 * c.g),
                                  as_c(2.0 * c.f2 * c.g),
                                  as_c(c.f3 * c.g)))
        save_steps = np.asarray(save_steps)
        if not (np.diff(save_steps) > 0).all():
            raise ValueError("save_steps must increase")
        self.seg_lens = np.diff(np.concatenate([[0], save_steps])).tolist()
        self.v = torch.fft.fft(u0).to(cdtype)
        self.graphed = (_GraphedSteps(self.step, self.v)
                        if graphs is None and dev.type == "cuda" or graphs
                        else None)
        self.out = u0.new_empty((u0.shape[0], len(save_steps), ks.nx))

    def run_segment(self, i: int):
        n = self.seg_lens[i]
        if self.graphed is not None:
            self.v = self.graphed.advance(n)
        else:
            for _ in range(n):
                self.v = self.step(self.v)
        self.out[:, i] = torch.fft.ifft(self.v).real

    def result(self):
        return self.out, torch.isfinite(self.out).all(dim=2).all(dim=1)


def simulate_many(jobs, coeffs: Optional[KSCoeffs] = None,
                  graphs: Optional[bool] = None):
    """``KS.simulate`` of several (ks, u0, save_steps) jobs: [(u_saved,
    valid)] in order. On the card each job runs on a stream of its own,
    their segments enqueued in turn, so the resolutions' small launches
    overlap; a job's values do not depend on the others'."""
    sims, streams = [], []
    for ks, u0, save_steps in jobs:
        stream = None
        if u0.device.type == "cuda":
            stream = torch.cuda.Stream(u0.device)
            stream.wait_stream(torch.cuda.current_stream(u0.device))
            u0.record_stream(stream)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            sims.append(_Simulation(ks, u0, save_steps, coeffs, graphs))
        streams.append(stream)
    for i in range(max(len(sim.seg_lens) for sim in sims)):
        for sim, stream in zip(sims, streams):
            if i < len(sim.seg_lens):
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    sim.run_segment(i)
    results = []
    for sim, stream in zip(sims, streams):
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            out, valid = sim.result()
        if stream is not None:
            here = torch.cuda.current_stream(out.device)
            here.wait_stream(stream)
            out.record_stream(here)
            valid.record_stream(here)
        results.append((out, valid))
    return results


@dataclasses.dataclass
class KS:
    """The KS problem (grid and solver parameters): domain [0, 2 pi L], nx
    modes, fine step dt, horizon [tstart, tend], output step
    dt_downsampled."""

    L: float = 16.0
    nx: int = 128
    dt: float = 0.25
    tend: float = 150.0
    tstart: float = 0.0
    dt_downsampled: float = 250.0

    lmin: int = 1
    lmax: int = 3
    n_waves: int = 5

    # fields a trajectory carries at each point
    n_components: ClassVar[int] = 1

    def __post_init__(self):
        self.tmin = self.tstart
        self.tmax = self.tend
        horizon = self.tend - self.tstart
        self.nsteps = int(horizon / self.dt)
        self.nsteps_downsampled = int(horizon / self.dt_downsampled)
        self.dx = 2 * np.pi * self.L / self.nx

    def __repr__(self):
        return "KS"

    @property
    def x(self) -> np.ndarray:
        return 2 * np.pi * self.L * np.arange(self.nx) / self.nx

    def testing_ic(self) -> np.ndarray:
        """Kassam-Trefethen test initial condition."""
        x = self.x
        return np.cos(x / self.L) * (1.0 + np.sin(x / self.L))

    def save_steps(self) -> np.ndarray:
        """The fine steps datagen keeps: nsteps_downsampled points from the
        end of the transient, int(2 / dt) + 1 steps, to nsteps, rounded
        onto the fine grid."""
        transient = int(2.0 / self.dt) + 1
        idx = np.round(np.linspace(0, self.nsteps - transient,
                                   self.nsteps_downsampled)).astype(int)
        return transient + idx

    def simulate(self, u0: torch.Tensor, save_steps,
                 coeffs: Optional[KSCoeffs] = None,
                 graphs: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Integrate a batch of initial conditions, keeping the requested
        fine steps.

        Args:
            u0: [B, nx] real initial conditions (float64 or float32).
            save_steps: increasing fine-step indices to keep (0 is the
                initial condition itself).
            coeffs: precomputed ETDRK4 coefficients (``etdrk4_setup``).
            graphs: replay CUDA graphs of the fine steps; default on for a
                CUDA tensor. The CPU runs an eager loop.
        Returns:
            (u_saved [B, len(save_steps), nx] real, valid [B] bool, False
            where the trajectory blew up).
        """
        return simulate_many([(self, u0, save_steps)], coeffs, graphs)[0]

    # ---------------------------------------------------- diagnostics
    def energy_spectrum(self, u: torch.Tensor):
        """Kinetic-energy diagnostics of u [..., T, nx] (reference
        PDEs.py:773-804): Ek_kt, the energy per wavenumber and time 0.5
        |v|^2 / nx * dx; Ek_k, its time average; Ek_t, the total energy
        over time; Ek_tt, the running time average of Ek_t."""
        v = torch.fft.fft(u)
        Ek_kt = 0.5 * torch.real(torch.conj(v) * v / self.nx) * self.dx
        T = u.shape[-2]
        counts = torch.arange(1, T + 1, dtype=u.dtype, device=u.device)
        Ek_k = torch.sum(Ek_kt, dim=-2) / T
        Ek_t = torch.sum(Ek_kt, dim=-1)
        Ek_tt = torch.cumsum(Ek_t, dim=-1) / counts
        return {"Ek_kt": Ek_kt, "Ek_k": Ek_k, "Ek_t": Ek_t, "Ek_tt": Ek_tt}

    def _k_grid(self) -> np.ndarray:
        """The reference's wavenumbers (PDEs.py:617): integers over L with
        the Nyquist mode labelled k = 0, so a |k| filter always keeps the
        Nyquist mode."""
        return np.concatenate([np.arange(0, self.nx / 2), [0.0],
                               np.arange(-self.nx / 2 + 1, 0)]) / self.L

    def space_filter(self, u: torch.Tensor, k_cut: float = 2.0):
        """Low-pass filter (reference PDEs.py:807-817): every wavenumber
        |k| >= k_cut zeroed; returns (u_filtered, u_residual)."""
        k = torch.as_tensor(self._k_grid(), device=u.device)
        v = torch.fft.fft(u)
        v_filt = torch.where(torch.abs(k) >= k_cut, torch.zeros_like(v), v)
        u_filt = torch.real(torch.fft.ifft(v_filt))
        return u_filt, u - u_filt

    def space_filter_int(self, u: torch.Tensor, k_cut: float = 2.0,
                         N_int: int = 16):
        """Filter and spectral downsample (reference PDEs.py:818-836): the
        modes |k| < k_cut (the Nyquist mode among them, ``_k_grid``), in
        fft order, scaled by N_int / nx and inverse-transformed onto the
        coarse grid x_int = 2 pi L [0 .. N_int) / N_int. The reference
        writes the kept modes into a [.., N_int] buffer, so their count
        must equal N_int; anything else raises.

        u: [..., T, nx]. Returns (u_filt [..., T, nx], u_resid [..., T,
        nx], u_filt_int [..., T, N_int], x_int [N_int])."""
        keep = np.abs(self._k_grid()) < k_cut
        n_keep = int(keep.sum())
        if n_keep != N_int:
            raise ValueError(
                f"k_cut={k_cut} keeps {n_keep} modes on nx={self.nx}, "
                f"L={self.L}; N_int must equal the kept-mode count (the "
                "reference writes the selection into a [.., N_int] buffer, "
                "PDEs.py:825,831)")
        idx = torch.as_tensor(np.nonzero(keep)[0], device=u.device)
        v_int = torch.fft.fft(u)[..., idx] * (N_int / self.nx)
        u_filt_int = torch.real(torch.fft.ifft(v_int))
        u_filt, u_resid = self.space_filter(u, k_cut)
        x_int = 2.0 * np.pi * self.L * np.arange(N_int) / N_int
        return u_filt, u_resid, u_filt_int, x_int
