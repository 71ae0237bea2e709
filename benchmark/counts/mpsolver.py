"""Products of one forward of an MPSolver configuration (the LEM or the
MLP encoder, six gated pairs or single layers, the conv decoder) on B
graphs, counted from the shapes of the configuration file, for the
whole-step and whole-request shares of the peak (``mfu.*``)."""
from __future__ import annotations

from benchmark.counts import layer


def valid_edges(nx, neighbors):
    """The radius graph of a uniform grid, not periodic: node i takes every
    j != i within ``neighbors`` places, so the two ends lose some."""
    return 2 * sum(nx - d for d in range(1, neighbors + 1))


def call_shape(cfg, batch):
    """The shape of one call of the configuration's kernels on ``batch``
    graphs, as counts/<kernel>.py reads it."""
    nx = cfg["nx"]
    return {"B": batch, "nx": nx, "H": cfg["hidden"], "D": cfg["tw"],
            "V": cfg["n_vars"], "K": 2 * cfg["neighbors"],
            "E": valid_edges(nx, cfg["neighbors"]), "T": cfg["tw"],
            "N": batch * nx}


def forward_flops(cfg, B):
    nx, H, tw, V = cfg["nx"], cfg["hidden"], cfg["tw"], cfg["n_vars"]
    N = B * nx
    E = valid_edges(nx, cfg["neighbors"])
    if cfg["encoder"] == "lem":
        I = 2 + V
        enc = (2 * tw * N * I * 4 * H               # the input halves
               + tw * N * (2 * H * 3 * H + 2 * H * H)  # the recurrence
               + 2 * 2 * N * H * H)                  # lemout_1, lemout_2
    else:
        enc = 2 * N * (tw + 1 + V) * H + 2 * N * H * H
    per_layer = 2 if cfg["gate"] == "sigmoid" else 1
    mp = cfg["layers"] * per_layer * B * layer.forward(nx, H, tw, V, E)
    c1, k1, s1 = cfg["decoder_conv"]
    L1 = (H - k1) // s1 + 1
    k2 = L1 - tw + 1
    dec = 2 * N * c1 * k1 * L1 + 2 * N * c1 * k2 * tw
    return enc + mp + dec
