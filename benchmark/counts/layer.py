"""The products of one message-passing layer on one graph, counted from
its shapes (a frozen copy of chip_smoke.py ``layer_ops``, with
every product at one rate: the caller divides by the product peak).

nx nodes, width H, window D, V variables, E valid edges (an edge that
the graph masks does no work and is not counted). Only matrix products are
counted, two FLOPs a multiply-add; the gathers, the mean over the edges,
the activations and the InstanceNorm are not.
"""
from __future__ import annotations


def forward(nx, H, D, V, E):
    """The node sides h w_hi + u w_du + px w_dx + v w_v and h w_hj, the
    message's second Dense over the valid edges, the update's two Denses
    (the first on [h, mean, v])."""
    return (2 * nx * (H + D + 1 + V) * H + 2 * nx * H * H
            + 2 * E * H * H + 2 * nx * (2 * H + V) * H + 2 * nx * H * H)


def backward(nx, H, D, V, E):
    """dW4 and da3; dW3; d[h, mean] from dz3; dW2 and dm1 over the valid
    edges; dh from ds_i and ds_j; dW_hi and dW_hj; dW_du, dW_dx, dW_v."""
    return (2 * nx * H * H * 2 + 2 * nx * (2 * H + V) * H
            + 2 * nx * H * 2 * H + 2 * 2 * E * H * H
            + 2 * nx * 2 * H * H + 2 * nx * H * 2 * H
            + 2 * nx * (D + 1 + V) * H)


def n_weights(H, D, V):
    """The floats of one layer's parameters."""
    return (2 * H * H + D * H + H + V * H + H + H * H + H
            + (2 * H + V) * H + H + H * H + H)


def io_bytes(shape, layers, outs, backward_pass=False):
    """Bytes a message-passing kernel must move, each input read once and
    each output written once: h, u, px, v, the graph's idx and mask, the
    weights of ``layers`` layers, ``outs`` output rows of width H; a
    backward also reads the cotangent and writes dh and every weight's
    gradient."""
    B, nx, H, D, V, K = (shape[k] for k in ("B", "nx", "H", "D", "V", "K"))
    w = layers * n_weights(H, D, V)
    n = 4 * (B * nx * (H + D + 1 + V) + w + 2 * nx * K)
    if backward_pass:
        return n + 4 * (2 * B * nx * H + w)
    return n + 4 * B * nx * H * outs
