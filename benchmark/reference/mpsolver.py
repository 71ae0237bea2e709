"""Plain PyTorch reference of the MP-PDE family's solvers: MP-PDE
(Brandstetter, Worrall, Welling, arXiv:2202.03376) and MSMP-PDE (Equer,
Rusch, Mishra, arXiv:2302.03580), written from the papers' equations.

It imports torch alone and nothing of the program. Every product goes
through ``Precision``, so the same code computes in float32 (the
reference) and with TF32 operands (the control that a lower precision has
to fail). Callers set ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False on the card, so that float32
means float32.

The graph is built here from the grid (an edge list, messages per edge,
summed into their target with ``index_add_``), not the program's padded
neighbour table. The message takes [h_i, h_j, u_i - u_j, x_i - x_j, v_i]
through one Dense whose matrix stacks the parameter blocks the program
keeps apart. The LEM (Rusch and Mishra, arXiv:2110.04744) steps its own
[x_t, y] and [x_t, z] products, where the program hoists the input halves.

Parameter names are those of the program's ``state_dict``, so that one set
of weights made by the benchmark loads into both sides.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def tf32(x):
    """x with TF32's 10 mantissa bits, rounded to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b on TF32 operands, its backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32(a), tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        ga = g @ b.transpose(-1, -2)
        gb = a.transpose(-1, -2) @ g
        if gb.dim() > b.dim():  # b was broadcast over a's leading axes
            gb = gb.reshape(-1, *b.shape).sum(0)
        return ga, gb


class Precision:
    """Products in ``float32``, or in ``tf32``: each operand rounded to
    TF32's 10 mantissa bits (to nearest even) and the products summed in
    float32, as the tensor cores compute TF32 (a convolution's backward
    keeps float32 products)."""

    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def mm(self, a, b):
        if self.mode == "float32":
            return a @ b
        return _TF32Product.apply(a, b)

    def conv1d(self, x, w, b, stride=1):
        if self.mode == "tf32":
            x = x + (tf32(x) - x).detach()
            w = w + (tf32(w) - w).detach()
        return F.conv1d(x, w, b, stride=stride)


def swish(x):
    return x * torch.sigmoid(x)


def decoder_shape(cfg):
    """(channels, kernel, stride) of the first conv and the second conv's
    kernel, which leaves exactly tw outputs of the hidden-length signal."""
    c1, k1, s1 = cfg["decoder_conv"]
    k2 = (cfg["hidden"] - k1) // s1 + 1 - cfg["tw"] + 1
    return c1, k1, s1, k2


def param_specs(cfg):
    """[(name, shape, fan_in)] of every parameter, in a fixed order. Each
    draws U(-1/sqrt(fan_in), 1/sqrt(fan_in)): a Dense by its inputs, the
    message Dense by its whole edge input, the LEM by its hidden width, a
    conv by its inputs times its kernel."""
    H, tw, V = cfg["hidden"], cfg["tw"], cfg["n_vars"]
    specs = []

    def dense(name, n_in, n_out):
        specs.extend([(f"{name}.kernel", (n_in, n_out), n_in),
                      (f"{name}.bias", (n_out,), n_in)])

    if cfg["encoder"] == "lem":
        I = 2 + V
        specs.extend([("embedding_lem.weights", (3 * H, I + H), H),
                      ("embedding_lem.weights_lin_z", (H, I + H), H),
                      ("embedding_lem.bias", (3 * H,), H),
                      ("embedding_lem.bias_lin_z", (H,), H)])
        dense("lemout_1", H, H)
        dense("lemout_2", H, H)
    elif cfg["encoder"] == "mlp":
        dense("embed_1", tw + 1 + V, H)
        dense("embed_2", H, H)
    else:
        raise ValueError(f"encoder {cfg['encoder']!r}")
    fan = 2 * H + tw + 1 + V
    names = ("gnn", "gate") if cfg["gate"] == "sigmoid" else ("gnn",)
    for i in range(cfg["layers"]):
        for n in names:
            p = f"{n}_{i}"
            specs.extend([
                (f"{p}.FactorizedEdgeDense_0.w_hi", (H, H), fan),
                (f"{p}.FactorizedEdgeDense_0.w_hj", (H, H), fan),
                (f"{p}.FactorizedEdgeDense_0.w_du", (tw, H), fan),
                (f"{p}.FactorizedEdgeDense_0.w_dx", (1, H), fan),
                (f"{p}.FactorizedEdgeDense_0.w_var", (V, H), fan),
                (f"{p}.FactorizedEdgeDense_0.bias", (H,), fan)])
            dense(f"{p}.TorchDense_0", H, H)
            dense(f"{p}.TorchDense_1", 2 * H + V, H)
            dense(f"{p}.TorchDense_2", H, H)
    c1, k1, _, k2 = decoder_shape(cfg)
    specs.extend([
        ("output_mlp.TorchConv1d_0.kernel", (c1, 1, k1), k1),
        ("output_mlp.TorchConv1d_0.bias", (c1,), k1),
        ("output_mlp.TorchConv1d_1.kernel", (1, c1, k2), c1 * k2),
        ("output_mlp.TorchConv1d_1.bias", (1,), c1 * k2)])
    return specs


def n_params(cfg) -> int:
    return sum(math.prod(s) for _, s, _ in param_specs(cfg))


def make_weights(cfg, generator: torch.Generator, device):
    """{name: float32 tensor on ``device``}: one uniform draw for all the
    parameters from ``generator`` (a generator of that device), each slice
    scaled by its bound."""
    specs = param_specs(cfg)
    flat = torch.empty(sum(math.prod(s) for _, s, _ in specs),
                       device=device, dtype=torch.float32)
    flat.uniform_(-1.0, 1.0, generator=generator)
    out, off = {}, 0
    for name, shape, fan_in in specs:
        n = math.prod(shape)
        out[name] = (flat[off:off + n] * fan_in ** -0.5).view(shape)
        off += n
    return out


class Graph:
    """The grid's static graph: node i receives a message from every j != i
    with |x_i - x_j| <= n dx (the radius graph of the uniform grid, not
    periodic); ``dst``, ``src`` [E] edge lists, ``deg`` [nx]."""

    def __init__(self, cfg, device):
        nx, n = cfg["nx"], cfg["neighbors"]
        self.x = torch.linspace(0.0, cfg["L"], nx, dtype=torch.float64)
        i = torch.arange(nx)
        off = torch.tensor([d for d in range(-n, n + 1) if d])
        j = i[:, None] + off[None, :]
        keep = (j >= 0) & (j < nx)
        self.dst = i[:, None].expand_as(j)[keep].to(device)
        self.src = j[keep].to(device)
        self.deg = torch.bincount(self.dst.cpu(), minlength=nx).to(
            device=device, dtype=torch.float32)
        self.x = self.x.to(device=device, dtype=torch.float32)
        self.nx = nx

    @property
    def n_edges(self) -> int:
        return int(self.dst.numel())


def dense(p, x, w, name):
    return p.mm(x, w[f"{name}.kernel"]) + w[f"{name}.bias"]


def instance_norm(o, eps=1e-5):
    """Per graph and feature over the nodes of [B, nx, H], biased
    variance."""
    mean = o.mean(dim=1, keepdim=True)
    var = ((o - mean) ** 2).mean(dim=1, keepdim=True)
    return (o - mean) / torch.sqrt(var + eps)


def mp_layer(p, w, name, h, u, px, v, graph, final_act, residual):
    """One message-passing layer on [B, nx, *]: the message
    swish(W2 swish(W1 [h_i, h_j, u_i - u_j, x_i - x_j, v_i] + b1) + b2)
    averaged over node i's incoming edges, the update
    W4 swish(W3 [h_i, mean, v_i] + b3) + b4 (swish'd with ``final_act``),
    the residual h + update with ``residual``, then InstanceNorm."""
    f = f"{name}.FactorizedEdgeDense_0"
    w_edge = torch.cat([w[f"{f}.w_hi"], w[f"{f}.w_hj"], w[f"{f}.w_du"],
                        w[f"{f}.w_dx"], w[f"{f}.w_var"]], dim=0)
    d, s = graph.dst, graph.src
    e = torch.cat([h[:, d], h[:, s], u[:, d] - u[:, s], px[:, d] - px[:, s],
                   v[:, d]], dim=-1)  # [B, E, 2H + tw + 1 + V]
    m = swish(p.mm(e, w_edge) + w[f"{f}.bias"])
    m = swish(dense(p, m, w, f"{name}.TorchDense_0"))
    agg = torch.zeros_like(h).index_add_(1, d, m) / graph.deg[None, :, None]
    z = swish(dense(p, torch.cat([h, agg, v], -1), w,
                    f"{name}.TorchDense_1"))
    o = dense(p, z, w, f"{name}.TorchDense_2")
    if final_act:
        o = swish(o)
    return instance_norm(h + o if residual else o)


def lem_encode(p, w, seq, H):
    """LEM over seq [T, N, I] from zero state: dt1 = sigmoid(W1 [x, y] +
    b1), dt2 = sigmoid(W2 [x, y] + b2), z <- (1 - dt1) z + dt1 tanh(Wz
    [x, y] + bz), y <- (1 - dt2) y + dt2 tanh(Wy [x, z] + by), dt = 1.
    Returns y_T [N, H]."""
    W, Wz = w["embedding_lem.weights"], w["embedding_lem.weights_lin_z"]
    b, bz = w["embedding_lem.bias"], w["embedding_lem.bias_lin_z"]
    y = seq.new_zeros(seq.shape[1], H)
    z = torch.zeros_like(y)
    for x in seq:
        g = p.mm(torch.cat([x, y], -1), W.T) + b
        dt1, dt2 = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:2 * H])
        z = (1.0 - dt1) * z + dt1 * torch.tanh(g[:, 2 * H:])
        y = (1.0 - dt2) * y + dt2 * torch.tanh(
            p.mm(torch.cat([x, z], -1), Wz.T) + bz)
    return y


def forward(cfg, w, graph, window, t, p: Precision):
    """One window: window [B, nx, tw] (u at the tw steps before the label
    window), t [B] the label window's start time -> the next tw steps
    [B, nx, tw]."""
    B, nx, tw = window.shape
    H = cfg["hidden"]
    px = (graph.x / cfg["L"]).expand(B, nx)[..., None]
    v = (t / cfg["tmax"])[:, None, None].expand(B, nx, 1)
    if cfg["encoder"] == "lem":
        seq = torch.cat([px[None].expand(tw, B, nx, 1),
                         window.permute(2, 0, 1)[..., None],
                         v[None].expand(tw, B, nx, 1)], -1)
        h = lem_encode(p, w, seq.reshape(tw, B * nx, 3), H)
        h = swish(dense(p, h.reshape(B, nx, H), w, "lemout_1"))
        h = swish(dense(p, h, w, "lemout_2"))
    else:
        h = swish(dense(p, torch.cat([window, px, v], -1), w, "embed_1"))
        h = swish(dense(p, h, w, "embed_2"))
    args = (window, px, v, graph)
    for i in range(cfg["layers"]):
        if cfg["gate"] == "sigmoid":
            gate = torch.sigmoid(mp_layer(p, w, f"gate_{i}", h, *args,
                                          False, False))
            main = mp_layer(p, w, f"gnn_{i}", h, *args, False, False)
            h = (1.0 - gate) * h + gate * swish(main)
        else:
            h = mp_layer(p, w, f"gnn_{i}", h, *args, True, True)
    _, _, s1, _ = decoder_shape(cfg)
    c = h.reshape(B * nx, 1, H)
    c = swish(p.conv1d(c, w["output_mlp.TorchConv1d_0.kernel"],
                       w["output_mlp.TorchConv1d_0.bias"], s1))
    diff = p.conv1d(c, w["output_mlp.TorchConv1d_1.kernel"],
                    w["output_mlp.TorchConv1d_1.bias"]).reshape(B, nx, tw)
    dt = cfg["tmax"] / (cfg["nt"] - 1)
    ramp = dt * torch.arange(1, tw + 1, device=window.device,
                             dtype=window.dtype)
    return window[..., -1:] + ramp * diff


def time_grid(cfg, device):
    return torch.linspace(0.0, cfg["tmax"], cfg["nt"], device=device)
