"""Message-passing PDE solvers of the MP-PDE family (counterpart of
msmp_pde_tpu/models/gnn.py): the nine 1-D graph models MP-PDE, Gated,
LEM, MSMP-PDE, MSSMP-PDE, MSGMP-PDE, SaveMSMP-PDE, LSTMGated and LSTM, and
their ten 2-D versions on the two-component advection system (MP-PDE2D,
Gated2D, MSMP-PDE2D, MSGMP-PDE2D, SaveMSMP-PDE2D, MSG2-PDE2D with the
gradient gate, LSTMGated2D, LEM2D, GLEMGated2D with graph-attention
layers, LSTM2D).

The graph is a dense per-node neighbour list ``idx``/``mask`` [nx, K]
(data/graph.py); message passing is a gather over the K axis and a masked
mean. Module and parameter names follow the flax tree, so a converted
checkpoint loads with ``load_state_dict`` (utils/convert.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from msmp_pde_torch.models.common import (
    Dense,
    GLUConv,
    WindowDecoder,
    swish,
    uniform_param,
)
from msmp_pde_torch.models.lem import LEM
from msmp_pde_torch.models.lstm import LSTM
from msmp_pde_torch.ops import mp_layer, mp_pair


class FactorizedEdgeDense(nn.Module):
    """The parameters of a Dense on [h_i, h_j, u_i - u_j, px_i - px_j,
    vars_i], kept factorized into i-side and j-side blocks; the math is in
    ``ops.mp_pair.layer_plain`` and the kernel."""

    def __init__(self, hidden: int, dtw: int, V: int,
                 generator: torch.Generator):
        super().__init__()
        fan_in = 2 * hidden + dtw + 1 + V
        p = lambda *shape: uniform_param(shape, fan_in, generator)
        self.w_hi = p(hidden, hidden)
        self.w_hj = p(hidden, hidden)
        self.w_du = p(dtw, hidden)
        self.w_dx = p(1, hidden)
        self.w_var = p(V, hidden)
        self.bias = p(hidden)


class GNNLayer(nn.Module):
    """One message-passing layer: GNN_Layer with ``final_act`` and
    ``residual`` (the ungated models), GNN_LayerLin with neither."""

    def __init__(self, hidden: int, dtw: int, V: int,
                 generator: torch.Generator, final_act: bool = False,
                 residual: bool = False):
        super().__init__()
        self.final_act, self.residual = final_act, residual
        self.FactorizedEdgeDense_0 = FactorizedEdgeDense(hidden, dtw, V,
                                                         generator)
        self.TorchDense_0 = Dense(hidden, hidden, generator)
        self.TorchDense_1 = Dense(2 * hidden + V, hidden, generator)
        self.TorchDense_2 = Dense(hidden, hidden, generator)

    def weights(self):
        f = self.FactorizedEdgeDense_0
        return (f.w_hi, f.w_hj, f.w_du, f.w_dx, f.w_var, f.bias,
                self.TorchDense_0.kernel, self.TorchDense_0.bias,
                self.TorchDense_1.kernel, self.TorchDense_1.bias,
                self.TorchDense_2.kernel, self.TorchDense_2.bias)

    def forward(self, h, u, px, variables, idx, mask,
                mp_precision="float32"):
        """h [B, nx, H], px [B, nx] -> [B, nx, H]; on CUDA tensors through
        the layer kernels (ops/mp_layer.py), their products in
        ``mp_precision``, which the model passes."""
        return mp_layer.fused_mp_layer(h, u, px[..., None], variables, idx,
                                       mask, self.weights(), self.final_act,
                                       self.residual, mp_precision)

    def plain(self, h, u, px, variables, idx, mask):
        """The layer's float32 math in torch ops, differentiated by
        autograd: the ``mp_remat`` route's."""
        return mp_layer.fused_mp_layer_plain(
            h, u, px[..., None], variables, idx, mask, self.weights(),
            self.final_act, self.residual)


class GATLayer(nn.Module):
    """Single-relation graph attention with edge features (flax
    ``GATLayer``, msmp_pde_tpu/models/gnn.py:138-183), in plain torch ops,
    as the JAX package leaves it to XLA:

      alpha_ij = softmax_j LeakyReLU_0.2(q.Wh_i + k.Wh_j + w_e.e_ij)
      h_i'     = sum_j alpha_ij (W h_j) + bias,

    e_ij = [u_i - u_j, px_i - px_j]; a masked softmax over the K slots
    (masked logits -1e30), and a node without a valid neighbour aggregates
    nothing (its output is the bias)."""

    def __init__(self, hidden: int, dtw: int, generator: torch.Generator):
        super().__init__()
        self.lin = Dense(hidden, hidden, generator)
        self.att_q = uniform_param((hidden,), hidden, generator)
        self.att_k = uniform_param((hidden,), hidden, generator)
        self.lin_edge = Dense(dtw + 1, 1, generator)
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, h, u, px, variables, idx, mask):
        """h [B, nx, H], u [B, nx, dtw], px [B, nx] -> [B, nx, H]."""
        idx = idx.long()
        wh = self.lin(h)
        wh_j = wh[:, idx]  # [B, nx, K, H]
        e = torch.cat([u[:, :, None, :] - u[:, idx],
                       px[:, :, None, None] - px[:, idx][..., None]], -1)
        logits = ((wh * self.att_q).sum(-1)[:, :, None]
                  + (wh_j * self.att_k).sum(-1)
                  + self.lin_edge(e)[..., 0])  # [B, nx, K]
        logits = F.leaky_relu(logits, 0.2)
        valid = mask[None] > 0
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
        alpha = torch.softmax(logits, dim=-1) * valid
        return torch.einsum("bnk,bnkh->bnh", alpha, wh_j) + self.bias


def grad_gate(g, idx, mask):
    """Gradient gate (msmp_pde_tpu/models/gnn.py:186-195): tau_i =
    tanh(mean_j |g_i - g_j|^2) over node i's valid neighbours, the mean's
    divisor max(deg, 1). g [B, nx, H] -> tau [B, nx, H]."""
    d2 = (g[:, :, None, :] - g[:, idx.long()]) ** 2
    deg = torch.clamp(mask.sum(-1), min=1.0)
    return torch.tanh((d2 * mask[None, :, :, None]).sum(2)
                      / deg[None, :, None])


class MPSolver(nn.Module):
    """Encode - process - decode. forward(window [B, nx, d tw], pos_x
    [B, nx], t [B], var_vec [B, V], idx, mask, lem_state=None) -> (out
    [B, nx, d tw], new LEM state or None); d = ``n_components``, the
    window component-major.

    The encoder is an MLP on [window, px, variables] (``mlp``), or the LEM
    or the LSTM over the window's steps (``lem``, ``lstm``; at d = 2 a
    step's input is [px, u1_k, u2_k, cumsum(dt)_k + t / tmax, the equation
    variables]); the processor is ``layers`` layers: GNN_Layers with final
    swish and residual (gate ``none``), sigmoid-gated pairs of
    GNN_LayerLins (``sigmoid``) or GNN_LayerLins whose gate is
    ``grad_gate`` of the gate layer's swish (``grad``), each layer a
    ``GATLayer`` instead with ``layer_type="gat"``; the decoder (after a
    Dense H -> 2H and swish split into two channels at d = 2,
    ``double_mlp``) is the two-conv CNN on the temporal residual (``cnn``),
    the two half-hidden GLU convs as scale and difference (``glu``), or the
    CNN's raw output (``diff_only``). With ``save_state`` the LEM starts
    from ``lem_state`` ((y, z), each [B, nx, H]; zeros when None) and
    returns its final state; with ``twin_scale`` two LEM + sigmoid
    ``diff_only`` towers (``diff_tower``, ``scale_tower``) give the
    difference and the scale of the composition (1 - s) u_last + cumsum(dt)
    (s d). CUDA tensors go through the kernels, CPU tensors through their
    plain PyTorch versions; with grad, the LEM scan, each layer and each
    gated pair go through their autograd Functions (ops/lem_scan.py,
    ops/mp_layer.py, ops/mp_pair.py). The sigmoid-gated message-passing
    pairs run the fused pair kernel, every other message-passing layer the
    single-layer kernel; the attention layers, the gradient gate and the
    LSTM are plain torch ops on every device.

    ``mp_precision`` (``float32``, ``bfloat16``, ``bfloat16s``) is the
    message-passing kernels' operand precision (ops/mp_layer.py); the
    attention layers ignore it, as the JAX package's do. ``mp_remat``
    (msmp_pde_tpu/models/gnn.py:333-336) runs each layer's float32 math in
    torch ops under ``torch.utils.checkpoint`` instead of the kernels, and
    the gated pairs as their two layers and the combine: the one route on
    which the layers run as torch ops on the card, recomputed in the
    backward. It takes float32 only."""

    def __init__(self, tw: int, *, n_vars: int, hidden: int = 128,
                 layers: int = 6, n_components: int = 1,
                 encoder: str = "lem", gate: str = "sigmoid",
                 decoder: str = "cnn", twin_scale: bool = False,
                 save_state: bool = False, layer_type: str = "mp",
                 L: float = 16.0, tmax: float = 4.0, dt: float = 4.0 / 249,
                 seed: int = 0, mp_precision: str = "float32",
                 mp_remat: bool = False):
        super().__init__()
        mp_layer.mode_of(mp_precision)
        if mp_remat and mp_precision != "float32":
            raise ValueError(
                "mp_remat runs the float32 layer math in torch ops; "
                f"mp_precision={mp_precision!r} needs the kernels")
        if (encoder not in ("mlp", "lem", "lstm")
                or gate not in ("none", "sigmoid", "grad")
                or decoder not in ("cnn", "glu", "diff_only")
                or layer_type not in ("mp", "gat")
                or n_components not in (1, 2)):
            raise ValueError(
                f"MPSolver(encoder={encoder!r}, gate={gate!r}, "
                f"decoder={decoder!r}, layer_type={layer_type!r}, "
                f"n_components={n_components})")
        self.tw, self.hidden, self.layers = tw, hidden, layers
        self.d = n_components
        self.encoder, self.gate, self.layer_type = encoder, gate, layer_type
        self.decoder, self.twin_scale = decoder, twin_scale
        self.save_state = save_state
        self.L, self.tmax, self.dt = L, tmax, dt
        self.mp_precision, self.mp_remat = mp_precision, mp_remat
        if twin_scale:
            # MSSMP (gnn.py:269-287): two full towers, no parameter of
            # its own
            for i, name in enumerate(("diff_tower", "scale_tower")):
                self.add_module(name, MPSolver(
                    tw, n_vars=n_vars, hidden=hidden, layers=layers,
                    n_components=n_components, encoder="lem",
                    gate="sigmoid", decoder="diff_only", L=L, tmax=tmax,
                    dt=dt, seed=seed + i, mp_precision=mp_precision,
                    mp_remat=mp_remat))
            return
        d, dtw = n_components, n_components * tw
        g = torch.Generator().manual_seed(seed)
        # a recurrent step's input: [px, u_k, vars] or, at d = 2,
        # [px, u1_k, u2_k, t_k, vars[1:]]
        step_in = 2 + n_vars if d == 1 else 3 + n_vars
        if encoder == "lem":
            self.embedding_lem = LEM(step_in, hidden, g)
        elif encoder == "lstm":
            self.lstm = LSTM(step_in, hidden, g)
        else:
            self.embed_1 = Dense(dtw + 1 + n_vars, hidden, g)
            self.embed_2 = Dense(hidden, hidden, g)
        if encoder != "mlp":
            self.lemout_1 = Dense(hidden, hidden, g)
            self.lemout_2 = Dense(hidden, hidden, g)
        plain = gate == "none"  # ungated stacks use GNN_Layer (gnn.py:341-348)
        for i in range(layers):
            for name in ("gnn", "gate") if gate != "none" else ("gnn",):
                if layer_type == "gat":
                    mod = GATLayer(hidden, dtw, g)
                else:
                    act = plain and name == "gnn"
                    mod = GNNLayer(hidden, dtw, n_vars, g, act, act)
                self.add_module(f"{name}_{i}", mod)
        if d == 2:
            self.double_mlp = Dense(hidden, 2 * hidden, g)
        if decoder == "glu":
            half = hidden // 2
            self.output_mlp_gate = GLUConv(tw, half, g, d, d)
            self.output_mlp_diff = GLUConv(tw, hidden - half, g, d, d)
        else:
            self.output_mlp = WindowDecoder(tw, hidden, g, d, d)

    def forward(self, window, pos_x, t, var_vec, idx, mask, lem_state=None):
        if self.twin_scale:
            diff, _ = self.diff_tower(window, pos_x, t, var_vec, idx, mask)
            scale, _ = self.scale_tower(window, pos_x, t, var_vec, idx, mask)
            return self._compose_scale_diff(window, scale, diff), None
        B, nx, _ = window.shape
        V = var_vec.shape[-1]
        px_n = pos_x / self.L
        variables = var_vec[:, None, :].expand(B, nx, V)
        h, new_state = self._encode(window, px_n, variables, lem_state)
        args = (window, px_n, variables, idx, mask)
        run = self._remat if self.mp_remat else self._apply_layer
        for i in range(self.layers):
            layer = getattr(self, f"gnn_{i}")
            if self.gate == "none":
                h = run(layer, h, *args)
            elif (self.gate == "sigmoid" and self.layer_type == "mp"
                  and not self.mp_remat):
                h = mp_pair.fused_gated_pair(
                    h, window, px_n[..., None], variables, idx, mask,
                    getattr(self, f"gate_{i}").weights(), layer.weights(),
                    self.mp_precision)
            else:
                h = self._gated(h, run(getattr(self, f"gate_{i}"), h, *args),
                                run(layer, h, *args), idx, mask)
        return self._decode(h, window), new_state

    @property
    def mp_precision(self) -> str:
        """The message-passing kernels' operand precision; the model's one
        setting of it, passed to each layer's call (and set on the twin
        towers with it). Setting an unknown mode raises, as does a bf16
        mode under ``mp_remat``."""
        return self._mp_precision

    @mp_precision.setter
    def mp_precision(self, mode: str):
        mp_layer.mode_of(mode)
        if getattr(self, "mp_remat", False) and mode != "float32":
            raise ValueError(f"mp_remat takes float32 only, not {mode!r}")
        self._mp_precision = mode
        for tower in self.children():
            if isinstance(tower, MPSolver):
                tower.mp_precision = mode

    def _apply_layer(self, layer, h, *args):
        """``layer`` at h; a message-passing layer in ``mp_precision``."""
        if isinstance(layer, GNNLayer):
            return layer(h, *args, mp_precision=self.mp_precision)
        return layer(h, *args)

    @staticmethod
    def _remat(layer, h, *args):
        """``layer`` at h under ``torch.utils.checkpoint`` (the
        ``mp_remat`` route): a message-passing layer's float32 torch ops
        (``GNNLayer.plain``), an attention layer itself, recomputed in the
        backward instead of kept."""
        f = layer.plain if isinstance(layer, GNNLayer) else layer
        if not torch.is_grad_enabled():
            return f(h, *args)
        return torch.utils.checkpoint.checkpoint(f, h, *args,
                                                 use_reentrant=False)

    def _gated(self, h, g, ln, idx, mask):
        """(1 - tau) h + tau swish(ln), tau = sigmoid(g) or the gradient
        gate of swish(g) (gnn.py:375-386)."""
        tau = (torch.sigmoid(g) if self.gate == "sigmoid"
               else grad_gate(swish(g), idx, mask))
        return (1.0 - tau) * h + tau * swish(ln)

    def _sequence(self, window, px_n, variables):
        """The recurrent encoders' per-step inputs [tw, B nx, I]:
        [px_n, u_k, variables] for each step k of the window (gnn.py:
        434-440), at d = 2 [px_n, u1_k, u2_k, cumsum(dt)_k + t / tmax,
        variables[1:]] (gnn.py:443-456): the window start's normalized
        time plus the absolute time of step k."""
        B, nx, _ = window.shape
        tw, V = self.tw, variables.shape[-1]
        u = window.reshape(B, nx, self.d, tw).permute(3, 0, 1, 2)
        cols = [px_n[None, ..., None].expand(tw, B, nx, 1), u]
        if self.d == 2:
            ts = self._dt_cum(window)[:, None, None, None] + variables[
                None, ..., 0:1]
            cols += [ts, variables[None, ..., 1:].expand(tw, B, nx, V - 1)]
        else:
            cols.append(variables[None].expand(tw, B, nx, V))
        return torch.cat(cols, dim=-1).reshape(tw, B * nx, -1)

    def _encode(self, window, px_n, variables, lem_state):
        """MLP on [window, px_n, variables] (gnn.py:427-431), or the LEM or
        the LSTM over ``_sequence``, then lemout_1, lemout_2. The LEM starts
        from ``lem_state`` where one is given (zeros otherwise) and returns
        its final state only with ``save_state`` (gnn.py:459-474)."""
        if self.encoder == "mlp":
            node_in = torch.cat([window, px_n[..., None], variables], -1)
            return swish(self.embed_2(swish(self.embed_1(node_in)))), None
        B, nx, _ = window.shape
        seq = self._sequence(window, px_n, variables)
        new_state = None
        if self.encoder == "lstm":
            y = self.lstm(seq)
        else:
            init = None
            if lem_state is not None:
                init = tuple(s.reshape(B * nx, -1) for s in lem_state)
            y, state = self.embedding_lem(seq, init)
            if self.save_state:
                new_state = tuple(s.reshape(B, nx, -1) for s in state)
        h = y.reshape(B, nx, self.hidden)
        h = swish(self.lemout_1(h))
        return swish(self.lemout_2(h)), new_state

    def _dt_cum(self, window):
        return torch.cumsum(torch.full((self.tw,), self.dt,
                                       dtype=window.dtype,
                                       device=window.device), 0)

    def _compose_scale_diff(self, window, scale, diff):
        """(1 - s) u_last + cumsum(dt) (s d) per component (gnn.py:
        507-516); scale, diff [B, nx, d tw] or [B, nx, d, tw]."""
        B, nx, _ = window.shape
        shape = (B, nx, self.d, self.tw)
        u_last = window.reshape(shape)[..., -1:]
        out = ((1.0 - scale.reshape(shape)) * u_last
               + self._dt_cum(window) * (scale.reshape(shape)
                                         * diff.reshape(shape)))
        return out.reshape(B, nx, -1)

    def _decode(self, h, window):
        B, nx, _ = window.shape
        if self.d == 2:
            # double_mlp: Dense H -> 2H and swish, two channels (gnn.py:
            # 523-527)
            chan = swish(self.double_mlp(h)).reshape(B, nx, 2, self.hidden)
        else:
            chan = h[..., None, :]  # [B, nx, 1, H]
        if self.decoder == "glu":
            # the hidden axis split in two (gnn.py:540-548)
            half = self.hidden // 2
            scale = self.output_mlp_gate(chan[..., :half])
            diff = self.output_mlp_diff(chan[..., half:])
            return self._compose_scale_diff(window, scale, diff)
        diff = self.output_mlp(chan)  # [B, nx, d, tw]
        if self.decoder == "diff_only":
            return diff.reshape(B, nx, -1)
        u_last = window.reshape(B, nx, self.d, self.tw)[..., -1:]
        return (u_last + self._dt_cum(window) * diff).reshape(B, nx, -1)
