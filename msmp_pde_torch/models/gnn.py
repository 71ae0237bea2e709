"""Message-passing PDE solvers of the MP-PDE family (counterpart of
msmp_pde_tpu/models/gnn.py): the nine 1-D graph models MP-PDE, Gated,
LEM, MSMP-PDE, MSSMP-PDE, MSGMP-PDE, SaveMSMP-PDE, LSTMGated and LSTM.

The graph is a dense per-node neighbour list ``idx``/``mask`` [nx, K]
(data/graph.py); message passing is a gather over the K axis and a masked
mean. Module and parameter names follow the flax tree, so a converted
checkpoint loads with ``load_state_dict`` (utils/convert.py).
"""
from __future__ import annotations

import torch
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

_ROADMAP = "not ported yet (ROADMAP.md Queue 1 item 11)"


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

    def forward(self, h, u, px, variables, idx, mask):
        """h [B, nx, H], px [B, nx] -> [B, nx, H]; on CUDA tensors through
        the layer kernels (ops/mp_layer.py)."""
        return mp_layer.fused_mp_layer(h, u, px[..., None], variables, idx,
                                       mask, self.weights(), self.final_act,
                                       self.residual)


class MPSolver(nn.Module):
    """Encode - process - decode. forward(window [B, nx, tw], pos_x [B, nx],
    t [B], var_vec [B, V], idx, mask, lem_state=None) -> (out [B, nx, tw],
    new LEM state or None).

    The encoder is an MLP on [window, px, variables] (``mlp``), or the LEM
    or the LSTM over the window (``lem``, ``lstm``); the processor is six
    GNN_Layers with final swish and residual (gate ``none``) or six
    sigmoid-gated pairs of GNN_LayerLins (gate ``sigmoid``); the decoder is
    the two-conv CNN on the temporal residual (``cnn``), the two half-hidden
    GLU convs as scale and difference (``glu``), or the CNN's raw output
    (``diff_only``). With ``save_state`` the LEM starts from ``lem_state``
    ((y, z), each [B, nx, H]; zeros when None) and returns its final state;
    with ``twin_scale`` two LEM + sigmoid ``diff_only`` towers
    (``diff_tower``, ``scale_tower``) give the difference and the scale of
    the composition (1 - s) u_last + cumsum(dt) (s d). CUDA tensors go
    through the kernels, CPU tensors through their plain PyTorch versions;
    with grad, the LEM scan, each layer and each gated pair go through
    their autograd Functions (ops/lem_scan.py, ops/mp_layer.py,
    ops/mp_pair.py)."""

    def __init__(self, tw: int, *, n_vars: int, hidden: int = 128,
                 layers: int = 6, n_components: int = 1,
                 encoder: str = "lem", gate: str = "sigmoid",
                 decoder: str = "cnn", twin_scale: bool = False,
                 save_state: bool = False, L: float = 16.0,
                 tmax: float = 4.0, dt: float = 4.0 / 249, seed: int = 0):
        super().__init__()
        if (encoder not in ("mlp", "lem", "lstm")
                or gate not in ("none", "sigmoid")
                or decoder not in ("cnn", "glu", "diff_only")):
            raise NotImplementedError(
                f"MPSolver(encoder={encoder!r}, gate={gate!r}, "
                f"decoder={decoder!r}) is {_ROADMAP}")
        if n_components != 1:
            raise NotImplementedError(f"2-component systems are {_ROADMAP}")
        self.tw, self.hidden, self.layers = tw, hidden, layers
        self.encoder, self.gated = encoder, gate == "sigmoid"
        self.decoder, self.twin_scale = decoder, twin_scale
        self.save_state = save_state
        self.L, self.tmax, self.dt = L, tmax, dt
        if twin_scale:
            # MSSMP (gnn.py:269-287): two full towers, no parameter of
            # its own
            for i, name in enumerate(("diff_tower", "scale_tower")):
                self.add_module(name, MPSolver(
                    tw, n_vars=n_vars, hidden=hidden, layers=layers,
                    encoder="lem", gate="sigmoid", decoder="diff_only", L=L,
                    tmax=tmax, dt=dt, seed=seed + i))
            return
        g = torch.Generator().manual_seed(seed)
        if encoder == "lem":
            self.embedding_lem = LEM(2 + n_vars, hidden, g)
        elif encoder == "lstm":
            self.lstm = LSTM(2 + n_vars, hidden, g)
        else:
            self.embed_1 = Dense(tw + 1 + n_vars, hidden, g)
            self.embed_2 = Dense(hidden, hidden, g)
        if encoder != "mlp":
            self.lemout_1 = Dense(hidden, hidden, g)
            self.lemout_2 = Dense(hidden, hidden, g)
        plain = not self.gated  # ungated stacks use GNN_Layer (gnn.py:341-348)
        for i in range(layers):
            self.add_module(f"gnn_{i}", GNNLayer(hidden, tw, n_vars, g,
                                                 plain, plain))
            if self.gated:
                self.add_module(f"gate_{i}",
                                GNNLayer(hidden, tw, n_vars, g))
        if decoder == "glu":
            self.output_mlp_gate = GLUConv(tw, hidden // 2, g)
            self.output_mlp_diff = GLUConv(tw, hidden - hidden // 2, g)
        else:
            self.output_mlp = WindowDecoder(tw, hidden, g)

    def forward(self, window, pos_x, t, var_vec, idx, mask, lem_state=None):
        if self.twin_scale:
            diff, _ = self.diff_tower(window, pos_x, t, var_vec, idx, mask)
            scale, _ = self.scale_tower(window, pos_x, t, var_vec, idx, mask)
            return self._compose_scale_diff(window, scale, diff), None
        B, nx, tw = window.shape
        V = var_vec.shape[-1]
        px_n = pos_x / self.L
        variables = var_vec[:, None, :].expand(B, nx, V)
        h, new_state = self._encode(window, px_n, variables, lem_state)
        for i in range(self.layers):
            layer = getattr(self, f"gnn_{i}")
            if self.gated:
                h = mp_pair.fused_gated_pair(
                    h, window, px_n[..., None], variables, idx, mask,
                    getattr(self, f"gate_{i}").weights(), layer.weights())
            else:
                h = layer(h, window, px_n, variables, idx, mask)
        return self._decode(h, window), new_state

    def _sequence(self, window, px_n, variables):
        """The recurrent encoders' per-step inputs [tw, B nx, 2 + V]:
        [px_n, u_k, variables] for each step k of the window
        (gnn.py:434-440)."""
        B, nx, tw = window.shape
        return torch.cat([
            px_n[None, ..., None].expand(tw, B, nx, 1),
            window.permute(2, 0, 1)[..., None],
            variables[None].expand(tw, B, nx, variables.shape[-1]),
        ], dim=-1).reshape(tw, B * nx, -1)

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
        """(1 - s) u_last + cumsum(dt) (s d) (gnn.py:507-516)."""
        u_last = window[..., -1:]
        return (1.0 - scale) * u_last + self._dt_cum(window) * (scale * diff)

    def _decode(self, h, window):
        B, nx, tw = window.shape
        chan = h[..., None, :]  # [B, nx, 1, H]
        if self.decoder == "glu":
            # the hidden axis split in two (gnn.py:540-548)
            half = self.hidden // 2
            scale = self.output_mlp_gate(chan[..., :half])
            diff = self.output_mlp_diff(chan[..., half:])
            return self._compose_scale_diff(window, scale.reshape(B, nx, tw),
                                            diff.reshape(B, nx, tw))
        diff = self.output_mlp(chan)  # [B, nx, 1, tw]
        if self.decoder == "diff_only":
            return diff.reshape(B, nx, tw)
        u_last = window.reshape(B, nx, 1, tw)[..., -1:]
        return (u_last + self._dt_cum(window) * diff).reshape(B, nx, tw)
