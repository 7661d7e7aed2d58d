"""Wavefront (anti-diagonal) execution of stacked recurrent layers.

Paper Fig 1: in a stacked RNN, cell (layer i, time t) depends only on
(i-1, t) and (i, t-1); all cells with equal i+t are independent and can run
concurrently.  MobiRNN exploits this and bounds the live state to
2 x wavefront-width buffers (6 instead of 24 in the paper's figure).

Each diagonal runs as ONE batched cell over the layer axis — a single
(L, B, P+H) x (L, P+H, 4H) ``torch.bmm`` — where the JAX package vmaps the
cell over layers.  Numerical equivalence with the sequential plan is
asserted in tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.mobirnn_lstm import LSTMConfig
from repro_torch.kernels.lstm_seq import stack_params


def wavefront_width(n_layers: int, seq_len: int) -> int:
    """Maximum number of concurrently-executable cells (paper: 3 for 3x4)."""
    return min(n_layers, seq_len)


def live_buffers(n_layers: int, seq_len: int) -> int:
    """State buffers MobiRNN preallocates: (c,h) per wavefront slot."""
    return 2 * wavefront_width(n_layers, seq_len)


def stack_homogeneous(params: dict, cfg: LSTMConfig
                      ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Stack per-layer cell params to (L, P+H, 4H) / (L, 4H) with every
    layer's input rows zero-padded to P = max(input_dim, H) — the same
    stack the sequence-resident kernel loads (kernels/lstm_seq.stack_params).
    Returns (w_stack, b_stack, P)."""
    return stack_params(params["layers"], cfg.hidden)


def forward_wavefront(params: dict, x: torch.Tensor, cfg: LSTMConfig
                      ) -> torch.Tensor:
    """x: (batch, seq, input_dim) -> logits (batch, n_classes)."""
    L, H = cfg.n_layers, cfg.hidden
    B, T, D = x.shape
    w_stack, b_stack, P = stack_homogeneous(params, cfg)

    # time-padded, P-padded input belt source: x_pad[t] valid for t < T
    x_pad = x.new_zeros(T + L, B, P)
    x_pad[:T, :, :D] = x.transpose(0, 1)

    c = x.new_zeros(L, B, H)
    h = x.new_zeros(L, B, H)
    belt = x.new_zeros(L, B, P)          # belt[i] = input for layer i
    layer_ids = torch.arange(L, device=x.device)
    for d in range(L + T - 1):
        # layer i processes time t = d - i; active iff 0 <= t < T
        t = d - layer_ids
        active = ((t >= 0) & (t < T))[:, None, None]
        inp = torch.cat([x_pad[min(d, T + L - 1)][None], belt[1:]], dim=0)
        xh = torch.cat([inp, h], dim=-1)                 # (L, B, P+H)
        gates = torch.bmm(xh, w_stack) + b_stack[:, None, :]
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        c = torch.where(active, c_new, c)
        h = torch.where(active, h_new, h)
        # the belt shifts down one layer: layer i+1's next input is i's h
        h_belt = h if P == H else F.pad(h, (0, P - H))
        belt = torch.cat([torch.zeros_like(h_belt[:1]), h_belt[:-1]], dim=0)
    return h[-1] @ params["head"]["w"] + params["head"]["b"]
