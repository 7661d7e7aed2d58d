"""Plain-PyTorch oracles of the LSTM kernels (the twin of the JAX package's
``kernels/ref.py``): f32 math, results cast back to the IO dtype.

Each CUDA kernel of the port is held against these on the card, and the CPU
tests hold these against the JAX originals.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def lstm_cell(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              c: torch.Tensor, h: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """w: (D+H, 4H) gate order (i,f,g,o); x: (B,D); c,h: (B,H)."""
    xh = torch.cat([x, h], dim=-1)
    gates = xh.to(F32) @ w.to(F32) + b.to(F32)
    i, f, g, o = gates.chunk(4, dim=-1)
    c32 = c.to(F32)
    c_new = torch.sigmoid(f) * c32 + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return c_new.to(c.dtype), h_new.to(h.dtype)


def lstm_seq(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the whole-sequence stacked-LSTM kernel.

    w: (L, P+H, 4H) stacked gate weights (gate order i,f,g,o), where P >= H
    is the padded per-layer input width (lstm_seq.stack_params); b: (L, 4H);
    x: (B, T, P) input already zero-padded to width P.
    Returns final (c, h), each (L, B, H) in x.dtype — h[-1] feeds the head.
    """
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    c = [torch.zeros(B, H, dtype=F32, device=x.device) for _ in range(L)]
    h = [torch.zeros(B, H, dtype=F32, device=x.device) for _ in range(L)]
    for t in range(T):
        inp = x[:, t].to(F32)
        for l in range(L):
            # per-layer step IS the fused-cell oracle on the stacked
            # (P+H, 4H) weights: cat([inp, h]) @ w[l]
            c[l], h[l] = lstm_cell(w[l], b[l], inp, c[l], h[l])
            inp = F.pad(h[l], (0, P - H)) if P > H else h[l]
    return torch.stack(c).to(x.dtype), torch.stack(h).to(x.dtype)
