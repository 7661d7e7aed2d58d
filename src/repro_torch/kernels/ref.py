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


def lstm_seq_traj(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Trajectory-writing oracle — the residual contract of the training
    path (the trajectory launch of kernels/csrc/lstm_seq.cu, consumed by
    kernels/csrc/lstm_seq_bwd.cu).

    Same math as ``lstm_seq``, but also returns the POST-step state
    trajectories ``(c_traj, h_traj)``, each (T, L, B, H) float32: the f32
    values the recurrence carries, not cast to x.dtype, because the
    backward recomputes the gates from them.  Returns (c, h, c_traj,
    h_traj) with (c, h) exactly ``lstm_seq``'s.  The contract does not
    depend on the kernel's tiling: every ``(block_b, time_chunk)`` writes
    these same arrays.
    """
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    c = [torch.zeros(B, H, dtype=F32, device=x.device) for _ in range(L)]
    h = [torch.zeros(B, H, dtype=F32, device=x.device) for _ in range(L)]
    cs, hs = [], []
    for t in range(T):
        inp = x[:, t].to(F32)
        for l in range(L):
            c[l], h[l] = lstm_cell(w[l], b[l], inp, c[l], h[l])
            inp = F.pad(h[l], (0, P - H)) if P > H else h[l]
        cs.append(torch.stack(c))
        hs.append(torch.stack(h))
    return (torch.stack(c).to(x.dtype), torch.stack(h).to(x.dtype),
            torch.stack(cs), torch.stack(hs))


# ---------------------------------------------------------------------------
# Int8 weight quantization (the ``fused_seq_q8`` plan)
#
# The scale contract: PER-OUTPUT-CHANNEL symmetric int8, one f32 scale per
# (layer, gate column), no zero point.  scale[l, j] = max(max_k |w[l, k, j]|,
# 1e-12) / 127, codes round(w / scale) in [-127, 127], dequantized weight
# codes * scale.  Biases stay f32.  The kernels never build the dequantized
# stack: they fold the scale into the gate pre-activations, so a kernel
# agrees with ``lstm_seq_q8`` (dequantize, then run) within fp rounding,
# not bit for bit.
# ---------------------------------------------------------------------------
def quantize_q8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w: (L, P+H, 4H) -> (int8 codes of the same shape, f32 scales (L, 4H)).

    Bit-equal to the JAX package's ``ref.quantize_q8``: the division is f32
    and ``torch.round`` rounds half to even, as ``jnp.round`` does (a
    product by 127 / amax, or f64 arithmetic, would move codes that sit on
    a .5 boundary)."""
    w32 = w.to(F32)
    scales = torch.clamp(w32.abs().amax(dim=1), min=1e-12) / 127.0
    q = torch.round(w32 / scales[:, None, :])
    return q.clamp(-127, 127).to(torch.int8), scales


def dequantize_q8(wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(L, P+H, 4H) int8 codes x (L, 4H) f32 scales -> f32 weights."""
    return wq.to(F32) * scales[:, None, :]


def quantize_dequantize_ste(w: torch.Tensor) -> torch.Tensor:
    """Straight-through quantize-dequantize: the value is the dequantized
    int8 weight, the gradient the identity — the differentiation contract
    of the q8 training path."""
    w32 = w.to(F32)
    with torch.no_grad():
        wdq = dequantize_q8(*quantize_q8(w32))
    return w32 + (wdq - w32).detach()


def lstm_seq_q8(wq: torch.Tensor, scales: torch.Tensor, b: torch.Tensor,
                x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dequantize-then-run oracle of the q8 sequence kernel."""
    return lstm_seq(dequantize_q8(wq, scales), b, x)


def lstm_seq_q8_traj(wq: torch.Tensor, scales: torch.Tensor, b: torch.Tensor,
                     x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Trajectory oracle of the q8 training path (``lstm_seq_traj``'s
    layout: f32 (T, L, B, H) post-step states)."""
    return lstm_seq_traj(dequantize_q8(wq, scales), b, x)
