"""Plain-PyTorch oracles of the kernels (the twin of the JAX package's
``kernels/ref.py``): the LSTM kernels, the RWKV6 chunked scan and the
two attention kernels, f32 math, results cast back to the IO dtype where
the kernel's are.

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


# ---------------------------------------------------------------------------
# RWKV6 chunked wkv scan (kernels/wkv6.py)
# ---------------------------------------------------------------------------
def wkv6_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the RWKV6 recurrence, f32, for one (batch, head) or
    a batch of them (any leading dims).

    r,k,logw: (..., C, dk); v: (..., C, dv); u: (..., dk);
    state: (..., dk, dv).
      S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
      out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    Stable within-chunk parallel form using only non-positive exponents.
    """
    r, k, v = r.to(F32), k.to(F32), v.to(F32)
    logw, u, state = logw.to(F32), u.to(F32), state.to(F32)
    C = r.shape[-2]
    L = torch.cumsum(logw, dim=-2)              # inclusive: L_i = sum_{j<=i}
    L_prev = L - logw                           # exclusive: L_{i-1}
    # carry term: r_i diag(exp(L_prev_i)) S
    out = (r * torch.exp(L_prev)) @ state       # (..., C, dv)
    # intra-chunk term, j < i:  A[i,j,c] = exp(L_prev[i,c] - L[j,c])  (<= 0)
    diff = L_prev[..., :, None, :] - L[..., None, :, :]     # (..., C, C, dk)
    idx = torch.arange(C, device=r.device)
    mask = idx[:, None] > idx[None, :]
    # mask the exponent (j >= i entries are positive: exp would overflow
    # under strong decay and NaN the VJP), not the scores
    diff = torch.where(mask[:, :, None], diff,
                       torch.tensor(-torch.inf, device=r.device))
    scores = torch.einsum("...ic,...jc,...ijc->...ij", r, k, torch.exp(diff))
    out = out + scores @ v
    # bonus (diagonal) term
    out = out + torch.einsum("...ic,...c,...ic->...i", r, u, k)[..., None] * v
    # state update: S' = diag(exp(L_last)) S
    #                    + sum_j diag(exp(L_last - L_j)) k_j^T v_j
    L_last = L[..., -1, :]
    decay_j = torch.exp(L_last[..., None, :] - L)  # (..., C, dk), <= 0
    state_new = (torch.exp(L_last)[..., :, None] * state
                 + (k * decay_j).transpose(-1, -2) @ v)
    return out, state_new


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
         chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence oracle: ``wkv6_chunk`` over T/chunk chunks in order.

    r,k,logw: (..., T, dk); v: (..., T, dv); state: (..., dk, dv);
    T % chunk == 0.  Returns (out (..., T, dv) f32, state f32)."""
    T = r.shape[-2]
    assert T % chunk == 0, (T, chunk)
    s = state.to(F32)
    outs = []
    for t0 in range(0, T, chunk):
        win = slice(t0, t0 + chunk)
        out, s = wkv6_chunk(r[..., win, :], k[..., win, :], v[..., win, :],
                            logw[..., win, :], u, s)
        outs.append(out)
    return torch.cat(outs, dim=-2), s


def wkv6_traj(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
              chunk: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trajectory-writing oracle — the residual contract of the RWKV6
    training path (the trajectory launch of kernels/csrc/wkv6.cu, consumed
    by kernels/csrc/wkv6_bwd.cu).

    ``wkv6`` plus the CHUNK-INCOMING states ``s_traj (..., T // chunk, dk,
    dv)`` f32: entry ``t`` is the state chunk ``t`` starts from (entry 0 is
    ``state``), as the JAX package's ``_fwd_body`` writes them.  Returns
    (out, state', s_traj) with (out, state') exactly ``wkv6``'s."""
    T = r.shape[-2]
    assert T % chunk == 0, (T, chunk)
    s = state.to(F32)
    outs, traj = [], []
    for t0 in range(0, T, chunk):
        win = slice(t0, t0 + chunk)
        traj.append(s)
        out, s = wkv6_chunk(r[..., win, :], k[..., win, :], v[..., win, :],
                            logw[..., win, :], u, s)
        outs.append(out)
    return torch.cat(outs, dim=-2), s, torch.stack(traj, dim=-3)


def wkv6_stepwise(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-timestep reference recurrence (the 'fine-grained' plan), f32.
    r,k,logw: (..., T, dk); v: (..., T, dv); state: (..., dk, dv)."""
    r, k, v = r.to(F32), k.to(F32), v.to(F32)
    logw, u, s = logw.to(F32), u.to(F32), state.to(F32)
    outs = []
    for t in range(r.shape[-2]):
        kv = k[..., t, :, None] * v[..., t, None, :]
        outs.append((r[..., t, None, :] @ (s + u[..., :, None] * kv))[..., 0, :])
        s = torch.exp(logw[..., t, :])[..., :, None] * s + kv
    return torch.stack(outs, dim=-2), s


# ---------------------------------------------------------------------------
# Blocked causal prefill attention (kernels/flash_prefill.py)
# ---------------------------------------------------------------------------
def prefill_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int = 0, scale: float | None = None
                 ) -> torch.Tensor:
    """Naive causal attention oracle.  q: (B,S,Hq,dh); k,v: (B,S,Hkv,dh).
    GQA: query head h reads kv head h // (Hq // Hkv)."""
    S, Hq, dh = q.shape[1], q.shape[2], q.shape[3]
    group = Hq // k.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    kr = torch.repeat_interleave(k.to(F32), group, dim=2)
    vr = torch.repeat_interleave(v.to(F32), group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), kr) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


# ---------------------------------------------------------------------------
# Single-token flash-decode attention (kernels/decode_attn.py)
# ---------------------------------------------------------------------------
def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, length: torch.Tensor | int,
                scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, dk); caches: (B, S, Hkv, dk); length: valid cache length
    (a scalar or one per row).  GQA: query head h reads kv head
    h // (Hq // Hkv).  Returns (B, Hq, dk); a row of length 0 is NaN (the
    kernel's is 0)."""
    S, Hkv, dk = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
    scale = dk ** -0.5 if scale is None else scale
    group = q.shape[1] // Hkv
    kc = torch.repeat_interleave(k_cache.to(F32), group, dim=2)
    vc = torch.repeat_interleave(v_cache.to(F32), group, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.to(F32), kc) * scale
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1)
    valid = torch.arange(S, device=q.device)[None, None, :] < length
    scores = torch.where(valid, scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vc).to(q.dtype)
