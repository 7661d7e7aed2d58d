"""Public entry points of the kernels, with automatic blocks.

``lstm_cell`` takes its tile and K split from ``lstm_cell.choose_blocks``;
``lstm_seq`` and ``lstm_seq_q8`` take their ``(block_b, time_chunk)`` from
``lstm_seq.choose_batch_block``; ``wkv6`` takes its chunk from the caller
(the model's ``cfg.ssm.chunk``) and runs one batch-head row per thread
block; ``mamba_scan`` takes its chunk from the caller and runs one batch
row and ``di_tile`` channels per thread block; ``flash_prefill`` takes its
``(q_block, k_block)`` from ``flash_prefill.choose_blocks`` and runs one
(row, query head, q tile) per thread block; ``decode_attn`` takes its
``block_s`` and its split over cache positions from
``decode_attn.choose_blocks`` and runs one (row, kv head, span of positions)
per thread block.  Any block may be pinned by the caller.  CPU tensors run the kernels' plain versions; CUDA tensors
launch the kernels.  The entries are differentiable: under autograd
``lstm_seq``, ``lstm_seq_q8``, ``wkv6`` and ``mamba_scan`` pair their
trajectory launch with their backward kernel, and ``lstm_cell`` takes the
VJP of its plain version; the two attention kernels serve inference only
and raise on the card under autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attn as _decode_attn
from repro_torch.kernels import flash_prefill as _flash_prefill
from repro_torch.kernels import lstm_cell as _lstm_cell
from repro_torch.kernels import lstm_seq as _lstm_seq
from repro_torch.kernels import mamba_scan as _mamba_scan
from repro_torch.kernels import wkv6 as _wkv6


def lstm_cell(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              c: torch.Tensor, h: torch.Tensor, *,
              block_b: int | None = None, block_h: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused cell step: w (D+H, 4H), b (4H,), x (B, D), c/h (B, H)."""
    return _lstm_cell.lstm_cell(w, b, x, c, h, block_b=block_b,
                                block_h=block_h)


def lstm_seq(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
             block_b: int | None = None, time_chunk: int | None = None,
             bwd_block_b: int | None = None,
             bwd_time_chunk: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-sequence stacked LSTM, ONE kernel launch for all T steps (and,
    under autograd, ONE reverse-sweep launch for the backward).

    w: (L, P+H, 4H) (lstm_seq.stack_params); b: (L, 4H); x: (B, T, P)
    padded input.  Returns final (c, h), each (L, B, H).
    ``block_b``/``time_chunk`` tile the forward; ``bwd_block_b``/
    ``bwd_time_chunk`` tile the training path, its trajectory forward
    included (None: from ``choose_batch_block(mode="bwd")``).  Raises ValueError when the weight stack exceeds a
    thread block's shared memory even at (bm=1, tc=1) —
    core/lstm.forward_fused_seq routes that case to the per-cell kernel —
    and, on CUDA tensors under autograd, when the backward fits nowhere (a
    CPU call then takes autograd of ``ref.lstm_seq``)."""
    return _lstm_seq.lstm_seq(w, b, x, block_b=block_b,
                              time_chunk=time_chunk, bwd_block_b=bwd_block_b,
                              bwd_time_chunk=bwd_time_chunk)


def lstm_seq_q8(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
                block_b: int | None = None, time_chunk: int | None = None,
                bwd_block_b: int | None = None,
                bwd_time_chunk: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lstm_seq`` over int8 weights: ``w`` is the f32 MASTER stack,
    quantized per output channel inside (``ref.quantize_q8``) and held by
    the kernel as int8 codes plus (L, 4H) f32 scales.  ONE launch forward,
    and under autograd one trajectory launch plus one backward launch with
    f32 straight-through gradients.  Tiles from
    ``choose_batch_block(quantized=True)``; the same ValueErrors as
    ``lstm_seq``."""
    return _lstm_seq.lstm_seq_q8(w, b, x, block_b=block_b,
                                 time_chunk=time_chunk,
                                 bwd_block_b=bwd_block_b,
                                 bwd_time_chunk=bwd_time_chunk)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
         chunk: int = 32, bh_tile: int = 1
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 chunked scan, ONE kernel launch for the whole sequence.

    r, k, logw: (BH, T, dk); v: (BH, T, dv); u: (BH, dk); state:
    (BH, dk, dv).  Returns (out (BH, T, dv) in v's dtype, final state f32).
    Under autograd: the trajectory launch K6t forward and the backward
    kernel K6b (on the CPU their plain versions)."""
    return _wkv6.wkv6(r, k, v, logw, u, state, chunk=chunk, bh_tile=bh_tile)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor, *,
               chunk: int = 16, block_b: int | None = None,
               di_tile: int | None = None, bwd: int = _mamba_scan.FUSED_BWD
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba selective scan, ONE kernel launch for the whole sequence.

    x, dt: (B, T, di); b, c: (B, T, ds); a: (di, ds); h0: (B, di, ds).
    Returns (y (B, T, di) in x's dtype, final state f32).  Under autograd:
    the trajectory launch K7t forward and the backward kernel K7b (on the
    CPU their plain versions); ``bwd=ORACLE_BWD`` differentiates the plain
    scan instead, on the CPU only.  The ``fused_scan`` plan calls this."""
    return _mamba_scan.mamba_scan(x, dt, b, c, a, h0, chunk=chunk,
                                  block_b=block_b, di_tile=di_tile, bwd=bwd)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, scale: float | None = None,
                  q_block: int | None = None, k_block: int | None = None
                  ) -> torch.Tensor:
    """Causal GQA prefill attention, ONE kernel launch (K8).

    q: (B, S, Hq, dh); k, v: (B, S, Hkv, dh); ``window`` > 0 restricts each
    query to the last ``window`` positions.  Returns (B, S, Hq, dh) in q's
    dtype.  The ``flash_prefill`` prefill plan of ``models/attention``
    calls this."""
    return _flash_prefill.flash_prefill(q, k, v, window=window, scale=scale,
                                        q_block=q_block, k_block=k_block)


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor, *,
                scale: float | None = None, block_s: int | None = None
                ) -> torch.Tensor:
    """One new token's GQA attention over a cache, ONE kernel launch (K9).

    q: (B, Hq, dk); caches: (B, S, Hkv, dk); lengths: (B,) int32 on the
    device.  Returns (B, Hq, dk) in q's dtype, 0 for a row of length 0.
    The ``decode_attn`` decode plan of ``models/attention`` calls this."""
    return _decode_attn.decode_attn(q, k_cache, v_cache, lengths,
                                    scale=scale, block_s=block_s)
