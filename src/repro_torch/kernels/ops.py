"""Public entry points of the LSTM kernels, with automatic blocks.

``lstm_cell`` tiles its (B, H) output with ``factorization.choose_block``;
``lstm_seq`` and ``lstm_seq_q8`` take their ``(block_b, time_chunk)`` from
``lstm_seq.choose_batch_block``.  Any block may be pinned by the caller.
CPU tensors run the kernels' plain versions; CUDA tensors launch the
kernels.  All are differentiable: under autograd ``lstm_seq`` and
``lstm_seq_q8`` pair their trajectory launch with the backward kernel, and
``lstm_cell`` takes the VJP of its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lstm_cell as _lstm_cell
from repro_torch.kernels import lstm_seq as _lstm_seq


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
