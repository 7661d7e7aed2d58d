"""Public entry points of the LSTM kernels, with automatic blocks.

``lstm_cell`` tiles its (B, H) output with ``factorization.choose_block``;
``lstm_seq`` takes its ``(block_b, time_chunk)`` from
``lstm_seq.choose_batch_block``.  Either block may be pinned by the caller.
CPU tensors run the kernels' plain versions; CUDA tensors launch the
kernels.
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
             block_b: int | None = None, time_chunk: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-sequence stacked LSTM, ONE kernel launch for all T steps.

    w: (L, P+H, 4H) (lstm_seq.stack_params); b: (L, 4H); x: (B, T, P)
    padded input.  Returns final (c, h), each (L, B, H).  Raises ValueError
    when the weight stack exceeds a thread block's shared memory even at
    (bm=1, tc=1) — core/lstm.forward_fused_seq routes that case to the
    per-cell kernel."""
    return _lstm_seq.lstm_seq(w, b, x, block_b=block_b,
                              time_chunk=time_chunk)
