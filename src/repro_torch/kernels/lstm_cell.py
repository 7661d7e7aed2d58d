"""Fused LSTM-cell kernel (K1): wrapper, launch counter and plain version.

Replaces the JAX package's Pallas kernel ``kernels/lstm_cell.py:_kernel``
(launched by ``_lstm_cell_call``) with the CUDA C++ kernel in
``csrc/lstm_cell.cu``.  One call is one cell step: ``[x, h] @ W + b`` with
the sigmoid/tanh gate math fused behind the product, writing ``(c', h')``.

What bounds it on the H100, and what the design does about it, is written
at the top of the CUDA source: at the paper's shapes one call moves ~34 KB
and its launch latency dominates, so the ``fused_cell`` plan's T x L launches
are its cost — the reason ``fused_seq`` exists.

A tensor on the CPU takes ``lstm_cell_plain``; a tensor on the card launches
the kernel or raises.  ``lstm_cell.launches`` counts kernel launches and
nothing else.

Autograd: a call that autograd records runs ``_LstmCellFn``, whose forward
is the kernel (the plain version on the CPU) and whose backward is the VJP
of the plain cell, ``ref.lstm_cell``, recomputed — what the JAX package's
``custom_vjp`` does (``kernels/lstm_cell.py:93-110``).  There is no
backward kernel, so a ``fused_cell`` training step launches T x L cells and
nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import factorization
from repro_torch.kernels import _build, ref

_NAME = "lstm_cell"

#: The plain PyTorch version (torch.matmul + elementwise ops, f32 math): the
#: CPU path of ``lstm_cell`` and the yardstick the kernel is held to.
lstm_cell_plain = ref.lstm_cell


def _entry():
    lib = _build.load(_NAME)
    fn = lib.lstm_cell_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _validate(w, b, x, c, h) -> None:
    B, D = x.shape
    H = c.shape[-1]
    if w.shape != (D + H, 4 * H) or b.shape != (4 * H,) \
            or c.shape != (B, H) or h.shape != (B, H):
        raise ValueError(f"lstm_cell shapes: w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}, x {tuple(x.shape)}, c "
                         f"{tuple(c.shape)}, h {tuple(h.shape)}")
    for name, t in (("w", w), ("b", b), ("x", x), ("c", c), ("h", h)):
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_cell takes float32 tensors; {name} is "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"lstm_cell: {name} is on {t.device}, x on "
                             f"{x.device}")


def lstm_cell(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              c: torch.Tensor, h: torch.Tensor, *,
              block_b: int | None = None, block_h: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused cell step.  w: (D+H, 4H) gate order (i,f,g,o); b: (4H,);
    x: (B, D); c, h: (B, H), all float32.  Returns (c', h').

    ``block_b``/``block_h`` tile the (B, H) output per thread block; None
    takes ``factorization.choose_block(B, H, D+H)``.  Under autograd the
    backward is the VJP of ``ref.lstm_cell`` (``_LstmCellFn``)."""
    _validate(w, b, x, c, h)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_cell runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (w, b, x, c, h)):
        return _LstmCellFn.apply(w, b, x, c, h, block_b, block_h)
    return _forward(w, b, x, c, h, block_b, block_h)


def _forward(w, b, x, c, h, block_b: int | None, block_h: int | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cell step outside autograd: the plain version on the CPU, one
    kernel launch on the card."""
    if x.device.type == "cpu":
        return lstm_cell_plain(w, b, x, c, h)
    if x.stride(-1) != 1 or h.stride(-1) != 1:
        raise ValueError("lstm_cell: x and h need a contiguous last dim")
    B, D = x.shape
    H = c.shape[-1]
    if block_b is None or block_h is None:
        bm, bh, _ = factorization.choose_block(B, H, D + H)
        block_b = block_b or bm
        block_h = block_h or bh
    if block_b * block_h > 1024:
        raise ValueError(f"lstm_cell: block {block_b}x{block_h} exceeds "
                         "1024 threads")
    if block_b * (D + H) * 4 > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"lstm_cell: staging {block_b} rows of {D + H} "
                         "exceeds a thread block's shared memory")
    w, b, c = w.contiguous(), b.contiguous(), c.contiguous()
    c_out = torch.empty_like(c)
    h_out = torch.empty_like(c)
    lib, fn = _entry()
    err = fn(w.data_ptr(), b.data_ptr(), x.data_ptr(), c.data_ptr(),
             h.data_ptr(), c_out.data_ptr(), h_out.data_ptr(), B, D, H,
             x.stride(0), h.stride(0), block_b, block_h,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, _NAME, err)
    lstm_cell.launches += 1
    return c_out, h_out


class _LstmCellFn(torch.autograd.Function):
    """``lstm_cell`` under autograd: the kernel forward, and the VJP of
    ``ref.lstm_cell`` recomputed from the saved operands as the backward."""

    @staticmethod
    def forward(ctx, w, b, x, c, h, block_b, block_h):
        ctx.save_for_backward(w, b, x, c, h)
        return _forward(w, b, x, c, h, block_b, block_h)

    @staticmethod
    def backward(ctx, dc, dh):
        ins = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.lstm_cell(*ins)
        grads = torch.autograd.grad(out, ins, (dc, dh))
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


#: kernel launches since the last reset (CPU calls are not counted)
lstm_cell.launches = 0
