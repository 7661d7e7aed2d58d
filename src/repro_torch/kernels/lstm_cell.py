"""Fused LSTM-cell kernel (K1): wrapper, budget table, launch counter and
plain version.

Replaces the JAX package's Pallas kernel ``kernels/lstm_cell.py:_kernel``
(launched by ``_lstm_cell_call``) with the CUDA C++ kernel in
``csrc/lstm_cell.cu``.  One call is one cell step: ``[x, h] @ W + b`` with
the sigmoid/tanh gate math fused behind the product, writing ``(c', h')``.
The kernel is built for float32 and for bfloat16 operands (``DTYPES``);
the bf16 instance does all its arithmetic in f32 and rounds only (c', h').

What bounds it on the H100, and what the design does about it, is written
at the top of the CUDA source: at the paper's shapes one call moves ~34 KB,
so a call's cost is its chain of latencies (the launch, one round trip to
memory, a barrier, the gates), and the ``fused_cell`` plan's T x L
launches are its cost.  The kernel splits the K = D + H reduction over the
threads of a block, every load of a thread in flight before its FMAs, and
spreads a small batch's gate columns over several blocks;
``choose_blocks`` prices the tile, and the C side refuses any other.

A tensor on the CPU takes ``lstm_cell_plain``; a tensor on the card launches
the kernel or raises.  ``lstm_cell.launches`` counts kernel launches and
nothing else; ``lstm_cell.bf16_launches`` those of them on the bf16
instance.

Autograd: a call that autograd records runs ``_LstmCellFn``, whose forward
is the kernel (the plain version on the CPU) and whose backward is the VJP
of the plain cell, ``ref.lstm_cell``, recomputed — what the JAX package's
``custom_vjp`` does (``kernels/lstm_cell.py:93-110``).  There is no
backward kernel, so a ``fused_cell`` training step launches T x L cells and
nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build, ref

_NAME = "lstm_cell"
#: K rows a slice of threads loads before its FMAs (csrc kUnroll)
UNROLL = 8
#: threads of a block at most (csrc kMaxThreads)
MAX_THREADS = 256
#: the tiles the kernel is built for, coarse to fine: rows a block
#: (a template argument) and hidden columns a block (4-column quads of
#: each gate)
BLOCK_BS = (8, 4, 2, 1)
BLOCK_HS = (32, 16, 8, 4)

#: The plain PyTorch version (torch.matmul + elementwise ops, f32 math): the
#: CPU path of ``lstm_cell`` and the yardstick the kernel is held to.
lstm_cell_plain = ref.lstm_cell


class CellBlocks(NamedTuple):
    """One launch of K1: a tile of ``block_b`` rows x ``block_h`` hidden
    columns (all four gates) a block, ``k_slices`` slices of the K = D + H
    reduction (``threads`` = k_slices x block_h), ``smem`` bytes of shared
    memory and ``grid`` blocks."""
    block_b: int
    block_h: int
    k_slices: int
    threads: int
    smem: int
    grid: int


def working_set_bytes(block_b: int, block_h: int, k_slices: int) -> int:
    """Dynamic shared memory of one block, exactly as the kernel launches
    it: each K slice's f32 partial sums of its tile, block_b rows x 4 gates
    x block_h columns."""
    ws = tiling.WorkingSet()
    ws.add("partials", 4 * k_slices * block_b * 4 * block_h)
    return ws.total()


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def choose_blocks(B: int, D: int, H: int, *, block_b: int | None = None,
                  block_h: int | None = None) -> CellBlocks | None:
    """K1's budget table: the tile, the K split and the thread count, the
    same for both dtypes (the shared memory is the f32 partial sums either
    way; a bf16 slice's loads are half the bytes of an f32 one's).

    The tile starts as coarse as the batch and hidden width ask (at most
    8 rows x 32 columns) and is halved, columns first, then rows, until
    the grid has a block for each of the H100's SMs or the tile is 1 x 4:
    a cell is a chain of latencies, and a small tile spreads it over more
    SMs without lengthening the chain.  ``block_b``/``block_h`` pin either
    side (JAX's ``lstm_cell`` keywords); a pin outside ``BLOCK_BS``/
    ``BLOCK_HS`` gives None, as does no shape.  K = D + H is split into
    enough slices of ``UNROLL`` rows for one pass, within ``MAX_THREADS``
    (at least ``block_b`` slices: each thread then writes at most one
    output); a longer K streams through the slices in several passes."""
    if B < 1 or D < 0 or H < 1 or (block_b is not None and block_b not in
                                   BLOCK_BS) \
            or (block_h is not None and block_h not in BLOCK_HS):
        return None
    bm = block_b or min(BLOCK_BS[0], _pow2_at_least(B))
    bh = block_h or min(BLOCK_HS[0], max(BLOCK_HS[-1], _pow2_at_least(H)))

    def grid(bm_: int, bh_: int) -> int:
        return -(-H // bh_) * -(-B // bm_)

    while grid(bm, bh) < factorization.H100_SMS:
        if block_h is None and bh > BLOCK_HS[-1]:
            bh //= 2
        elif block_b is None and bm > BLOCK_BS[-1]:
            bm //= 2
        else:
            break
    ks = max(bm, min(-(-(D + H) // UNROLL), MAX_THREADS // bh))
    if -(-B // bm) > 65535:
        return None
    return CellBlocks(bm, bh, ks, ks * bh, working_set_bytes(bm, bh, ks),
                      grid(bm, bh))


#: the dtypes the kernel is built for: every operand float32, or every
#: operand bfloat16
DTYPES = (torch.float32, torch.bfloat16)


def _entry(dtype: torch.dtype):
    lib = _build.load(_NAME)
    fn = lib.lstm_cell_f32 if dtype == torch.float32 else lib.lstm_cell_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_void_p])
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
        if t.dtype not in DTYPES or t.dtype != w.dtype:
            raise TypeError(f"lstm_cell takes all float32 or all bfloat16 "
                            f"tensors; w is {w.dtype}, {name} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"lstm_cell: {name} is on {t.device}, x on "
                             f"{x.device}")


def lstm_cell(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              c: torch.Tensor, h: torch.Tensor, *,
              block_b: int | None = None, block_h: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused cell step.  w: (D+H, 4H) gate order (i,f,g,o); b: (4H,);
    x: (B, D); c, h: (B, H), all float32 or all bfloat16.  Returns
    (c', h') in that dtype: a bf16 call widens every operand to f32 (the
    JAX kernel's f32 product, bias and gates) and rounds (c', h') to bf16,
    so a ``fused_cell`` sequence in bf16 rounds its state every step.

    ``block_b``/``block_h`` pin the (rows, hidden columns) tile of a thread
    block, a side of ``BLOCK_BS``/``BLOCK_HS``; None takes
    ``choose_blocks``'s.  Under autograd the backward is the VJP of
    ``ref.lstm_cell`` (``_LstmCellFn``)."""
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
    blocks = choose_blocks(B, D, H, block_b=block_b, block_h=block_h)
    if blocks is None:
        raise ValueError(f"lstm_cell: no launch for B={B} D={D} H={H} at "
                         f"block_b={block_b}, block_h={block_h} (tiles of "
                         f"{BLOCK_BS} rows x {BLOCK_HS} columns)")
    w = _build.aligned(w)
    b, c = b.contiguous(), c.contiguous()
    c_out = torch.empty_like(c)
    h_out = torch.empty_like(c)
    lib, fn = _entry(w.dtype)
    err = fn(w.data_ptr(), b.data_ptr(), x.data_ptr(), c.data_ptr(),
             h.data_ptr(), c_out.data_ptr(), h_out.data_ptr(), B, D, H,
             x.stride(0), h.stride(0), blocks.block_b, blocks.block_h,
             blocks.k_slices, blocks.smem,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, _NAME, err)
    lstm_cell.launches += 1
    if x.dtype == torch.bfloat16:
        lstm_cell.bf16_launches += 1
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


#: kernel launches since the last reset (CPU calls are not counted), and
#: those of them on the bf16 instance
lstm_cell.launches = lstm_cell.bf16_launches = 0
