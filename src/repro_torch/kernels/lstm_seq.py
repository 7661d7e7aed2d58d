"""Sequence-resident stacked-LSTM forward (K2): host half, wrapper, launch
counter and plain version.

Replaces two Pallas kernels of the JAX package's ``kernels/lstm_seq.py``:
``_seq_kernel`` (launched by ``_lstm_seq_call``) and
``_seq_chunked_kernel`` (launched by ``_lstm_seq_chunked_call``), with ONE
CUDA C++ kernel in ``csrc/lstm_seq.cu``: a persistent thread block per batch
tile runs the whole T x L recurrence in one launch, the ``(L, P+H, 4H)``
weight stack and every layer's ``(c, h)`` resident in shared memory, the
input streamed through a two-slot ring of ``time_chunk`` steps.  What bounds
it on the H100 (the chain of T x L dependent steps, not FLOPs or bytes) and
what the design does about it is written at the top of the CUDA source.

Host half, as in the JAX package: ``stack_params`` and ``pad_input`` build
the kernel's operands; ``working_set_bytes`` and ``choose_batch_block`` are
the budget table, with Hopper's terms and budget
(``factorization.H100_SMEM_PER_BLOCK``) in place of the TPU's VMEM.  When no
tile fits — already at 2 x 64, whose f32 stack alone is 256 KiB —
``choose_batch_block`` returns None and ``core/lstm.forward_fused_seq``
routes to the per-cell kernel with a ``plan/dispatch`` event.

A tensor on the CPU takes ``lstm_seq_plain``; a tensor on the card launches
the kernel or raises.  ``lstm_seq.launches`` counts kernel launches: one per
forward at any T.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build, ref

_NAME = "lstm_seq"

#: Batch tiles the kernel is built for: one kernel instance per size.
TILE_ROWS = (1, 2, 4, 8, 16)
#: Most threads one block of the kernel uses.
MAX_THREADS = 1024
#: Most lanes that share one gate column's dot product.
SPLIT_K = 4
#: Words of padding per weight row in shared memory (bank spreading).
W_ROW_PAD = 8

#: The plain PyTorch version (torch.matmul + elementwise ops, f32 math): the
#: CPU path of ``lstm_seq`` and the yardstick the kernel is held to.
lstm_seq_plain = ref.lstm_seq


# ---------------------------------------------------------------------------
# Parameter stacking — one (L, P+H, 4H) weight block the kernel loads once.
# ---------------------------------------------------------------------------
def stack_params(layers: list[dict], hidden: int
                 ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Stack per-layer cell params to (L, P+H, 4H) / (L, 4H).

    ``layers`` are per-layer dicts with "w" of shape (in_dim_i + H, 4H).
    Rows are rearranged to [input rows | h rows] with the input rows
    zero-padded to P = max(max_i in_dim_i, H), so one shared-memory block
    serves every layer; callers zero-pad the raw input to width P
    (pad_input).  Padding rows multiply padded zeros — exactly equivalent.
    Returns (w_stack, b_stack, P).
    """
    in_dims = [layer["w"].shape[0] - hidden for layer in layers]
    p_width = max(max(in_dims), hidden)
    ws = []
    for layer, in_dim in zip(layers, in_dims):
        w = layer["w"]
        if in_dim < p_width:
            pad = w.new_zeros(p_width - in_dim, 4 * hidden)
            w = torch.cat([w[:in_dim], pad, w[in_dim:]], dim=0)
        ws.append(w)
    return (torch.stack(ws), torch.stack([layer["b"] for layer in layers]),
            p_width)


def pad_input(x: torch.Tensor, p_width: int) -> torch.Tensor:
    """Zero-pad x: (B, T, D) to (B, T, P) to match the stacked weight rows."""
    d = x.shape[-1]
    if d == p_width:
        return x
    return F.pad(x, (0, p_width - d))


# ---------------------------------------------------------------------------
# Shared-memory budget — the MobiRNN packing rule applied to the sequence.
# ---------------------------------------------------------------------------
class SeqBlocks(NamedTuple):
    """The kernel's tiling: batch rows per thread block x time residency.

    ``time_chunk=None`` holds the whole (T, bm, P) input of the tile in one
    ring slot; ``time_chunk=tc`` streams it through two (tc, bm, P) slots."""
    block_b: int
    time_chunk: int | None = None

    @property
    def batch_tile(self) -> int:
        return self.block_b


def gate_parts(hidden: int) -> int:
    """Lanes sharing each of the 4H gate columns: the largest power of
    two up to ``SPLIT_K`` that keeps a block within ``MAX_THREADS``; 0 when
    even one lane per column does not fit (4H > 1024)."""
    parts = SPLIT_K
    while parts and parts * 4 * hidden > MAX_THREADS:
        parts //= 2
    return parts


def working_set_bytes(seq_len: int, n_layers: int, p_width: int, hidden: int,
                      block_b: int, dtype_bytes: int = 4,
                      w_dtype_bytes: int | None = None,
                      time_chunk: int | None = None) -> int:
    """Shared memory of one thread block of the forward kernel.

    Terms (``tiling.WorkingSet``): the weight stack (its rows padded by
    ``W_ROW_PAD`` words) and bias, the x ring (``tiling.streamed_rows``: T
    rows when ``time_chunk`` is None, else 2 x tc), the f32 (c, h) of every
    layer, and the f32 gate buffer (block_b, 4H).  The outputs go straight
    to device memory and take no shared memory.  This is the exact dynamic
    shared memory the kernel is launched with."""
    wb = dtype_bytes if w_dtype_bytes is None else w_dtype_bytes
    ws = tiling.WorkingSet()
    ws.add("weights", n_layers * (p_width + hidden)
           * (4 * hidden + W_ROW_PAD) * wb)
    ws.add("biases", n_layers * 4 * hidden * wb)
    ws.add("x_ring", block_b * tiling.streamed_rows(seq_len, time_chunk)
           * p_width * dtype_bytes)
    ws.add("state", 2 * n_layers * block_b * hidden * 4)
    ws.add("gates", block_b * 4 * hidden * 4)
    return ws.total()


def choose_batch_block(batch: int, seq_len: int, n_layers: int,
                       p_width: int, hidden: int, dtype_bytes: int = 4,
                       smem_budget: int | None = None,
                       w_dtype_bytes: int | None = None) -> SeqBlocks | None:
    """Pick the (batch tile, time residency), or None when not viable.

    A tile is one thread block on one SM, and the recurrence's time is set
    by each block's per-step work, not by how many blocks run, so the batch
    tile starts as small as the card allows: one row per block while the
    batch fits the H100's 132 SMs, then the fewest rows that keep the batch
    in one wave, rounded up to a power of two (``TILE_ROWS``, at most 16) —
    never the TPU's 128-row MXU alignment.  ``tiling.joint_search`` then
    walks the joint ``(block_b, time_chunk)`` surface in MobiRNN coarseness
    order:
    whole-T residency at the current tile, then streamed time chunks from
    T//2 down to 1, then half the tile.  The budget is one thread block's
    shared memory (``smem_budget``, default
    ``factorization.H100_SMEM_PER_BLOCK``).  None means even ``(1, 1)``
    does not fit — the weight stack itself is too large — and the caller
    routes to the per-cell kernel.
    """
    budget = factorization.H100_SMEM_PER_BLOCK if smem_budget is None \
        else smem_budget

    def fits(bm: int, tc: int | None) -> bool:
        return working_set_bytes(seq_len, n_layers, p_width, hidden, bm,
                                 dtype_bytes, w_dtype_bytes,
                                 time_chunk=tc) <= budget

    need = -(-batch // factorization.H100_SMS)
    seed = next((r for r in TILE_ROWS if r >= need), TILE_ROWS[-1])
    found = tiling.joint_search(batch, seq_len, fits, seed_batch_tile=seed)
    return None if found is None else SeqBlocks(*found)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------
def _entry():
    lib = _build.load(_NAME)
    fn = lib.lstm_seq_fwd_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _validate(w, b, x) -> None:
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    if w.dim() != 3 or w.shape[-1] != 4 * H or b.shape != (L, 4 * H) \
            or x.dim() != 3 or x.shape[-1] != P:
        raise ValueError(f"lstm_seq shapes: w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}, x {tuple(x.shape)}")
    for name, t in (("w", w), ("b", b), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_seq takes float32 tensors; {name} is "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"lstm_seq: {name} is on {t.device}, x on "
                             f"{x.device}")


def lstm_seq(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
             block_b: int | None = None, time_chunk: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-sequence stacked LSTM in ONE kernel launch.

    w: (L, P+H, 4H) stacked gate weights (stack_params); b: (L, 4H);
    x: (B, T, P) input zero-padded to width P (pad_input), all float32.
    Returns the final (c, h), each (L, B, H).  Oracle: ref.lstm_seq.

    When ``block_b`` is None the tiling comes from ``choose_batch_block``
    (an explicit ``time_chunk`` still pins the time layout); an explicit
    ``block_b`` is one of ``TILE_ROWS``.  ValueError when
    nothing fits — core/lstm.forward_fused_seq routes that case to the
    per-cell kernel.  ``time_chunk=None`` holds the whole sequence in the
    ring; results are bit-identical for every ``time_chunk``.  The kernel
    reads x through its strides, so a batch-major tensor is read in place.
    """
    _validate(w, b, x)
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    if block_b is None:
        blocks = choose_batch_block(B, T, L, P, H)
        if blocks is None:
            raise ValueError(
                f"sequence-resident working set (L={L}, P+H={P + H}, "
                f"4H={4 * H}) exceeds a thread block's shared memory even at "
                "batch tile 1 with tc=1 time streaming; use the per-cell "
                "kernel (core/lstm.forward_fused_seq routes this)")
        block_b = blocks.block_b
        if time_chunk is None:
            time_chunk = blocks.time_chunk
    if block_b not in TILE_ROWS:
        raise ValueError(f"lstm_seq: block_b must be one of {TILE_ROWS}, "
                         f"not {block_b}")
    if x.device.type == "cpu":
        return lstm_seq_plain(w, b, x)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_seq runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w, b, x)):
        raise RuntimeError("the lstm_seq CUDA kernel has no backward yet; "
                           "call it under torch.no_grad()/inference_mode()")
    if x.stride(-1) != 1:
        raise ValueError("lstm_seq: x needs a contiguous last dim")
    tc = T if time_chunk is None else max(1, min(time_chunk, T))
    smem = working_set_bytes(T, L, P, H, block_b,
                             time_chunk=None if tc == T else tc)
    if smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"lstm_seq: tile ({block_b}, {tc}) needs {smem} "
                         "bytes of shared memory, above a thread block's "
                         f"{factorization.H100_SMEM_PER_BLOCK}")
    parts = gate_parts(H)
    if parts == 0:
        raise ValueError(f"lstm_seq: 4H = {4 * H} gate columns exceed "
                         f"{MAX_THREADS} threads")
    threads = factorization.round_up(parts * 4 * H, factorization.WARP)
    w, b = w.contiguous(), b.contiguous()
    c_out = x.new_empty(L, B, H)
    h_out = x.new_empty(L, B, H)
    lib, fn = _entry()
    err = fn(w.data_ptr(), b.data_ptr(), x.data_ptr(), c_out.data_ptr(),
             h_out.data_ptr(), B, T, L, P, H, x.stride(0), x.stride(1),
             block_b, tc, parts, threads, smem,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, _NAME, err)
    lstm_seq.launches += 1
    return c_out, h_out


#: kernel launches since the last reset (CPU calls are not counted)
lstm_seq.launches = 0
