"""Sequence-resident stacked-LSTM forward (K2, K2t, and their int8 twins
K5 and K2t-q8): host half, wrappers, launch counters, plain versions and
the differentiable entry points.

Replaces eight Pallas kernels of the JAX package's ``kernels/lstm_seq.py``:
``_seq_kernel`` (launched by ``_lstm_seq_call``), ``_seq_chunked_kernel``
(``_lstm_seq_chunked_call``), their trajectory-writing twins
``_seq_traj_kernel`` (``_lstm_seq_traj_call``) and
``_seq_traj_chunked_kernel`` (``_lstm_seq_traj_chunked_call``), and the
int8-weight bodies of all four (``_seq_q8_kernel``,
``_seq_chunked_q8_kernel``, ``_seq_traj_q8_kernel``,
``_seq_traj_chunked_q8_kernel``), with ONE CUDA C++ kernel in
``csrc/lstm_seq.cu``: a persistent thread block per batch tile runs the
whole recurrence in one launch as a layer wavefront (each layer its own
warps, layer l at time s - l in wave-step s, one barrier a wave-step, T + L
- 1 wave-steps), each hidden unit's four gates in one warp quad with c in a
register, the input streamed through a two-slot ring of ``time_chunk``
steps; its trajectory instance (``lstm_seq_traj``) also writes the (T, L,
B, H) f32 post-step states, and its int8 instances (``lstm_seq_q8``,
``lstm_seq_q8_traj``) take the stack as int8 codes with (L, 4H) f32
per-column scales, folded into the gate pre-activations.  Each is built for
the (stack, input) dtypes of ``INSTANCES``: f32/f32, bf16/bf16 (a bf16
stack, bias and input, widened to f32 as they are read; the state and the
trajectories stay f32 and only the final (c, h) are written in bf16), and
int8/f32 and int8/bf16 (the q8 plan of a bf16 model, as the JAX package
feeds bf16 x to its q8 kernel).  What bounds it on
the H100 (the chain of dependent steps, not FLOPs or bytes) and what the
design does about it is written at the top of the CUDA source.

Autograd: ``lstm_seq`` on tensors that require grad runs ``_LstmSeqFn``,
the counterpart of the JAX package's ``custom_vjp``.  Its forward is the
trajectory launch at the backward's tiling and its backward is the
reverse-time sweep of ``kernels/lstm_seq_bwd.py``: a training step is two
launches at any T.  ``lstm_seq_q8`` takes the f32 MASTER stack and runs
``_LstmSeqQ8Fn``, which quantizes inside its forward (``ref.quantize_q8``)
and returns the q8 backward's f32 dw to the master unchanged
(straight-through).  When ``choose_batch_block(mode="bwd")`` finds no tiling
(``ORACLE_BWD``), a CPU call is autograd of ``ref.lstm_seq`` (over
``ref.quantize_dequantize_ste`` weights for q8), the JAX package's own
decision table, named by a ``plan/dispatch`` event; a CUDA call raises, and
``core/lstm`` trains such widths on the per-cell kernel.  Without grad,
each is one plain launch and writes no trajectories.

Host half, as in the JAX package: ``stack_params`` and ``pad_input`` build
the kernel's operands; ``working_set_bytes`` and ``choose_batch_block`` are
the budget table, with Hopper's terms and budget
(``factorization.H100_SMEM_PER_BLOCK``) in place of the TPU's VMEM, and
``weight_home`` names where a launch keeps its weights: in registers (the
paper's 2 x 32 at one row a block) or in shared memory.  When no tile fits
— already at 2 x 64, whose f32 stack alone is 256 KiB —
``choose_batch_block`` returns None and ``core/lstm`` routes to the
per-cell kernel with a ``plan/dispatch`` event; the int8 stack at 2 x 64 is
68 KiB and fits (``quantized=True``).  The budget functions are pure
functions of integers and are memoised.

A tensor on the CPU takes the plain versions (``lstm_seq_plain``,
``ref.lstm_seq_traj``, ``lstm_seq_q8_plain``, ``lstm_seq_q8_traj_plain``),
through the same autograd wiring; a tensor on the card launches the kernel
or raises.  Each wrapper counts its launches (CPU calls are not counted):
``lstm_seq.launches`` and ``lstm_seq_q8.launches`` plain launches (one per
inference forward at any T), ``lstm_seq_traj.launches`` and
``lstm_seq_q8_traj.launches`` trajectory launches (one per training
forward); each also counts in ``reg_launches`` the launches whose weights
were in registers (``weight_home``) and in ``bf16_launches`` those on a
bf16 input (the bf16/bf16 and int8/bf16 instances).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build, called, meta_like, ref
from repro_torch.obs import trace as trace_lib

_NAME = "lstm_seq"
F32 = torch.float32

#: Batch tiles the kernel is built for: one kernel instance per size.
TILE_ROWS = (1, 2, 4, 8, 16)
#: Most threads one block of either kernel uses.
MAX_THREADS = 1024
#: Most lanes that share one gate column's dot product in the backward.
SPLIT_K = 4
#: Words of padding per f32 weight row in shared memory (bank spreading).
W_ROW_PAD = 8
#: Hidden units a warp of the forward owns: 8 units x 4 gates = 32 lanes.
UNITS_PER_WARP = 8
#: The register-resident forward instance: H = P = 32, at most 2 layers
#: (``REG_THREADS`` threads), one row a block.
REG_HIDDEN = 32
REG_MAX_LAYERS = 2
REG_THREADS = 256
#: The register-home backward (the wavefront of ``csrc/lstm_seq_bwd.cu``):
#: threads a layer (four chain warps and four worker warps) and the
#: trajectory rows of its ring.
BWD_REG_THREADS = 256
BWD_RING = 16
#: steps a block of the register-home backward's closing dW pass stages
BWD_STAGE = 32

#: The plain PyTorch version (torch.matmul + elementwise ops, f32 math): the
#: CPU path of ``lstm_seq`` and the yardstick the kernel is held to.
lstm_seq_plain = ref.lstm_seq


def _q8_recurrence(wq: torch.Tensor, scales: torch.Tensor, b: torch.Tensor,
                   x: torch.Tensor, traj: bool):
    """The int8 instances' arithmetic in plain PyTorch: the codes as f32,
    each column's scale folded in after the products and before the bias,
    ``(inp @ wq[:P] + h @ wq[P:]) * s + b`` — as the kernels and the JAX
    package's ``_step_layers`` do, not a dequantized stack."""
    L, H = wq.shape[0], wq.shape[-1] // 4
    P = wq.shape[1] - H
    B, T, _ = x.shape
    wf, s32, b32 = wq.to(F32), scales.to(F32), b.to(F32)
    c = [x.new_zeros(B, H, dtype=F32) for _ in range(L)]
    h = [x.new_zeros(B, H, dtype=F32) for _ in range(L)]
    cs, hs = [], []
    for t in range(T):
        inp = x[:, t].to(F32)
        for l in range(L):
            gates = (inp @ wf[l, :P] + h[l] @ wf[l, P:]) * s32[l] + b32[l]
            i, f, g, o = gates.chunk(4, dim=-1)
            c[l] = torch.sigmoid(f) * c[l] + torch.sigmoid(i) * torch.tanh(g)
            h[l] = torch.sigmoid(o) * torch.tanh(c[l])
            inp = F.pad(h[l], (0, P - H)) if P > H else h[l]
        if traj:
            cs.append(torch.stack(c))
            hs.append(torch.stack(h))
    out = (torch.stack(c).to(x.dtype), torch.stack(h).to(x.dtype))
    return out + (torch.stack(cs), torch.stack(hs)) if traj else out


def lstm_seq_q8_plain(wq: torch.Tensor, scales: torch.Tensor,
                      b: torch.Tensor, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the q8 forward: the CPU path of
    ``lstm_seq_q8`` and the yardstick its kernel is held to at
    ``LSTM_TOL``.  wq: (L, P+H, 4H) int8 codes; scales: (L, 4H) f32.
    ``ref.lstm_seq_q8`` (dequantize, then run) is the separate oracle."""
    return _q8_recurrence(wq, scales, b, x, traj=False)


def lstm_seq_q8_traj_plain(wq: torch.Tensor, scales: torch.Tensor,
                           b: torch.Tensor, x: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """``lstm_seq_q8_plain`` with the (T, L, B, H) f32 trajectories: the
    plain version of the q8 trajectory launch."""
    return _q8_recurrence(wq, scales, b, x, traj=True)


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


@functools.lru_cache(maxsize=None)
def gate_parts(hidden: int) -> int:
    """Lanes sharing each of the 4H gate columns in the backward kernel: the
    largest power of two up to ``SPLIT_K`` that keeps a block within
    ``MAX_THREADS``; 0 when even one lane per column does not fit (4H >
    1024).  (The forward runs one lane a column.)"""
    parts = SPLIT_K
    while parts and parts * 4 * hidden > MAX_THREADS:
        parts //= 2
    return parts


@functools.lru_cache(maxsize=None)
def fwd_threads(n_layers: int, hidden: int) -> int:
    """Threads of one forward block: each layer's own warps, a warp to
    ``UNITS_PER_WARP`` hidden units (4 gate lanes each)."""
    return n_layers * -(-hidden // UNITS_PER_WARP) * factorization.WARP


@functools.lru_cache(maxsize=None)
def weight_home(n_layers: int, p_width: int, hidden: int,
                block_b: int) -> str:
    """Where a forward launch keeps its weight stack: ``"registers"`` (each
    lane's 64 weights, int8 codes converted once to f32) for the paper's
    width — H = P = ``REG_HIDDEN``, at most ``REG_MAX_LAYERS`` layers, one
    row a block, the tile of B=1 serving and of B=64 training — and
    ``"shared"`` (padded shared rows, ``row_stride``) for every other
    shape, whose lanes would need more registers than a thread has at
    their block's size."""
    if (hidden == REG_HIDDEN and p_width == hidden
            and n_layers <= REG_MAX_LAYERS and block_b == 1):
        return "registers"
    return "shared"


def fwd_max_threads(block_b: int, home: str) -> int:
    """Most threads the forward instance for ``block_b`` rows and ``home``
    launches with (its ``__launch_bounds__``: 255 registers a thread at
    ``REG_THREADS``, 128 at 512, 64 at 1024)."""
    if home == "registers":
        return REG_THREADS
    return 512 if block_b >= 8 else MAX_THREADS


@functools.lru_cache(maxsize=None)
def row_stride(hidden: int, w_bytes: int = 4) -> int:
    """Elements per weight row in shared memory (``row_stride`` of
    ``csrc/lstm_gates.cuh``).  f32 rows are 4H + ``W_ROW_PAD`` words.  int8
    rows are 4H rounded up to 16 bytes, plus 16 when that is a multiple of
    64; bf16 rows 4H rounded up to 8 elements (16 bytes), plus 16 when that
    is a multiple of 32 elements: row starts stay 16-byte aligned for the
    16-byte copies, and the rows a warp reads at once fall into distinct
    banks."""
    g = 4 * hidden
    if w_bytes == 1:
        s = factorization.round_up(g, 16)
        return s + 16 if s % 64 == 0 else s
    if w_bytes == 2:
        s = factorization.round_up(g, 8)
        return s + 16 if s % 32 == 0 else s
    return g + W_ROW_PAD


@functools.lru_cache(maxsize=None)
def working_set_bytes(seq_len: int, n_layers: int, p_width: int, hidden: int,
                      block_b: int, dtype_bytes: int = 4,
                      w_dtype_bytes: int | None = None, mode: str = "fwd",
                      time_chunk: int | None = None,
                      quantized: bool = False) -> int:
    """Shared memory of one thread block, per phase: the exact dynamic
    shared memory each kernel is launched with.

    ``mode="fwd"`` sizes the forward kernel (``csrc/lstm_seq.cu``; the
    trajectory launch adds nothing, its trajectories go straight from
    registers to device memory).  Terms (``tiling.WorkingSet``): the weight
    stack, its rows padded to ``row_stride`` and each segment's rows (P
    input, H recurrent) to a multiple of 4, when ``weight_home`` keeps it
    in shared memory (nothing when it is in registers), ``w_dtype_bytes``
    a weight (default ``dtype_bytes``); the f32 h of every layer in two
    slots (t mod 2); the x ring (``tiling.streamed_rows``: T rows when
    ``time_chunk`` is None, else 2 x tc) in the input's dtype,
    ``dtype_bytes`` an element; h and x rows padded to a multiple of 4
    elements; and on the register home with bf16 x an f32 copy of the
    chunk in use (T rows, or tc), which its layer 0 reads.  Bias, scales,
    c and the gates live in registers; layer 0's input product is formed a
    step ahead in registers, so it needs no buffer.

    ``mode="bwd"`` sizes the backward (``csrc/lstm_seq_bwd.cu``).  Where
    ``weight_home`` is ``"registers"`` (the paper's 2 x 32 at one row a
    block) it is the wavefront kernel, whose lanes keep the weights in
    registers and whose ring does not depend on T or ``time_chunk``:
    ``BWD_RING`` trajectory rows of (c, h) of every layer and x
    (``ring``), and two parity slots of the activations (L, 4H), tanh(c)
    (L, H), dg (L, 4H), dh_prev (L, H) and dinp (L, P), plus dg * s (L, 4H)
    for int8 (``slots``), and the dW pass's two stages of ``BWD_STAGE`` + 1
    rows of dg (L, 4H), h (L, H) and x (P) (``dw_stage``), all f32.
    Elsewhere it is the shared-home kernel:
    the stack (``w_dtype_bytes`` a weight) and the f32 bias (and scales),
    the x ring, widened to f32 as it is copied in, its (dc, dh) carries, its
    gate buffer (block_b, 4H), the f32 dW/db accumulators (dW rows padded as
    W's), the two f32 trajectory windows (T + 1 rows, one of them the zero
    state before t = 0, when ``time_chunk`` is None; else 2 slots of
    ``tiling.bwd_window_rows`` = tc + 1), the gate-gradient buffer
    (block_b, 4H) and the layer-below input gradient (block_b, H).  dx, dw
    and db go straight to device memory.  ``choose_batch_block`` holds a
    backward tiling to the forward's bytes and threads as well, so it also
    fits the trajectory launch that feeds it.

    In ``bwd`` every term but the stack is f32 whatever the dtypes: the
    backward widens a bf16 bias, x and cotangents as it reads them.

    ``quantized=True`` sizes the int8 instances (the ``fused_seq_q8``
    plan): the stack is 1 byte a weight (``tiling.weight_dtype_bytes``), its
    rows padded in bytes (``row_stride``); in ``bwd`` the (L, 4H) f32
    scales sit beside the bias, the dW/db accumulators stay f32
    and the outgoing products read their own (block_b, 4H) f32 copy of the
    gate gradients times the scales.  The JAX table's "active-layer dequant
    temporary" has no counterpart: the kernels convert each int8 code to f32
    in a register and keep no f32 slab of the stack in shared memory."""
    wb = tiling.weight_dtype_bytes(dtype_bytes, w_dtype_bytes, quantized)
    ws = tiling.WorkingSet(mode)
    w_rows = n_layers * (p_width + hidden)
    rows = tiling.streamed_rows(seq_len, time_chunk)
    if mode == "fwd":
        p4 = factorization.round_up(p_width, 4)
        h4 = factorization.round_up(hidden, 4)
        home = weight_home(n_layers, p_width, hidden, block_b)
        if home == "shared":
            ws.add("weights", n_layers * (p4 + h4) * row_stride(hidden, wb)
                   * wb)
        ws.add("h_slots", 2 * n_layers * block_b * h4 * 4)
        if home == "registers" and dtype_bytes == 2:
            chunk = seq_len if time_chunk is None else min(time_chunk,
                                                           seq_len)
            ws.add("x_widened", block_b * chunk * p4 * 4)
        ws.add("x_ring", block_b * rows * p4 * dtype_bytes)
        return ws.total()
    if weight_home(n_layers, p_width, hidden, block_b) == "registers":
        g = 4 * hidden
        ws.add("ring", BWD_RING * (2 * n_layers * hidden + p_width) * 4)
        ws.add("slots", 2 * n_layers * (2 * g + 2 * hidden + p_width
                                        + (g if quantized else 0)) * 4)
        ws.add("dw_stage", 2 * (BWD_STAGE + 1)
               * (n_layers * (g + hidden) + p_width) * 4)
        return ws.total()
    x_ring = block_b * rows * p_width * 4
    state = 2 * n_layers * block_b * hidden * 4
    ws.add("weights", w_rows * row_stride(hidden, wb) * wb)
    ws.add("biases", n_layers * 4 * hidden * 4)
    if quantized:
        ws.add("scales", n_layers * 4 * hidden * 4)
    ws.add("x_ring", x_ring)
    ws.add("state", state)
    ws.add("gates", block_b * 4 * hidden * 4)
    ws.add("grad_accumulators",
           (w_rows * row_stride(hidden) + n_layers * 4 * hidden) * 4)
    if time_chunk is None:
        traj_rows = seq_len + 1
    else:
        traj_rows = tiling.STREAM_SLOTS * tiling.bwd_window_rows(
            seq_len, time_chunk)
    ws.add("traj", 2 * traj_rows * n_layers * block_b * hidden * 4)
    ws.add("dgates", block_b * 4 * hidden * 4)
    ws.add("dinp", block_b * hidden * 4)
    if quantized:
        ws.add("dgates_scaled", block_b * 4 * hidden * 4)
    return ws.total()


@functools.lru_cache(maxsize=None)
def choose_batch_block(batch: int, seq_len: int, n_layers: int,
                       p_width: int, hidden: int, dtype_bytes: int = 4,
                       smem_budget: int | None = None,
                       w_dtype_bytes: int | None = None,
                       mode: str = "fwd",
                       quantized: bool = False) -> SeqBlocks | None:
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
    ``factorization.H100_SMEM_PER_BLOCK``), and a forward block's threads
    (``fwd_threads``) must be within its instance's bound
    (``fwd_max_threads``: a layer wavefront needs every layer's warps at
    once, so L x ceil(H / 8) warps; e.g. 9 x 32 or 5 x 64 fit no block).

    ``mode="bwd"`` sizes the training kernels (``working_set_bytes``), so a
    tiling fine for inference can be none for training; the trajectory
    launch runs at the tiling found, so the forward's bytes and threads
    must fit there too.  None means even ``(1, 1)`` does not fit — the weight stack
    (plus, for ``bwd``, its gradient accumulators) is too large — and
    ``core/lstm.forward_fused_seq`` routes to the per-cell kernel.
    ``quantized=True`` sizes the int8 instances (``working_set_bytes``):
    with the stack quartered, they fit where the f32 ones do not (2 x 64,
    3 x 64 and 2 x 96 forward), and are never tiled finer.  The bf16
    instances (``dtype_bytes=2``, ``w_dtype_bytes=2``) halve the stack and
    the x ring: their forward fits 2 x 64 and 3 x 64 in one block, their
    backward, whose f32 dW accumulators alone are 256 KiB there, does not.
    """
    budget = factorization.H100_SMEM_PER_BLOCK if smem_budget is None \
        else smem_budget

    threads = fwd_threads(n_layers, hidden)

    def fits(bm: int, tc: int | None) -> bool:
        home = weight_home(n_layers, p_width, hidden, bm)
        modes = ("fwd",) if mode == "fwd" else ("fwd", "bwd")
        return threads <= fwd_max_threads(bm, home) and all(
            working_set_bytes(seq_len, n_layers, p_width, hidden, bm,
                              dtype_bytes, w_dtype_bytes, mode=m,
                              time_chunk=tc, quantized=quantized) <= budget
            for m in modes)

    need = -(-batch // factorization.H100_SMS)
    seed = next((r for r in TILE_ROWS if r >= need), TILE_ROWS[-1])
    found = tiling.joint_search(batch, seq_len, fits, seed_batch_tile=seed)
    return None if found is None else SeqBlocks(*found)


#: bwd spec sentinel: "no viable backward tiling — autograd of the oracle",
#: which only a CPU call takes; a CUDA call raises instead.
ORACLE_BWD = 0


def recorded(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _bytes(w: torch.Tensor, x: torch.Tensor) -> dict:
    """The budget table's dtype keywords for a launch on ``w`` and ``x``:
    the input's bytes an element, and the stack's (an int8 stack is
    ``quantized=True``)."""
    q8 = w.dtype == torch.int8
    return dict(dtype_bytes=x.element_size(),
                w_dtype_bytes=None if q8 else w.element_size(),
                quantized=q8)


def _fwd_spec(B: int, T: int, L: int, P: int, H: int, block_b: int | None,
              time_chunk: int | None, **dtypes) -> tuple[int, int | None]:
    """The forward's ``(block_b, time_chunk)``: explicit tiles pin the
    layout, otherwise ``choose_batch_block`` searches (an explicit
    ``time_chunk`` survives an automatic ``block_b``); ``dtypes`` are
    ``_bytes``'s keywords."""
    if block_b is None:
        blocks = choose_batch_block(B, T, L, P, H, **dtypes)
        if blocks is None:
            raise ValueError(
                f"sequence-resident working set (L={L}, P+H={P + H}, "
                f"4H={4 * H}, {dtypes}) exceeds a thread "
                "block's shared memory even at batch tile 1 with tc=1 time "
                "streaming; use the per-cell kernel (core/lstm routes this)")
        block_b = blocks.block_b
        if time_chunk is None:
            time_chunk = blocks.time_chunk
    if block_b not in TILE_ROWS:
        raise ValueError(f"lstm_seq: block_b must be one of {TILE_ROWS}, "
                         f"not {block_b}")
    return block_b, time_chunk


def _resolve_specs(B: int, T: int, L: int, P: int, H: int, *,
                   bwd_block_b: int | None, bwd_time_chunk: int | None,
                   device: torch.device, **dtypes
                   ) -> tuple[int, int | None] | int:
    """The ``(block_b, time_chunk)`` of a call autograd records, for the
    backward launch and the trajectory launch that feeds it.

    An explicit ``bwd_block_b`` (one of ``TILE_ROWS``) pins the layout;
    otherwise ``choose_batch_block(mode="bwd")`` searches (an explicit
    ``bwd_time_chunk`` survives).  When nothing
    fits, a CPU call gets ``ORACLE_BWD`` — autograd of ``ref.lstm_seq``, the
    JAX package's decision table — and a CUDA call a ValueError naming the
    working set: on the card no plain version takes a kernel's place
    (``core/lstm`` trains such widths on ``fused_cell``).  ``dtypes``
    (``_bytes``'s keywords) size the bf16 and int8 backwards."""
    if bwd_block_b is not None:
        if bwd_block_b not in TILE_ROWS:
            raise ValueError(f"lstm_seq: bwd_block_b must be one of "
                             f"{TILE_ROWS}, not {bwd_block_b}")
        return bwd_block_b, bwd_time_chunk
    blocks = choose_batch_block(B, T, L, P, H, mode="bwd", **dtypes)
    if blocks is not None:
        return (blocks.block_b, blocks.time_chunk if bwd_time_chunk is None
                else bwd_time_chunk)
    if device.type == "cpu":
        return ORACLE_BWD
    need = working_set_bytes(T, L, P, H, 1, mode="bwd", time_chunk=1,
                             **dtypes)
    raise ValueError(
        f"lstm_seq backward: working set of {need} bytes at batch tile 1 "
        f"with tc=1 (L={L}, P+H={P + H}, 4H={4 * H}, {dtypes})"
        " exceeds a thread "
        f"block's {factorization.H100_SMEM_PER_BLOCK} bytes of shared "
        "memory; train this width on the per-cell kernel "
        "(core/lstm.forward_fused_seq routes it)")


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
#: (stack, bias, input) dtypes of the instances the kernel is built for;
#: an int8 stack comes with (L, 4H) float32 scales
INSTANCES = ((torch.float32, torch.float32, torch.float32),
             (torch.bfloat16, torch.bfloat16, torch.bfloat16),
             (torch.int8, torch.float32, torch.float32),
             (torch.int8, torch.float32, torch.bfloat16))


def _entry(w_dtype: torch.dtype, io_dtype: torch.dtype):
    lib = _build.load(_NAME)
    fn = getattr(lib, "lstm_seq_fwd_" + {
        (torch.float32, torch.float32): "f32",
        (torch.bfloat16, torch.bfloat16): "bf16",
        (torch.int8, torch.float32): "q8",
        (torch.int8, torch.bfloat16): "q8_bf16"}[w_dtype, io_dtype])
    if fn.argtypes is None:
        q8 = w_dtype == torch.int8
        fn.argtypes = ([ctypes.c_void_p] * (8 if q8 else 7)
                       + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _validate(w, b, x, scales=None, w_dtype=None) -> None:
    """Shapes, dtypes and devices of the operands: one of ``INSTANCES``
    (float32 throughout, bfloat16 throughout, or an int8 stack ``w`` with
    its (L, 4H) float32 ``scales`` and bias over a float32 or bfloat16
    input).  ``w_dtype`` names the stack's dtype at the launch when the
    call quantizes a float32 master ``w`` first (``lstm_seq_q8``)."""
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    if w.dim() != 3 or w.shape[-1] != 4 * H or b.shape != (L, 4 * H) \
            or x.dim() != 3 or x.shape[-1] != P \
            or (scales is not None and scales.shape != (L, 4 * H)):
        raise ValueError(f"lstm_seq shapes: w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}, x {tuple(x.shape)}, scales "
                         f"{None if scales is None else tuple(scales.shape)}")
    if scales is not None and w.dtype != torch.int8:
        raise TypeError(f"the q8 kernels take an int8 stack; w is {w.dtype}")
    if w_dtype is not None and w.dtype != torch.float32:
        raise TypeError(f"lstm_seq_q8 takes a float32 master stack; w is "
                        f"{w.dtype}")
    if (w.dtype == torch.int8) != (scales is not None) \
            or (scales is not None and scales.dtype != torch.float32) \
            or (w_dtype or w.dtype, b.dtype, x.dtype) not in INSTANCES:
        raise TypeError(
            f"lstm_seq has no instance for w {w.dtype}, b {b.dtype}, x "
            f"{x.dtype}, scales {None if scales is None else scales.dtype}"
            f"; it takes (w, b, x) {[tuple(map(str, i)) for i in INSTANCES]}"
            " (int8 with float32 scales)")
    for name, t in (("w", w), ("b", b), ("scales", scales)):
        if t is not None and t.device != x.device:
            raise ValueError(f"lstm_seq: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"lstm_seq runs on cpu or cuda, not {x.device}")


def _no_autograd(name: str, *tensors: torch.Tensor) -> None:
    """A kernel's output carries no graph, so a CUDA call that autograd
    would record raises instead of dropping the gradient."""
    if recorded(*tensors):
        raise RuntimeError(f"{name} on CUDA tensors is not differentiable by "
                           "itself; call lstm_seq (or lstm_seq_q8), whose "
                           "autograd Function pairs it with the backward "
                           "kernel")


def _launch(w, b, x, block_b: int, time_chunk: int | None, traj: bool,
            scales: torch.Tensor | None = None):
    """One launch of the forward kernel, with or without trajectories: the
    instance of ``w``'s and ``x``'s dtypes (``INSTANCES``; int8 with
    ``scales``).  The weight home, the threads and the shared memory come
    from the (memoised) budget table."""
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    if x.stride(-1) != 1:
        raise ValueError("lstm_seq: x needs a contiguous last dim")
    tc = T if time_chunk is None else max(1, min(time_chunk, T))
    q8 = scales is not None
    smem = working_set_bytes(T, L, P, H, block_b,
                             time_chunk=None if tc == T else tc,
                             **_bytes(w, x))
    if smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"lstm_seq: tile ({block_b}, {tc}) needs {smem} "
                         "bytes of shared memory, above a thread block's "
                         f"{factorization.H100_SMEM_PER_BLOCK}")
    home = weight_home(L, P, H, block_b)
    threads = fwd_threads(L, H)
    if threads > fwd_max_threads(block_b, home):
        raise ValueError(f"lstm_seq: {L} layers of {H} hidden units need "
                         f"{threads} threads a block, above the "
                         f"{fwd_max_threads(block_b, home)} of the "
                         f"{block_b}-row instance")
    w, b = w.contiguous(), b.contiguous()
    scales = None if scales is None else scales.contiguous()
    c_out = x.new_empty(L, B, H)
    h_out = x.new_empty(L, B, H)
    if traj:                  # the trajectories are f32 for every dtype
        c_traj = x.new_empty(T, L, B, H, dtype=F32)
        h_traj = x.new_empty(T, L, B, H, dtype=F32)
        traj_ptrs = (c_traj.data_ptr(), h_traj.data_ptr())
    else:
        traj_ptrs = (None, None)
    lib, fn = _entry(w.dtype, x.dtype)
    w_ptrs = (w.data_ptr(), scales.data_ptr()) if q8 else (w.data_ptr(),)
    err = fn(*w_ptrs, b.data_ptr(), x.data_ptr(), c_out.data_ptr(),
             h_out.data_ptr(), *traj_ptrs, B, T, L, P, H, x.stride(0),
             x.stride(1), block_b, tc, int(home == "registers"), threads,
             smem, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, _NAME, err)
    if traj:
        return c_out, h_out, c_traj, h_traj
    return c_out, h_out


def _meta_out(w: torch.Tensor, x: torch.Tensor, traj: bool) -> tuple:
    """A forward's outputs on ``meta``: (c, h) (L, B, H) in x's dtype,
    with ``traj`` also the (T, L, B, H) f32 trajectories."""
    L, H = w.shape[0], w.shape[-1] // 4
    B, T, _ = x.shape
    outs = [((L, B, H), x.dtype)] * 2
    if traj:
        outs += [((T, L, B, H), torch.float32)] * 2
    return meta_like(*outs)


def _count(wrapper, w: torch.Tensor, x: torch.Tensor, block_b: int) -> None:
    """One launch of ``wrapper``'s kernel: ``launches``, ``reg_launches``
    when its weights were in registers, and ``bf16_launches`` when its
    input was bf16."""
    H = w.shape[-1] // 4
    wrapper.launches += 1
    if weight_home(w.shape[0], w.shape[1] - H, H, block_b) == "registers":
        wrapper.reg_launches += 1
    if x.dtype == torch.bfloat16:
        wrapper.bf16_launches += 1


def _forward(w, b, x, block_b: int, time_chunk: int | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain forward at a resolved tiling: its plain version on the
    CPU, one kernel launch on the card."""
    called("lstm_seq", -(-x.shape[0] // block_b))
    if x.device.type == "meta":
        return _meta_out(w, x, traj=False)
    if x.device.type == "cpu":
        return lstm_seq_plain(w, b, x)
    _no_autograd("the lstm_seq kernel", w, b, x)
    out = _launch(w, b, x, block_b, time_chunk, traj=False)
    _count(lstm_seq, w, x, block_b)
    return out


def lstm_seq_traj(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
                  block_b: int | None = None, time_chunk: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The trajectory-writing forward in ONE launch: (c, h, c_traj, h_traj).

    Same operands and tiling as ``lstm_seq``; ``c_traj``/``h_traj`` are
    the (T, L, B, H) f32 post-step states, bit-identical for every
    ``time_chunk``, and (c, h) equal the plain launch's to the bit.
    Oracle: ``ref.lstm_seq_traj``.  Not differentiable by itself (it is
    the forward half of ``lstm_seq``'s autograd Function)."""
    _validate(w, b, x)
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    block_b, time_chunk = _fwd_spec(B, T, L, P, H, block_b, time_chunk,
                                    **_bytes(w, x))
    called("lstm_seq_traj", -(-x.shape[0] // block_b))
    if x.device.type == "meta":
        return _meta_out(w, x, traj=True)
    if x.device.type == "cpu":
        return ref.lstm_seq_traj(w, b, x)
    _no_autograd("lstm_seq_traj", w, b, x)
    out = _launch(w, b, x, block_b, time_chunk, traj=True)
    _count(lstm_seq_traj, w, x, block_b)
    return out


class _LstmSeqFn(torch.autograd.Function):
    """``lstm_seq`` under autograd: the trajectory launch forward and the
    reverse-sweep launch backward, both at ``bwd_spec``.  On the CPU the
    wrappers take their plain versions, so this wiring runs there too."""

    @staticmethod
    def forward(ctx, w, b, x, bwd_spec):
        block_b, time_chunk = bwd_spec
        c, h, c_traj, h_traj = lstm_seq_traj(w, b, x, block_b=block_b,
                                             time_chunk=time_chunk)
        ctx.bwd_spec = bwd_spec
        ctx.save_for_backward(w, b, x, c_traj, h_traj)
        return c, h

    @staticmethod
    def backward(ctx, dc, dh):
        from repro_torch.kernels import lstm_seq_bwd as bwd_lib
        w, b, x, c_traj, h_traj = ctx.saved_tensors
        block_b, time_chunk = ctx.bwd_spec
        dw, db, dx = bwd_lib.lstm_seq_bwd(w, b, x, c_traj, h_traj, dc, dh,
                                          block_b=block_b,
                                          time_chunk=time_chunk)
        return dw, db, dx if ctx.needs_input_grad[2] else None, None


def lstm_seq(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
             block_b: int | None = None, time_chunk: int | None = None,
             bwd_block_b: int | None = None,
             bwd_time_chunk: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-sequence stacked LSTM in ONE kernel launch.

    w: (L, P+H, 4H) stacked gate weights (stack_params); b: (L, 4H);
    x: (B, T, P) input zero-padded to width P (pad_input), all float32 or
    all bfloat16.  Returns the final (c, h), each (L, B, H) in x's dtype.
    Oracle: ref.lstm_seq.  A bfloat16 call runs the kernel's bf16
    instance: every product and the state in f32 (bf16 widens to f32
    exactly), only the final (c, h) rounded to bf16, as the JAX package's
    kernel does; its gradients come back in bf16.

    When ``block_b`` is None the tiling comes from ``choose_batch_block``
    (an explicit ``time_chunk`` still pins the time layout); an explicit ``block_b`` is one of ``TILE_ROWS``.  ValueError
    when nothing fits — core/lstm.forward_fused_seq routes that case to the
    per-cell kernel.  ``time_chunk=None`` holds the whole sequence in the
    ring; results are bit-identical for every ``time_chunk``.  The kernel
    reads x through its strides, so a batch-major tensor is read in place.

    When autograd records the call (grad enabled and an input requires
    grad), ``_LstmSeqFn`` runs it at the tiling ``_resolve_specs`` gives
    (``bwd_block_b``/``bwd_time_chunk``, default
    ``choose_batch_block(mode="bwd")``; ``block_b``/``time_chunk`` are not
    used): the trajectory launch, then the backward kernel.  Where no
    backward tiling fits, a CPU call is autograd of ``ref.lstm_seq``, named
    by a ``plan/dispatch`` event with ``fallback="oracle_bwd"``, and a CUDA
    call raises ValueError.
    """
    _validate(w, b, x)
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    if recorded(w, b, x):
        bwd_spec = _resolve_specs(B, T, L, P, H, bwd_block_b=bwd_block_b,
                                  bwd_time_chunk=bwd_time_chunk,
                                  device=x.device, **_bytes(w, x))
        if bwd_spec != ORACLE_BWD:
            return _LstmSeqFn.apply(w, b, x, bwd_spec)
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("plan/dispatch", family="lstm", plan="lstm_seq",
                         fallback="oracle_bwd", bwd_block_b=ORACLE_BWD,
                         batch=B, seq_len=T)
        return ref.lstm_seq(w, b, x)
    return _forward(w, b, x, *_fwd_spec(B, T, L, P, H, block_b, time_chunk,
                                        **_bytes(w, x)))


#: plain launches since the last reset (CPU calls are not counted), those
#: of them on the register weight home, and those on a bf16 input
lstm_seq.launches = lstm_seq.reg_launches = lstm_seq.bf16_launches = 0
#: trajectory launches since the last reset (CPU calls are not counted)
lstm_seq_traj.launches = lstm_seq_traj.reg_launches = 0
lstm_seq_traj.bf16_launches = 0


# ---------------------------------------------------------------------------
# The int8-weight plan (``fused_seq_q8``)
# ---------------------------------------------------------------------------
def lstm_seq_q8_traj(wq: torch.Tensor, scales: torch.Tensor, b: torch.Tensor,
                     x: torch.Tensor, *, block_b: int | None = None,
                     time_chunk: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The q8 trajectory-writing forward in ONE launch: (c, h, c_traj,
    h_traj), the trajectories f32 (T, L, B, H) as the f32 launch writes
    them.  wq: (L, P+H, 4H) int8 codes, scales: (L, 4H) f32
    (``ref.quantize_q8``); other operands and tiling as ``lstm_seq_traj``
    (``quantized=True`` budget).  Plain version:
    ``lstm_seq_q8_traj_plain``.  Not differentiable by itself (it is the
    forward half of ``lstm_seq_q8``'s autograd Function)."""
    _validate(wq, b, x, scales)
    L, H = wq.shape[0], wq.shape[-1] // 4
    P = wq.shape[1] - H
    B, T, _ = x.shape
    block_b, time_chunk = _fwd_spec(B, T, L, P, H, block_b, time_chunk,
                                    **_bytes(wq, x))
    called("lstm_seq_q8_traj", -(-x.shape[0] // block_b))
    if x.device.type == "meta":
        return _meta_out(wq, x, traj=True)
    if x.device.type == "cpu":
        return lstm_seq_q8_traj_plain(wq, scales, b, x)
    _no_autograd("lstm_seq_q8_traj", scales, b, x)
    out = _launch(wq, b, x, block_b, time_chunk, traj=True, scales=scales)
    _count(lstm_seq_q8_traj, wq, x, block_b)
    return out


class _LstmSeqQ8Fn(torch.autograd.Function):
    """``lstm_seq_q8`` under autograd — the JAX package's ``_lstm_seq_q8``
    custom VJP.  The forward quantizes the f32 master stack HERE, inside
    the Function (quantize ops recorded outside it would be differentiated
    through ``torch.round``, whose gradient is zero), then runs the q8
    trajectory launch; the backward runs the q8 reverse sweep and returns
    its f32 dw to the master unchanged (straight-through)."""

    @staticmethod
    def forward(ctx, w, b, x, bwd_spec):
        block_b, time_chunk = bwd_spec
        wq, scales = ref.quantize_q8(w)
        c, h, c_traj, h_traj = lstm_seq_q8_traj(
            wq, scales, b, x, block_b=block_b, time_chunk=time_chunk)
        ctx.bwd_spec = bwd_spec
        ctx.save_for_backward(wq, scales, b, x, c_traj, h_traj)
        return c, h

    @staticmethod
    def backward(ctx, dc, dh):
        from repro_torch.kernels import lstm_seq_bwd as bwd_lib
        wq, scales, b, x, c_traj, h_traj = ctx.saved_tensors
        block_b, time_chunk = ctx.bwd_spec
        dw, db, dx = bwd_lib.lstm_seq_bwd_q8(
            wq, scales, b, x, c_traj, h_traj, dc, dh, block_b=block_b,
            time_chunk=time_chunk)
        return dw, db, dx if ctx.needs_input_grad[2] else None, None


def lstm_seq_q8(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
                block_b: int | None = None, time_chunk: int | None = None,
                bwd_block_b: int | None = None,
                bwd_time_chunk: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-sequence stacked LSTM over int8 weights in ONE kernel launch.

    Same contract as ``lstm_seq``, but ``w`` is the f32 MASTER stack
    (b float32, x float32 or bfloat16),
    quantized inside per output channel (``ref.quantize_q8``, on every call,
    as the JAX entry does), and the kernel holds it in shared memory as int8
    plus (L, 4H) f32 scales, so ``choose_batch_block(quantized=True)`` fits
    it where the f32 stack does not.  Oracle: ``ref.lstm_seq_q8``, within
    fp rounding (the scale folds into the pre-activations); against the f32
    plans it is the int8 error band.  Under autograd: the q8 trajectory
    launch and the q8 backward (``_LstmSeqQ8Fn``), f32 straight-through
    gradients for the master stack, two launches at any T; where no q8
    backward tiling fits, a CPU call is autograd of ``ref.lstm_seq`` over
    ``ref.quantize_dequantize_ste(w)`` with a ``plan/dispatch``
    ``fallback="oracle_bwd"`` event, and a CUDA call raises ValueError."""
    _validate(w, b, x, w_dtype=torch.int8)
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    q8_bytes = dict(dtype_bytes=x.element_size(), quantized=True)
    if recorded(w, b, x):
        bwd_spec = _resolve_specs(B, T, L, P, H, bwd_block_b=bwd_block_b,
                                  bwd_time_chunk=bwd_time_chunk,
                                  device=x.device, **q8_bytes)
        if bwd_spec != ORACLE_BWD:
            return _LstmSeqQ8Fn.apply(w, b, x, bwd_spec)
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("plan/dispatch", family="lstm", plan="lstm_seq_q8",
                         fallback="oracle_bwd", bwd_block_b=ORACLE_BWD,
                         batch=B, seq_len=T)
        return ref.lstm_seq(ref.quantize_dequantize_ste(w), b, x)
    block_b, time_chunk = _fwd_spec(B, T, L, P, H, block_b, time_chunk,
                                    **q8_bytes)
    wq, scales = ref.quantize_q8(w)
    called("lstm_seq_q8", -(-x.shape[0] // block_b))
    if x.device.type == "meta":
        return _meta_out(wq, x, traj=False)
    if x.device.type == "cpu":
        return lstm_seq_q8_plain(wq, scales, b, x)
    out = _launch(wq, b, x, block_b, time_chunk, traj=False, scales=scales)
    _count(lstm_seq_q8, wq, x, block_b)
    return out


#: q8 plain launches since the last reset (CPU calls are not counted)
lstm_seq_q8.launches = lstm_seq_q8.reg_launches = 0
lstm_seq_q8.bf16_launches = 0
#: q8 trajectory launches since the last reset (CPU calls are not counted)
lstm_seq_q8_traj.launches = lstm_seq_q8_traj.reg_launches = 0
lstm_seq_q8_traj.bf16_launches = 0
