"""Sequence-resident stacked-LSTM backward (K3, K4b, and their int8 twin
K3-q8): wrappers, launch counters and plain version.

Replaces four Pallas kernels of the JAX package's
``kernels/lstm_seq_bwd.py``: ``_seq_bwd_kernel`` (launched by
``_lstm_seq_bwd_call``), ``_seq_bwd_chunked_kernel`` (launched by
``_lstm_seq_bwd_chunked_call``) and their int8-weight bodies
``_seq_bwd_q8_kernel`` and ``_seq_bwd_chunked_q8_kernel``, with ONE CUDA
C++ kernel in
``csrc/lstm_seq_bwd.cu``: a persistent thread block per batch tile unwinds
the whole T x L recurrence in reverse time in one launch, recomputing the
gates from the forward's f32 trajectories with the forward's own gate pass
(``csrc/lstm_gates.cuh``).  Where ``lstm_seq.weight_home`` is
``"registers"`` (the paper's 2 x 32 at one row a block) the block runs a
layer wavefront whose chain warps form the gate gradients and the
products that feed the next step while worker warps recompute the gates
ahead and accumulate dW/db in registers behind; elsewhere it walks time
backwards and layers top-down with the stack, the carries and f32 dW/db
accumulators in shared memory.  The sum of dW/db across batch tiles is a
two-level fixed-order sum (groups of 8 tiles, then the groups) taken by
the last blocks to finish, so one launch gives the same bits run to
run.  Where ``weight_home`` is ``"split"`` (a stack and f32 dW that no
block holds) one cooperative launch of G co-resident blocks a tile runs
the sweep as a reverse layer wavefront, each block owning H / G units of
every layer: it recomputes its gate columns bit for bit, keeps their dW
and db, and sums the G blocks' partial products of the carries in block
order after one grid barrier a wave-step (``csrc/lstm_seq_bwd.cu``),
deterministic run to run, its dh and dx sums in another order than the
one-block homes'.  What bounds it on the H100 and what the design does about it is
written at the top of the CUDA source.  Its int8 instance
(``lstm_seq_bwd_q8``, or ``lstm_seq_bwd(..., scales=)``) recomputes the
gates with the q8 forward's scale fold and returns f32 straight-through
dw and db for the master stack.  Each is built for the (stack, input)
dtypes of ``lstm_seq.INSTANCES``: the bf16 instances widen the stack, the
bias, x and the cotangents to f32 as they read them, recompute from the
f32 trajectories (to the bit of K2t's bf16 instance), sum in f32 and write
dx, and a bf16 stack's dw and db, in bf16.

``lstm_seq_bwd_plain`` is the plain PyTorch version: it unwinds step by
step exactly as the JAX package's ``_unwind_step`` does, over the whole
batch at once, with no autograd (``scales=`` folds as the q8 kernel does).
A tensor on the CPU takes it; a tensor on the card launches the kernel or
raises.  ``lstm_seq_bwd.launches`` and ``lstm_seq_bwd_q8.launches`` count
kernel launches: one per training step at any T (``split_launches`` those
on the split home, ``bf16_launches`` those on a bf16 input).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import factorization
from repro_torch.kernels import _build, called, meta_like
from repro_torch.kernels import lstm_seq as seq_lib

_NAME = "lstm_seq_bwd"
F32 = torch.float32


def lstm_seq_bwd_plain(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                       c_traj: torch.Tensor, h_traj: torch.Tensor,
                       dc: torch.Tensor, dh: torch.Tensor,
                       scales: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-sequence BPTT, step by step: (dw, db, dx).

    w: (L, P+H, 4H); b: (L, 4H); x: (B, T, P) padded input; c_traj/h_traj:
    (T, L, B, H) f32 post-step trajectories (ref.lstm_seq_traj); dc/dh:
    (L, B, H) cotangents of the final state.  For t = T-1 .. 0 and layers
    top-down: recompute the gates from the trajectories, form the gate
    gradients, accumulate dW and db in f32, and pass dh_prev = dg W[P:]^T,
    dc_prev = dc * f and dinp = dg W[:P]^T on — the JAX package's
    ``_unwind_step``.  Results in the parameter and input dtypes.

    ``scales`` (L, 4H) f32: ``w`` is the int8 stack of the q8 forward.  The
    recompute folds the scales as the forward did, dW and db take the
    unscaled gate gradients (f32 straight-through gradients, returned in
    f32), and only the outgoing products take ``dg * s``."""
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    w32, b32 = w.to(F32), b.to(F32)
    dw = torch.zeros(L, P + H, 4 * H, dtype=F32, device=x.device)
    db = torch.zeros(L, 4 * H, dtype=F32, device=x.device)
    dx = torch.empty(B, T, P, dtype=F32, device=x.device)
    dc_carry = [dc[l].to(F32) for l in range(L)]
    dh_carry = [dh[l].to(F32) for l in range(L)]
    zeros = torch.zeros(L, B, H, dtype=F32, device=x.device)
    for t in range(T - 1, -1, -1):
        x_t = x[:, t].to(F32)
        c_t, h_t = c_traj[t], h_traj[t]
        c_prev_all = c_traj[t - 1] if t > 0 else zeros
        h_prev_all = h_traj[t - 1] if t > 0 else zeros
        dinp = torch.zeros(B, P, dtype=F32, device=x.device)
        for l in range(L - 1, -1, -1):
            wl = w32[l]
            inp = x_t if l == 0 else F.pad(h_t[l - 1], (0, P - H))
            c_prev, h_prev = c_prev_all[l], h_prev_all[l]
            gates = inp @ wl[:P] + h_prev @ wl[P:]
            if scales is not None:
                gates = gates * scales[l].to(F32)
            gates = gates + b32[l]
            i, f, g, o = gates.chunk(4, dim=-1)
            si, sf, so = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            tg = torch.tanh(g)
            tc = torch.tanh(c_t[l])
            dh_l = dh_carry[l] + dinp[:, :H]
            dc_l = dc_carry[l] + dh_l * so * (1.0 - tc * tc)
            dgates = torch.cat([
                dc_l * tg * si * (1.0 - si),
                dc_l * c_prev * sf * (1.0 - sf),
                dc_l * si * (1.0 - tg * tg),
                dh_l * tc * so * (1.0 - so),
            ], dim=-1)
            dw[l] += torch.cat([inp.T @ dgates, h_prev.T @ dgates], dim=0)
            db[l] += dgates.sum(dim=0)
            dg_w = dgates if scales is None else dgates * scales[l].to(F32)
            dh_carry[l] = dg_w @ wl[P:].T
            dc_carry[l] = dc_l * sf
            dinp = dg_w @ wl[:P].T
        dx[:, t] = dinp
    return (dw.to(w.dtype if scales is None else F32), db.to(b.dtype),
            dx.to(x.dtype))


def dot_parts(rows: int, threads: int) -> int:
    """Lanes that share one row of W in the backward's ``dg @ W^T``
    products: the largest power of two up to a warp with ``parts * rows``
    within ``threads`` (at least 1; the block sweeps the rows again when
    even one lane per row does not cover them)."""
    parts = factorization.WARP
    while parts > 1 and parts * rows > threads:
        parts //= 2
    return parts


def _entry(w_dtype: torch.dtype, io_dtype: torch.dtype,
           split: bool = False):
    """The C entry of the one-block backward (``lstm_seq_bwd_*``) or of the
    split backward (``lstm_seq_bwd_split_*``) for the dtype pair."""
    lib = _build.load(_NAME)
    fn = getattr(lib, ("lstm_seq_bwd_split_" if split else "lstm_seq_bwd_")
                 + seq_lib.SUFFIX[w_dtype, io_dtype])
    if fn.argtypes is None:
        q8 = w_dtype == torch.int8
        fn.argtypes = ([ctypes.c_void_p] * ((14 if q8 else 13)
                                            - (1 if split else 0))
                       + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * (3 if split else 6)
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def split_workspace(B: int, L: int, P: int, H: int, block_b: int,
                    n_blocks: int) -> tuple[int, int]:
    """Floats of the split backward's two workspaces: its partial products
    (2 parity slots x tiles x G blocks x (L, bmp, P+H): each block's sum
    over its own gate columns of every row of W, for the dh carries, the
    layer-below input gradients and dx), and, for more than one tile, each
    tile's dW/db (L, P+H+1, 4H) summed over tiles in tile order at the
    end."""
    bmp = factorization.round_up(block_b, seq_lib.split_row_group(block_b))
    n_tiles = -(-B // block_b)
    part = 2 * n_tiles * n_blocks * L * bmp * (P + H)
    tiles = n_tiles * L * (P + H + 1) * 4 * H if n_tiles > 1 else 0
    return part, tiles


def _validate(w, b, x, c_traj, h_traj, dc, dh, scales=None) -> None:
    """Shapes, dtypes and devices: (w, b, x) one of
    ``lstm_seq.INSTANCES`` (int8 with float32 ``scales``), the cotangents
    in x's dtype and the trajectories float32."""
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T = x.shape[0], x.shape[1]
    if w.dim() != 3 or b.shape != (L, 4 * H) or x.dim() != 3 \
            or x.shape[-1] != P or c_traj.shape != (T, L, B, H) \
            or h_traj.shape != (T, L, B, H) or dc.shape != (L, B, H) \
            or dh.shape != (L, B, H) \
            or (scales is not None and scales.shape != (L, 4 * H)):
        raise ValueError(
            f"lstm_seq_bwd shapes: w {tuple(w.shape)}, b {tuple(b.shape)}, "
            f"x {tuple(x.shape)}, c_traj {tuple(c_traj.shape)}, h_traj "
            f"{tuple(h_traj.shape)}, dc {tuple(dc.shape)}, dh "
            f"{tuple(dh.shape)}, scales "
            f"{None if scales is None else tuple(scales.shape)}")
    if scales is not None and w.dtype != torch.int8:
        raise TypeError(f"the q8 backward takes an int8 stack; w is "
                        f"{w.dtype}")
    if (w.dtype == torch.int8) != (scales is not None) \
            or (scales is not None and scales.dtype != F32) \
            or (w.dtype, b.dtype, x.dtype) not in seq_lib.INSTANCES:
        raise TypeError(f"lstm_seq_bwd has no instance for w {w.dtype}, b "
                        f"{b.dtype}, x {x.dtype}")
    for name, t in (("c_traj", c_traj), ("h_traj", h_traj)):
        if t.dtype != F32:
            raise TypeError(f"lstm_seq_bwd takes float32 trajectories; "
                            f"{name} is {t.dtype}")
    for name, t in (("dc", dc), ("dh", dh)):
        if t.dtype != x.dtype:
            raise TypeError(f"lstm_seq_bwd takes cotangents in x's dtype "
                            f"{x.dtype}; {name} is {t.dtype}")
    for name, t in (("w", w), ("b", b), ("c_traj", c_traj),
                    ("h_traj", h_traj), ("dc", dc), ("dh", dh),
                    ("scales", scales)):
        if t is not None and t.device != x.device:
            raise ValueError(f"lstm_seq_bwd: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"lstm_seq_bwd runs on cpu or cuda, not {x.device}")


#: tiles a group of the kernel's closing sum (csrc/lstm_seq_bwd.cu kGroup)
CLOSE_GROUP = 8
#: the closing sum's int32 tickets per (device, stream): zeroed once, and
#: each reset to 0 by the last block to draw it, so launches on one stream
#: reuse them in order and launches on two streams never share one
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` tickets of ``stream``, all 0 between launches (a
    longer set replaces a shorter one)."""
    key = (device.index, stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < n:
        tickets = _TICKETS[key] = torch.zeros(n, dtype=torch.int32,
                                              device=device)
    return tickets


def close_workspace(n_tiles: int, n_out: int) -> tuple[int, int]:
    """Floats of the closing sum's partials (each tile's, then each
    group's) and its tickets (each group's, then the top one) for
    ``n_tiles`` tiles of ``n_out`` floats; none for one tile."""
    if n_tiles == 1:
        return 0, 0
    groups = -(-n_tiles // CLOSE_GROUP)
    return (n_tiles + groups) * n_out, groups + 1


def _run_split(w, b, x, c_traj, h_traj, dc, dh, block_b: int, n_blocks: int,
               scales: torch.Tensor | None):
    """One cooperative launch of the split backward: ``n_blocks`` blocks a
    tile of ``block_b`` rows, all resident at once.  A refused launch
    raises; nothing else runs in its place."""
    q8 = scales is not None
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    smem = seq_lib.working_set_bytes(T, L, P, H, block_b, mode="bwd",
                                     n_blocks=n_blocks,
                                     **seq_lib._bytes(w, x))
    if smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"lstm_seq_bwd: split tile ({block_b}, G="
                         f"{n_blocks}) needs {smem} bytes of shared memory, "
                         "above a thread block's "
                         f"{factorization.H100_SMEM_PER_BLOCK}")
    threads = seq_lib.split_threads(L, H, n_blocks, mode="bwd")
    w, b = w.contiguous(), b.contiguous()
    c_traj, h_traj = c_traj.contiguous(), h_traj.contiguous()
    dc, dh = dc.contiguous(), dh.contiguous()
    scales = None if scales is None else scales.contiguous()
    dw = x.new_empty(w.shape, dtype=F32 if q8 else w.dtype)
    db = torch.empty_like(b)
    dx = x.new_empty(B, T, P)
    n_part, n_tile = split_workspace(B, L, P, H, block_b, n_blocks)
    part = x.new_empty(n_part, dtype=F32)
    tile_part = x.new_empty(n_tile, dtype=F32)
    lib, fn = _entry(w.dtype, x.dtype, split=True)
    w_ptrs = (w.data_ptr(), scales.data_ptr()) if q8 else (w.data_ptr(),)
    err = fn(*w_ptrs, b.data_ptr(), x.data_ptr(), c_traj.data_ptr(),
             h_traj.data_ptr(), dc.data_ptr(), dh.data_ptr(), dw.data_ptr(),
             db.data_ptr(), dx.data_ptr(), part.data_ptr(),
             tile_part.data_ptr(), B, T, L, P, H, x.stride(0), x.stride(1),
             block_b, n_blocks, threads, smem,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, _NAME, err)
    return dw, db, dx


def _run(w, b, x, c_traj, h_traj, dc, dh, block_b: int,
         time_chunk: int | None, scales: torch.Tensor | None,
         n_blocks: int = 1):
    """The backward at a resolved tiling: its plain version on the CPU, one
    launch of the f32 or (with ``scales``) int8 instance on the card
    (``n_blocks`` > 1: the split home's)."""
    _validate(w, b, x, c_traj, h_traj, dc, dh, scales)
    seq_lib._check_tile(block_b, n_blocks, w.shape[-1] // 4, "block_b")
    if x.device.type == "meta":
        q8 = scales is not None
        return meta_like((w.shape, torch.float32 if q8 else w.dtype),
                         (b.shape, torch.float32 if q8 else b.dtype),
                         (x.shape, x.dtype))
    if x.device.type == "cpu":
        return lstm_seq_bwd_plain(w, b, x, c_traj, h_traj, dc, dh, scales)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (w, b, x, c_traj, h_traj, dc, dh)):
        raise RuntimeError("the lstm_seq_bwd kernel has no double backward; "
                           "call it outside autograd")
    if x.stride(-1) != 1:
        raise ValueError("lstm_seq_bwd: x needs a contiguous last dim")
    if n_blocks > 1:
        return _run_split(w, b, x, c_traj, h_traj, dc, dh, block_b,
                          n_blocks, scales)
    q8 = scales is not None
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    tc = T if time_chunk is None else max(1, min(time_chunk, T))
    smem = seq_lib.working_set_bytes(T, L, P, H, block_b, mode="bwd",
                                     time_chunk=None if tc == T else tc,
                                     **seq_lib._bytes(w, x))
    if smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"lstm_seq_bwd: tile ({block_b}, {tc}) needs {smem} "
                         "bytes of shared memory, above a thread block's "
                         f"{factorization.H100_SMEM_PER_BLOCK}")
    reg = seq_lib.weight_home(L, P, H, block_b) == "registers"
    parts = seq_lib.gate_parts(H)
    if parts == 0:
        raise ValueError(f"lstm_seq_bwd: 4H = {4 * H} gate columns exceed "
                         f"{seq_lib.MAX_THREADS} threads")
    threads = L * seq_lib.BWD_REG_THREADS if reg else \
        factorization.round_up(parts * 4 * H, factorization.WARP)
    dparts = dot_parts(P + H, threads)
    w, b = w.contiguous(), b.contiguous()
    # the register home copies trajectory rows 16 bytes at a time
    c_traj, h_traj = _build.aligned(c_traj), _build.aligned(h_traj)
    dc, dh = dc.contiguous(), dh.contiguous()
    scales = None if scales is None else scales.contiguous()
    n_tiles = -(-B // block_b)
    # dw in the stack's dtype, f32 for the int8 stack (the master's); db in
    # the bias's, dx in x's
    dw = x.new_empty(w.shape, dtype=F32 if q8 else w.dtype)
    db = torch.empty_like(b)
    dx = x.new_empty(B, T, P)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # one tile writes dw and db itself; more sum per-tile partials, the
    # last tiles to finish found by the stream's tickets
    n_parts, n_tickets = close_workspace(n_tiles, w.numel() + b.numel())
    partials = x.new_empty(n_parts, dtype=F32)
    ticket = _tickets(x.device, stream, n_tickets) if n_tickets else None
    # the register home's gate gradients of every step, summed into dW after
    # the sweep
    dg_work = x.new_empty(B * L * T * 4 * H if reg else 0, dtype=F32)
    lib, fn = _entry(w.dtype, x.dtype)
    w_ptrs = (w.data_ptr(), scales.data_ptr()) if q8 else (w.data_ptr(),)
    err = fn(*w_ptrs, b.data_ptr(), x.data_ptr(), c_traj.data_ptr(),
             h_traj.data_ptr(), dc.data_ptr(), dh.data_ptr(), dw.data_ptr(),
             db.data_ptr(), dx.data_ptr(), partials.data_ptr(),
             None if ticket is None else ticket.data_ptr(),
             dg_work.data_ptr(), B, T, L, P, H,
             x.stride(0), x.stride(1), block_b, tc, int(reg), parts, dparts,
             threads, smem, stream)
    _build.check(lib, _NAME, err)
    return dw, db, dx


def lstm_seq_bwd(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 c_traj: torch.Tensor, h_traj: torch.Tensor,
                 dc: torch.Tensor, dh: torch.Tensor, *, block_b: int,
                 time_chunk: int | None = None,
                 scales: torch.Tensor | None = None, n_blocks: int = 1
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-sequence BPTT in ONE kernel launch: (dw, db, dx).

    Operands as ``lstm_seq_bwd_plain``: (w, b, x) float32 or bfloat16
    throughout, the cotangents in x's dtype, the trajectories float32;
    dw, db and dx come back in w's, b's and x's dtypes, summed in f32.
    ``block_b`` /
    ``time_chunk`` come from ``lstm_seq.choose_batch_block(mode="bwd")``:
    ``time_chunk=None`` holds x and both trajectories whole in shared
    memory, ``tc`` streams them in reverse chunks; the gradients are
    bit-identical for every ``time_chunk`` and from run to run.
    ``n_blocks`` > 1 (``choose_batch_block``'s split home) runs the split
    backward: the stack's gate columns over that many co-resident blocks a
    tile, one cooperative launch.  With ``scales``, ``w`` is the int8
    stack and this is ``lstm_seq_bwd_q8``."""
    if scales is not None:
        return lstm_seq_bwd_q8(w, scales, b, x, c_traj, h_traj, dc, dh,
                               block_b=block_b, time_chunk=time_chunk,
                               n_blocks=n_blocks)
    called("lstm_seq_bwd", -(-x.shape[0] // block_b))
    out = _run(w, b, x, c_traj, h_traj, dc, dh, block_b, time_chunk, None,
               n_blocks)
    if x.device.type == "cuda":
        _count(lstm_seq_bwd, x, n_blocks)
    return out


def _count(wrapper, x: torch.Tensor, n_blocks: int) -> None:
    """One launch of ``wrapper``'s kernel: ``launches``, ``split_launches``
    on the split home and ``bf16_launches`` on a bf16 input."""
    wrapper.launches += 1
    wrapper.split_launches += int(n_blocks > 1)
    wrapper.bf16_launches += int(x.dtype == torch.bfloat16)


def lstm_seq_bwd_q8(wq: torch.Tensor, scales: torch.Tensor, b: torch.Tensor,
                    x: torch.Tensor, c_traj: torch.Tensor,
                    h_traj: torch.Tensor, dc: torch.Tensor, dh: torch.Tensor,
                    *, block_b: int, time_chunk: int | None = None,
                    n_blocks: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 instance of the backward in ONE launch: (dw, db, dx), dw
    and db f32, dx in x's dtype (float32 or bfloat16, the cotangents in
    it too).  wq: (L, P+H, 4H) int8 codes the q8 forward ran with, scales:
    (L, 4H) f32, c_traj/h_traj its f32 trajectories; tiling from
    ``choose_batch_block(mode="bwd", quantized=True)``.  dw and db are the
    straight-through gradients of the dequantized stack, for the f32
    master weights."""
    called("lstm_seq_bwd_q8", -(-x.shape[0] // block_b))
    out = _run(wq, b, x, c_traj, h_traj, dc, dh, block_b, time_chunk, scales,
               n_blocks)
    if x.device.type == "cuda":
        _count(lstm_seq_bwd_q8, x, n_blocks)
    return out


#: kernel launches since the last reset (CPU calls are not counted), those
#: of them on the split home, and those on a bf16 input
lstm_seq_bwd.launches = lstm_seq_bwd.bf16_launches = 0
lstm_seq_bwd.split_launches = 0
#: q8 kernel launches since the last reset (CPU calls are not counted),
#: those of them on the split home, and those on a bf16 input
lstm_seq_bwd_q8.launches = lstm_seq_bwd_q8.bf16_launches = 0
lstm_seq_bwd_q8.split_launches = 0
