"""Mamba selective-scan kernels (K7, K7t, K7b): wrappers, budget tables,
launch counters, plain versions and the autograd Function.

Replaces the JAX package's Pallas kernels ``kernels/mamba_scan.py:_kernel``
and ``_traj_kernel`` (body ``_fwd_body``, step math ``_chunk_math``,
launched by ``_fwd_call``) with the CUDA C++ kernel in
``csrc/mamba_scan.cu``, and its ``_bwd_kernel`` (launched by
``_bwd_call``) with ``csrc/mamba_scan_bwd.cu``.  The selective scan

  h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t

runs per channel d of d_inner and state s of d_state with an f32 state
carried across the whole sequence in one launch: MobiRNN's rule of keeping
the recurrent state on chip for the whole sequence.  The JAX kernel keeps
the whole (block_b, d_inner, d_state) state in VMEM, 1 MiB a batch row at
Jamba's width (d_inner 16384, d_state 16) against a thread block's 227 KB
of shared memory.  Each channel's recurrence is independent (the step sums
over d_state only), so the port tiles d_inner: a channel's d_state (at
most 16) f32 states live in registers (of one thread in the forward, of
four lanes in the backward and in the forward's one-phase path at T = 1),
and a block runs ``di_tile`` channels of one batch row.  ``chunk``
bounds the windows of x, dt and the B and C rows (shared by every channel
of a row) that the forward stages in shared memory (at most
``FWD_WINDOW`` steps a window) and sets the cadence of the trajectory K7t
writes; it changes no arithmetic, so K7's outputs are bit-identical at
every chunk, tile and row tiling.  y_t sums its states in one fixed order
(``mamba_math.cuh``: quarters of four states, then pairwise), in every
forward path; not the plain version's order, so the kernels are held to
their plain versions at ``MAMBA_TOL``.

Three launches:
  * ``mamba_scan`` (K7): y and the final state, one launch;
  * ``mamba_scan_traj`` (K7t): the same kernel with one more output, the
    chunk-incoming states ``h_traj (B, nt, d_inner, d_state)`` f32 (never
    the IO dtype), the residual the backward recomputes each chunk from;
    its y and final state are bit-identical to K7's;
  * ``mamba_scan_bwd`` (K7b): the whole reverse sweep in one launch.
The JAX package differentiates ``_chunk_math`` with ``jax.vjp`` inside its
backward kernel; here the chunk backward is derived by hand
(``mamba_scan_bwd_plain`` writes it in plain PyTorch, the kernel computes
the same sums).  With a_t = exp(dt_t A), g the cotangent of h_t and each
chunk walked in reverse from g = dh_fin at the last step:

  g_t    = a_{t+1} * g_{t+1} + dy_t[d] C_t[s]
  dx_t   = dt_t sum_s g_t B_t          ddt_t = sum_s g_t h_{t-1} a_t A
                                               + x_t sum_s g_t B_t
  dB_t   = sum_d g_t dt_t x_t          dC_t  = sum_d dy_t h_t
  dA     = sum_{b,t} g_t h_{t-1} a_t dt_t,     dh0 = a_0 * g_0

The per-step states of a chunk are recomputed from its stored incoming
state with the forward's own step arithmetic (``mamba_math.cuh``), so they
are bit-identical to the forward's; the backward walks a chunk in
sub-chunks of ``BWD_SUB`` steps from checkpoints, so its shared memory
does not hold a chunk's states.  dB and dC sum over d_inner tiles and dA
over batch rows: each block writes its partial sums and the last blocks
to arrive (integer tickets; for dB and dC two levels, groups of
``BWD_GROUP`` tiles, then the groups) add them in a fixed order, so two
runs give the same bits and no float atomics are used.

Tiling: ``MambaBlocks(block_b, chunk, di_tile)`` presents the family-generic
``core/tiling.TilePlan`` interface.  ``working_set_bytes`` prices the
dynamic shared memory a launch asks for, with a d_inner tile term JAX's
table lacks; ``choose_blocks`` keeps the chunk as coarse as the budget
allows, then the tile, and keeps enough blocks an SM to hold
``MIN_WARPS_PER_SM`` warps (a TPU core runs the grid in order; an SM needs
warps to switch between).  A training call takes its (chunk, di_tile) from
the backward's table (``mode="bwd"``) for both launches; at Jamba's width
that is chunk 32, set by K7b's chunk windows.

Non-dividing T and B: the kernels and their plain versions run the last
chunk short and stop at the last row, so nothing is padded (the JAX entry
pads both axes, because a Pallas grid takes whole blocks).

A tensor on the CPU takes the plain versions; a tensor on the card launches
the kernels or raises.  Each wrapper's ``launches`` counts its kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build
from repro_torch.obs import trace as trace_lib

F32 = torch.float32
#: ``bwd=`` sentinel: differentiate the plain scan instead of launching the
#: fused reverse sweep (the CPU's fallback past the backward's budget)
ORACLE_BWD = 0
#: ``bwd=`` default: ONE reverse-sweep launch for the whole backward
FUSED_BWD = 1
#: threads (channels) of the forward's widest block; tiles are powers of
#: two from one warp up to this
DI_TILE = 128
#: states a channel keeps in registers (csrc/mamba_math.cuh kMaxDs)
MAX_DS = 16
#: steps of a window of the forward's ring, at most (csrc/mamba_scan.cu)
FWD_WINDOW = 16
#: warps the budget keeps resident on an SM.  A block runs its rows' T
#: steps in order, so a grid that does not fit the SMs at once takes two
#: waves of the whole scan: at Jamba's width the forward's four rows make
#: 512 blocks of four warps, 3.9 an SM, and 16 warps an SM hold them all
#: (K7b's grid takes waves whatever the budget: 1,024 blocks of eight
#: warps, two an SM at its 128 registers a thread)
MIN_WARPS_PER_SM = 16
#: K7b's layout (csrc/mamba_scan_bwd.cu): lanes a channel (each keeps
#: d_state / 4 states), steps a sub-chunk, and the channels of its widest
#: block (256 threads; two blocks an SM hold MIN_WARPS_PER_SM warps)
BWD_LANES = 4
BWD_SUB = 8
BWD_DI_TILE = 64
#: d-tiles a group of K7b's two-level dB/dC sum
BWD_GROUP = 16
_IO_DTYPES = (torch.float32, torch.bfloat16)


class MambaBlocks(NamedTuple):
    """The selective scan's tiling decision: batch tile x time chunk x
    d_inner tile.

    ``block_b`` rows of the batch run one after another in a block (each
    exactly as alone); ``chunk`` is the window of B, C, x and dt rows in
    shared memory (in windows of at most ``FWD_WINDOW`` steps in K7 and
    K7t) and the trajectory's cadence (I/O granularity only); ``di_tile``
    is the channels of a block, one a thread in K7 and K7t and four in
    K7b.

    Presents ``core/tiling.TilePlan``: ``batch_tile`` is ``block_b``,
    ``time_chunk`` is ``chunk`` (the kernels always stream time)."""
    block_b: int
    chunk: int
    di_tile: int = DI_TILE

    @property
    def batch_tile(self) -> int:
        return self.block_b

    @property
    def time_chunk(self) -> int:
        return self.chunk


def working_set_bytes(seq_len: int, d_state: int, chunk: int, di_tile: int,
                      mode: str = "fwd", io_bytes: int = 4) -> int:
    """Dynamic shared memory of one thread block, exactly as the kernel of
    ``mode`` launches it (the C side refuses a launch priced otherwise).

    ``mode="fwd"`` prices K7 and K7t, a block of ``di_tile`` channels, one
    a thread: a ring of two windows of W = min(C, ``FWD_WINDOW``) steps,
    each dt (W, di_tile) f32 and x (W, di_tile) in the IO dtype
    (``x_dt``), and the B and C rows (W, ``MAX_DS``) f32, padded with
    zeros past d_state (``b_c``).  At T = 1 the one-phase path stages
    nothing: 0 bytes.  The state never enters the table: it lives in
    registers.

    ``mode="bwd"`` prices K7b, a block of ``di_tile`` channels, four lanes
    each (``BWD_LANES`` x di_tile threads), which walks a chunk in
    sub-chunks of ``BWD_SUB`` steps:
      * ``checkpoints``: the state at each sub-chunk's start, a float4 a
        lane, ceil(C / BWD_SUB) x threads x 16 bytes -- the port's form of
        JAX's ``linearised_scan`` term; a sub-chunk's own states and decays
        are recomputed into registers, so no term grows with the states of
        the whole chunk;
      * ``sums``: each warp's 32 dB/dC sums of each step of a sub-chunk,
        in two slots by sub-chunk parity, 2 x BWD_SUB x threads x 4 bytes;
      * ``ring``: two chunk windows, each dt (C, di_tile) f32, x and dy
        (C, di_tile) in the IO dtype (``io_bytes``: 4 for f32, 2 for
        bf16), the chunk's incoming state (di_tile, d_state) f32 (K7t's
        ``h_traj`` row) and the B and C rows (C, d_state) f32, rounded up
        to 16 bytes.
    Neither table grows with ``block_b``: a block runs its rows one after
    another."""
    ws = tiling.WorkingSet(mode)
    C = max(1, min(chunk, seq_len))
    if mode == "fwd":
        return 0 if seq_len == 1 else _fwd_ring(C, di_tile, io_bytes)
    threads = BWD_LANES * di_tile
    ws.add("checkpoints", -(-C // BWD_SUB) * threads * 16)
    ws.add("sums", 2 * BWD_SUB * threads * 4)
    ws.add("ring", 2 * factorization.round_up(
        C * di_tile * (4 + 2 * io_bytes) + di_tile * d_state * 4
        + 2 * C * d_state * 4, 16))
    return ws.total()


def _fwd_ring(chunk: int, di_tile: int, io_bytes: int) -> int:
    """The forward's ring of two windows (csrc/mamba_scan.cu
    ``slot_bytes``), the shared memory of its general path at any T."""
    ws = tiling.WorkingSet("fwd")
    W = min(chunk, FWD_WINDOW)
    ws.add("x_dt", 2 * W * di_tile * (4 + io_bytes))
    ws.add("b_c", 2 * 2 * W * MAX_DS * 4)
    return ws.total()


def block_budget(threads: int) -> int:
    """Shared memory one block of ``threads`` threads may take so that
    ``MIN_WARPS_PER_SM`` warps fit on an SM: the SM's shared memory over
    the blocks needed, less the runtime's reserve of each.  A forward
    block has ``di_tile`` threads, a K7b block ``BWD_LANES`` x di_tile."""
    blocks = max(1, MIN_WARPS_PER_SM * factorization.WARP // threads)
    return min(factorization.H100_SMEM_PER_BLOCK,
               factorization.H100_SMEM_PER_SM // blocks
               - factorization.H100_SMEM_RESERVED_PER_BLOCK)


def _tiles(d_inner: int, top: int = DI_TILE) -> list[int]:
    """Candidate d_inner tiles, coarse to fine: powers of two from one warp
    up to ``top``, no wider than d_inner needs."""
    need = max(factorization.WARP, 1 << (d_inner - 1).bit_length())
    return [t for t in tiling.halving(min(top, need))
            if t >= factorization.WARP]


def _bwd_tile(d_inner: int) -> int:
    """K7b's default tile: the widest power of two of channels up to
    ``BWD_DI_TILE`` that d_inner needs (at least 8, one warp)."""
    tile = 8
    while tile < min(BWD_DI_TILE, d_inner):
        tile *= 2
    return tile


def choose_blocks(seq_len: int, d_inner: int, d_state: int, *,
                  target: int | None = None, smem_budget: int | None = None,
                  mode: str = "fwd") -> MambaBlocks | None:
    """Pick ``(block_b, chunk, di_tile)`` for the kernel of ``mode``, or
    None when nothing fits.

    The chunk halves from ``target`` (clamped to T; whole T when None) and,
    at each chunk, the tile halves from ``DI_TILE`` to one warp; the first
    pair whose working set fits wins.  The budget is ``smem_budget`` when
    given, else ``block_budget`` of the block's threads.  The batch tile is
    one row, so the rows spread over the SMs.  None when d_state exceeds
    the registers a thread keeps (``MAX_DS``) or even a chunk of 1 does not
    fit; the plan then takes the oracle on the CPU and raises on the card.

    ``mode="bwd"`` is the training decision: its chunk and tile serve the
    training forward (K7t, a block of di_tile threads) and the backward
    (K7b, BWD_LANES x di_tile threads), so both working sets must fit
    their budgets, the tile starting at ``BWD_DI_TILE``.  K7t's windows
    stay at ``FWD_WINDOW`` steps whatever the chunk, so at Jamba's width
    K7b's two chunk windows set the chunk."""
    tiling.check_mode(mode)
    if d_state > MAX_DS:
        return None
    start = seq_len if target is None else target
    top = DI_TILE if mode == "fwd" else BWD_DI_TILE
    for c in tiling.halving(max(1, min(start, seq_len))):
        for tile in _tiles(d_inner, top):
            kernels = [("fwd", tile)]
            if mode == "bwd":
                kernels.append(("bwd", BWD_LANES * tile))
            if all(working_set_bytes(seq_len, d_state, c, tile, m) <= (
                    block_budget(threads) if smem_budget is None
                    else smem_budget) for m, threads in kernels):
                return MambaBlocks(1, c, tile)
    return None


# ---------------------------------------------------------------------------
# Plain versions: the CPU path of the wrappers and the kernels' yardsticks
# ---------------------------------------------------------------------------
def _chunk_math(x, dt, b, c, a, h):
    """``x.shape[1]`` steps of the selective scan in f32, batched over
    rows: x, dt (B, C, di); b, c (B, C, ds); a (di, ds); h (B, di, ds).
    Returns (y (B, C, di), h').  The step is the JAX package's
    ``_chunk_math`` step (the models/mamba recurrence)."""
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t, :, None] * a)
        dbx = (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        h = decay * h + dbx
        ys.append(torch.einsum("bds,bs->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


def _f32(*ts: torch.Tensor) -> list[torch.Tensor]:
    return [t.to(F32) for t in ts]


def mamba_scan_ref(x, dt, b, c, a, h0) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step scan over the whole sequence — the oracle plan, with the
    dtype contract: y in x's dtype, the final state f32."""
    ys, h = _chunk_math(*_f32(x, dt, b, c, a, h0))
    return ys.to(x.dtype), h


def mamba_scan_traj_plain(x, dt, b, c, a, h0, chunk: int
                          ) -> tuple[torch.Tensor, ...]:
    """The plain version of K7t: the scan in chunks of ``chunk`` steps (the
    last may be shorter), y in x's dtype, the final state f32 and the
    chunk-incoming states ``h_traj (B, ceil(T / chunk), di, ds)`` f32."""
    T = x.shape[1]
    chunk = max(1, min(chunk, T))
    x_, dt_, b_, c_, a_, h = _f32(x, dt, b, c, a, h0)
    ys, traj = [], []
    for t0 in range(0, T, chunk):
        win = slice(t0, t0 + chunk)
        traj.append(h)
        y, h = _chunk_math(x_[:, win], dt_[:, win], b_[:, win], c_[:, win],
                           a_, h)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h, torch.stack(traj, dim=1)


def mamba_scan_plain(x, dt, b, c, a, h0, chunk: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K7: ``mamba_scan_traj_plain`` without the
    trajectory — the CPU path of the scan and the kernel's yardstick."""
    y, h, _ = mamba_scan_traj_plain(x, dt, b, c, a, h0, chunk)
    return y, h


def mamba_scan_bwd_plain(x, dt, b, c, a, h_traj, dy, dh_fin, chunk: int
                         ) -> tuple[torch.Tensor, ...]:
    """The plain version of K7b: the hand-derived backward of the module
    docstring, chunks in reverse, each chunk's per-step states recomputed
    from its incoming state in ``h_traj`` (``mamba_scan_traj``'s, at the
    same ``chunk``), f32, batched over rows.  ``dy`` is the cotangent of y,
    ``dh_fin`` of the final state.  Returns (dx in x's dtype, ddt, db, dc,
    da, dh0 f32)."""
    B, T, di = x.shape
    chunk = max(1, min(chunk, T))
    x_, dt_, b_, c_, a_, dy_ = _f32(x, dt, b, c, a, dy)
    g = dh_fin.to(F32)
    dx, ddt = torch.empty_like(x_), torch.empty_like(dt_)
    db, dc = torch.empty_like(b_), torch.empty_like(c_)
    da = torch.zeros_like(a_)
    for k in reversed(range(-(-T // chunk))):
        t0, t1 = k * chunk, min((k + 1) * chunk, T)
        states, decays = [h_traj[:, k].to(F32)], []
        for t in range(t0, t1):
            decays.append(torch.exp(dt_[:, t, :, None] * a_))
            states.append(decays[-1] * states[-1] + (dt_[:, t] * x_[:, t])[
                ..., None] * b_[:, t, None, :])
        for t in reversed(range(t0, t1)):
            i = t - t0
            g = g + dy_[:, t, :, None] * c_[:, t, None, :]
            gb = (g * b_[:, t, None, :]).sum(-1)
            gha = g * states[i] * decays[i]          # g_t h_{t-1} a_t
            dx[:, t] = dt_[:, t] * gb
            ddt[:, t] = (gha * a_).sum(-1) + x_[:, t] * gb
            da += (gha * dt_[:, t, :, None]).sum(0)
            db[:, t] = (g * (dt_[:, t] * x_[:, t])[..., None]).sum(1)
            dc[:, t] = (dy_[:, t, :, None] * states[i + 1]).sum(1)
            g = decays[i] * g
    return dx.to(x.dtype), ddt, db, dc, da, g


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------
def _entry(lib_name: str, symbol: str, n_ptrs: int, n_ints: int = 7):
    """A C entry point taking ``n_ptrs`` pointers, then B, T, d_inner,
    d_state, chunk, block_b, di_tile (and for the forward its path), the
    shared-memory bytes and the stream."""
    lib = _build.load(lib_name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _io_suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


def _validate(x, dt, b, c, a, h) -> None:
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError(f"mamba_scan takes (B, T, d) tensors; x "
                         f"{tuple(x.shape)}, b {tuple(b.shape)}")
    B, T, di = x.shape
    ds = b.shape[-1]
    if dt.shape != x.shape or b.shape[:2] != (B, T) or c.shape != b.shape \
            or a.shape != (di, ds) or h.shape != (B, di, ds):
        raise ValueError(f"mamba_scan shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, a {tuple(a.shape)}, state "
                         f"{tuple(h.shape)}")
    for name, t in (("dt", dt), ("b", b), ("c", c), ("a", a), ("state", h)):
        if t.device != x.device:
            raise ValueError(f"mamba_scan: {name} is on {t.device}, x on "
                             f"{x.device}")


def _card_smem(what: str, mode: str, x, ds: int, chunk: int, di_tile: int,
               *io) -> int:
    """Check a launch on the card -- device, one IO dtype for x and ``io``,
    states a thread can hold, a tile the kernel of ``mode`` takes (a power
    of two of channels from one warp to ``DI_TILE`` for K7/K7t, from 8 to
    ``BWD_DI_TILE`` for K7b) -- and return its shared memory."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if any(t.dtype != x.dtype for t in io) or x.dtype not in _IO_DTYPES:
        raise TypeError(f"{what} on the card takes x{' and dy' if io else ''}"
                        f" in one dtype, float32 or bfloat16; got "
                        f"{[t.dtype for t in (x, *io)]}")
    smem = working_set_bytes(x.shape[1], ds, chunk, di_tile, mode,
                             io_bytes=x.element_size())
    low, high = (factorization.WARP, DI_TILE) if mode == "fwd" \
        else (8, BWD_DI_TILE)
    tile_ok = low <= di_tile <= high and not di_tile & (di_tile - 1)
    if ds > MAX_DS or not tile_ok \
            or smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"{what}: d_state {ds} (at most {MAX_DS}), di_tile "
                         f"{di_tile} at chunk {chunk} need {smem} bytes of "
                         f"shared memory (at most "
                         f"{factorization.H100_SMEM_PER_BLOCK})")
    return smem


def _resolve(x, chunk: int, block_b: int, di_tile: int | None,
             mode: str = "fwd") -> tuple[int, int, int]:
    """The clamps: chunk to [1, T], block_b to [1, B], di_tile (None: the
    widest tile d_inner needs for the kernel of ``mode``)."""
    B, T, di = x.shape
    if di_tile is None:
        di_tile = _tiles(di)[0] if mode == "fwd" else _bwd_tile(di)
    return max(1, min(chunk, T)), max(1, min(block_b, B)), di_tile


def _launch_fwd(x, dt, b, c, a, h0, chunk: int, block_b: int, di_tile: int,
                traj: bool, one_phase: bool | None = None
                ) -> tuple[torch.Tensor, ...]:
    """One launch of csrc/mamba_scan.cu: K7, or with ``traj`` K7t.  At
    T = 1 the one-phase path runs unless ``one_phase`` is False (the
    general path, which ``chip_smoke.py`` holds it to bit for bit)."""
    what = "mamba_scan_traj" if traj else "mamba_scan"
    B, T, di = x.shape
    ds = b.shape[-1]
    smem = _card_smem(what, "fwd", x, ds, chunk, di_tile)
    one_phase = T == 1 if one_phase is None else one_phase
    if one_phase and T != 1:
        raise ValueError(f"{what}: the one-phase path takes T = 1, not {T}")
    if not one_phase:
        smem = _fwd_ring(chunk, di_tile, x.element_size())
    x = x.contiguous()
    dt, b, c, a, h0 = (t.to(F32).contiguous() for t in (dt, b, c, a, h0))
    outs = [torch.empty_like(x), torch.empty(B, di, ds, dtype=F32,
                                             device=x.device)]
    if traj:
        outs.append(torch.empty(B, -(-T // chunk), di, ds, dtype=F32,
                                device=x.device))
    ptrs = [x, dt, b, c, a, h0, *outs]
    lib, fn = _entry("mamba_scan", f"{what}_{_io_suffix(x.dtype)}",
                     len(ptrs), n_ints=8)
    err = fn(*(t.data_ptr() for t in ptrs), B, T, di, ds, chunk, block_b,
             di_tile, int(one_phase), smem,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "mamba_scan", err)
    return tuple(outs)


def mamba_scan_traj(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor, *,
                    chunk: int = 16, block_b: int = 1,
                    di_tile: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7t: K7's launch with one more output — ONE kernel launch, any T
    and B.  Returns (y, final state, h_traj): y and the final state are
    bit-identical to ``mamba_scan``'s; ``h_traj (B, ceil(T / chunk), di,
    ds)`` f32 holds the state each chunk starts from.  The CPU runs
    ``mamba_scan_traj_plain``."""
    _validate(x, dt, b, c, a, h0)
    chunk, block_b, di_tile = _resolve(x, chunk, block_b, di_tile)
    if x.device.type == "cpu":
        return mamba_scan_traj_plain(x, dt, b, c, a, h0, chunk)
    outs = _launch_fwd(x, dt, b, c, a, h0, chunk, block_b, di_tile,
                       traj=True)
    mamba_scan_traj.launches += 1
    return outs


def mamba_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h_traj: torch.Tensor,
                   dy: torch.Tensor, dh_fin: torch.Tensor, *,
                   chunk: int = 16, block_b: int = 1,
                   di_tile: int | None = None) -> tuple[torch.Tensor, ...]:
    """K7b: the whole reverse sweep of the scan — ONE kernel launch.

    Takes the forward's inputs, its chunk-incoming states ``h_traj``
    (``mamba_scan_traj``'s at the same ``chunk``) and the cotangents ``dy``
    (B, T, di) of y and ``dh_fin`` (B, di, ds) of the final state.
    Returns (dx in x's dtype, ddt, db, dc, da, dh0 f32).  On the card x and
    dy share one dtype, float32 or bfloat16.  The CPU runs
    ``mamba_scan_bwd_plain``."""
    _validate(x, dt, b, c, a, dh_fin)
    B, T, di = x.shape
    ds = b.shape[-1]
    chunk, block_b, di_tile = _resolve(x, chunk, block_b, di_tile, "bwd")
    nt = -(-T // chunk)
    if h_traj.shape != (B, nt, di, ds) or dy.shape != x.shape:
        raise ValueError(f"mamba_scan_bwd shapes: h_traj "
                         f"{tuple(h_traj.shape)} (want {(B, nt, di, ds)}), "
                         f"dy {tuple(dy.shape)}")
    if any(t.device != x.device for t in (h_traj, dy)):
        raise ValueError("mamba_scan_bwd: every tensor must be on x's device")
    if x.device.type == "cpu":
        return mamba_scan_bwd_plain(x, dt, b, c, a, h_traj, dy, dh_fin,
                                    chunk)
    smem = _card_smem("mamba_scan_bwd", "bwd", x, ds, chunk, di_tile, dy)
    x, dy = x.contiguous(), dy.contiguous()
    dt, b, c, a, h_traj, dh_fin = (t.to(F32).contiguous() for t in (
        dt, b, c, a, h_traj, dh_fin))
    grads = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(b),
             torch.empty_like(c), torch.empty_like(a),
             torch.empty_like(dh_fin))
    n_dtiles, n_rowtiles = -(-di // di_tile), -(-B // block_b)
    n_groups = -(-n_dtiles // BWD_GROUP)
    # workspaces: each block's dB/dC sums of each chunk step (32 words, dB
    # then dC, a step), then each group's, and its dA; a ticket per (row,
    # chunk, group), per (row, chunk) and per tile
    parts = torch.empty(B * nt * (n_dtiles + n_groups) * chunk * 32,
                        dtype=F32, device=x.device)
    da_parts = torch.empty(n_rowtiles * di * ds, dtype=F32, device=x.device)
    tickets = torch.zeros(B * nt * (n_groups + 1) + n_dtiles,
                          dtype=torch.int32, device=x.device)
    ptrs = (x, dt, b, c, a, h_traj, dy, dh_fin, *grads, parts, da_parts,
            tickets)
    lib, fn = _entry("mamba_scan_bwd",
                     f"mamba_scan_bwd_{_io_suffix(x.dtype)}", len(ptrs))
    err = fn(*(t.data_ptr() for t in ptrs), B, T, di, ds, chunk, block_b,
             di_tile, smem, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "mamba_scan_bwd", err)
    mamba_scan_bwd.launches += 1
    return grads


def fwd_blocks_per_sm(dtype: torch.dtype, seq_len: int, d_state: int,
                      chunk: int, di_tile: int, traj: bool = False) -> int:
    """K7 (K7t with ``traj``) blocks one SM holds at once at this launch,
    as the CUDA runtime's occupancy calculator sees the kernel of the path
    it takes (the one-phase kernel at T = 1; the card only)."""
    io = torch.tensor([], dtype=dtype).element_size()
    smem = working_set_bytes(seq_len, d_state, chunk, di_tile, "fwd",
                             io_bytes=io)
    lib = _build.load("mamba_scan")
    fn = lib.mamba_scan_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong]
    n = fn(io, int(traj), int(seq_len == 1), di_tile, smem)
    if n < 0:
        _build.check(lib, "mamba_scan", -n)
    return n


def bwd_blocks_per_sm(dtype: torch.dtype, seq_len: int, d_state: int,
                      chunk: int, di_tile: int) -> int:
    """K7b blocks one SM holds at once at this launch's shared memory, as
    the CUDA runtime's occupancy calculator sees the kernel (the card
    only)."""
    io = torch.tensor([], dtype=dtype).element_size()
    smem = working_set_bytes(seq_len, d_state, chunk, di_tile, "bwd",
                             io_bytes=io)
    lib = _build.load("mamba_scan_bwd")
    fn = lib.mamba_scan_bwd_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    n = fn(io, di_tile, smem)
    if n < 0:
        _build.check(lib, "mamba_scan_bwd", -n)
    return n


class _MambaFn(torch.autograd.Function):
    """The scan under autograd (the JAX package's ``custom_vjp``): the
    forward is K7t, keeping the chunk-incoming states as the residual, the
    backward is K7b — 2 launches per gradient.  Gradients come back in the
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, h0, chunk, block_b, di_tile):
        y, h_out, h_traj = mamba_scan_traj(x, dt, b, c, a, h0, chunk=chunk,
                                           block_b=block_b, di_tile=di_tile)
        ctx.save_for_backward(x, dt, b, c, a, h_traj)
        ctx.tiling, ctx.h0_dtype = (chunk, block_b, di_tile), h0.dtype
        return y, h_out

    @staticmethod
    def backward(ctx, dy, dh_fin):
        x, dt, b, c, a, h_traj = ctx.saved_tensors
        chunk, block_b, di_tile = ctx.tiling
        grads = mamba_scan_bwd(x, dt, b, c, a, h_traj, dy, dh_fin,
                               chunk=chunk, block_b=block_b,
                               di_tile=di_tile)
        dtypes = (x.dtype, dt.dtype, b.dtype, c.dtype, a.dtype, ctx.h0_dtype)
        return (*(g.to(d) for g, d in zip(grads, dtypes)), None, None, None)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor, *,
               chunk: int = 16, block_b: int | None = None,
               di_tile: int | None = None, bwd: int = FUSED_BWD
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan over full sequences — ONE kernel launch (K7).

    x, dt: (B, T, di); b, c: (B, T, ds); a: (di, ds) (= -exp(a_log));
    h0: (B, di, ds).  Any T and B: the JAX entry's clamps (``chunk`` to T,
    ``block_b`` to B; None is one row a block, where JAX takes the whole
    batch: the rows spread over the SMs); the last chunk and the last batch
    tile may be short.  Returns (y (B, T, di) in x's
    dtype, final state (B, di, ds) f32).  On the card x is float32 or
    bfloat16; dt, b, c, a and h0 are taken in f32.

    Differentiable: when autograd would record the call, it runs
    ``_MambaFn`` — K7t forward and K7b backward, 2 launches per gradient —
    at the caller's tiling, which a training caller takes from
    ``choose_blocks(mode="bwd")``; with ``bwd=ORACLE_BWD`` a CPU call
    differentiates the plain scan instead, and a CUDA call raises (no
    plain version stands in for K7b on the card)."""
    _validate(x, dt, b, c, a, h0)
    B, T, _ = x.shape
    chunk, block_b, di_tile = _resolve(x, chunk, block_b or 1, di_tile)
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
        tracer.event("plan/dispatch", family="mamba", plan="fused_scan",
                     chunk=chunk, block_b=block_b, di_tile=di_tile, bwd=bwd,
                     batch=B, seq_len=T)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, b, c, a, h0)):
        if bwd == ORACLE_BWD:
            if x.device.type != "cpu":
                raise ValueError("mamba_scan: bwd=ORACLE_BWD differentiates "
                                 "the plain scan, which runs on the CPU only")
            y, h_out = mamba_scan_plain(x, dt, b, c, a, h0, chunk)
        else:
            y, h_out = _MambaFn.apply(x, dt, b, c, a, h0, chunk, block_b,
                                      di_tile)
    elif x.device.type == "cpu":
        y, h_out = mamba_scan_plain(x, dt, b, c, a, h0, chunk)
    else:
        y, h_out = _launch_fwd(x, dt, b, c, a, h0, chunk, block_b, di_tile,
                               traj=False)
        mamba_scan.launches += 1
    return y, h_out


#: kernel launches since the last reset (CPU calls are not counted)
mamba_scan.launches = 0
mamba_scan_traj.launches = 0
mamba_scan_bwd.launches = 0
