"""RWKV6 chunked-scan kernel (K6): wrapper, budget table, launch counter and
plain version.

Replaces the JAX package's Pallas kernel ``kernels/wkv6.py:_kernel`` (body
``_fwd_body``, chunk math ``_chunk_math``), launched by ``_fwd_call``, with
the CUDA C++ kernel in ``csrc/wkv6.cu``: MobiRNN's coarse work-unit
factorization applied to the RWKV6 recurrence.  Instead of T tiny state
updates (``ref.wkv6_stepwise``) the sequence runs in chunks of C steps;
within a chunk everything is dense arithmetic on shared-memory tiles, and
only the f32 (dk, dv) state crosses chunk boundaries — it stays in shared
memory for the whole scan and never round-trips to device memory (the
paper's preallocated-state-reuse rule).  What bounds the kernel on the H100
and what its design does about it is written at the top of the CUDA source.

Numerical safety: every exponent the chunk math takes is a difference
``L_a - L_b`` (a >= b) of a running log-decay cumsum, hence <= 0 — no exp
overflow whatever the decay (``logw <= 0``); the masked scores are never
computed.  Non-dividing T runs identity steps (r = k = v = 0, logw = 0)
inside the kernel past the end.

Tiling: ``WkvBlocks(chunk, bh_tile)`` presents the family-generic
``core/tiling.TilePlan`` interface.  A thread block runs the ``bh_tile``
rows of its tile one after another, each exactly as it would run alone, so
a row's results are bit-identical at any ``bh_tile`` (the JAX contract of
``bh_tile``).  ``choose_blocks`` keeps the chunk as coarse as the
shared-memory budget allows and one row per block, which spreads the rows
over the H100's 132 SMs — unlike the JAX search, which seeds ``bh_tile`` at
every row because a TPU core runs the grid in order.

A tensor on the CPU takes ``wkv6_plain``; a tensor on the card launches the
kernel or raises.  ``wkv6.launches`` counts kernel launches and nothing
else.  There is no backward kernel yet (K6b): a CUDA call that autograd
would record raises, and a CPU call differentiates the plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build, ref
from repro_torch.obs import trace as trace_lib

_NAME = "wkv6"
#: threads of one block (csrc/wkv6.cu kThreads): dk and dv must not exceed it
THREADS = 256
_IO_DTYPES = (torch.float32, torch.bfloat16)


class WkvBlocks(NamedTuple):
    """The chunked-scan kernel's tiling decision: chunk length x BH tile.

    ``chunk`` is the work-unit coarseness of the WKV6 plan — a larger C
    means fewer sequential chunk steps (T/C) at the price of the (C, C)
    scores and the (C, dk) tiles in shared memory.  ``bh_tile`` is how
    many batch-head rows one thread block runs, one after another.

    Presents ``core/tiling.TilePlan``: ``batch_tile`` is ``bh_tile`` (fused
    B*H rows), ``time_chunk`` is ``chunk`` (the kernel always streams time,
    so it is never None)."""
    chunk: int
    bh_tile: int = 1

    @property
    def batch_tile(self) -> int:
        return self.bh_tile

    @property
    def time_chunk(self) -> int:
        return self.chunk


def working_set_bytes(seq_len: int, dk: int, dv: int, chunk: int,
                      mode: str = "fwd") -> int:
    """Dynamic shared memory of one thread block, exactly as the kernel
    launches it (the C side refuses a launch priced otherwise).

    All terms are f32 whatever the IO dtype: the r, k, L and L_prev tiles,
    (C, dk) with each row padded by one word so that a warp reading
    down a column hits distinct banks; v (C, dv); the (C, C) scores,
    summed over dk in registers (the JAX table prices a (C, C, dk) tensor,
    which would be 256 KiB at C=32, dk=64); the carried (dk, dv) state; u
    and the per-step bonus.  It does not grow with ``bh_tile``: a block
    runs its rows one after another.  ``mode="bwd"`` would price the
    backward kernel, K6b, which is not ported yet."""
    if tiling.check_mode(mode) == "bwd":
        raise NotImplementedError("the wkv6 backward kernel (K6b) is not "
                                  "ported yet")
    C = max(1, min(chunk, seq_len))
    ws = tiling.WorkingSet(mode)
    ws.add("tiles", 4 * C * (dk + 1) * 4)     # r, k, L, L_prev
    ws.add("v", C * dv * 4)
    ws.add("scores", C * C * 4)
    ws.add("state", dk * dv * 4)
    ws.add("u", dk * 4)
    ws.add("bonus", C * 4)
    return ws.total()


def choose_blocks(seq_len: int, dk: int, dv: int, *, target: int = 32,
                  smem_budget: int | None = None) -> WkvBlocks | None:
    """Pick ``(chunk, bh_tile)``, or None when no chunk fits.

    The chunk halves from ``target`` (clamped to T) until the working set
    fits ``smem_budget`` (a thread block's shared memory by default); the
    BH tile is one row, so BH rows make BH blocks over the SMs, whatever
    BH is (the JAX search also takes the row count, to seed its tile at
    all of them).  None when even C=1 does not fit — the (dk, dv) state
    itself is too large — or a head is wider than a block has threads;
    the plan then routes to ``chunked_xla``."""
    budget = factorization.H100_SMEM_PER_BLOCK if smem_budget is None \
        else smem_budget
    if max(dk, dv) > THREADS:
        return None
    for c in tiling.halving(max(1, min(target, seq_len))):
        if working_set_bytes(seq_len, dk, dv, c) <= budget:
            return WkvBlocks(c, 1)
    return None


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
               chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (the JAX package's ``_oracle``): the batched
    ``ref.wkv6`` over chunks of ``chunk`` steps, T zero-padded at the end
    with identity steps, with the kernel's output dtypes — the CPU path of
    ``wkv6`` and the yardstick the kernel is held to."""
    T = r.shape[1]
    chunk = max(1, min(chunk, T))
    pad = (-T) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, pad)) for a in (r, k, v, logw))
    out, s_out = ref.wkv6(r, k, v, logw, u, state, chunk)
    return out[:, :T].to(v.dtype), s_out.to(torch.float32)


def _entry(dtype: torch.dtype):
    lib = _build.load(_NAME)
    fn = lib.wkv6_f32 if dtype == torch.float32 else lib.wkv6_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _validate(r, k, v, logw, u, state) -> None:
    if r.dim() != 3 or v.dim() != 3:
        raise ValueError(f"wkv6 takes (BH, T, d) tensors; r {tuple(r.shape)},"
                         f" v {tuple(v.shape)}")
    BH, T, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or logw.shape != r.shape \
            or v.shape[:2] != (BH, T) or u.shape != (BH, dk) \
            or state.shape != (BH, dk, dv):
        raise ValueError(f"wkv6 shapes: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}, state "
                         f"{tuple(state.shape)}")
    for name, t in (("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("state", state)):
        if t.device != r.device:
            raise ValueError(f"wkv6: {name} is on {t.device}, r on "
                             f"{r.device}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
         chunk: int = 32, bh_tile: int = 1
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked RWKV6 scan over full sequences — ONE kernel launch.

    r, k, logw: (BH, T, dk); v: (BH, T, dv); u: (BH, dk); state:
    (BH, dk, dv).  Any T and BH; ``chunk`` is clamped to T and ``bh_tile``
    to BH.  Returns (out (BH, T, dv) in v's dtype, final state (BH, dk, dv)
    f32).  On the card r, k and v share one dtype, float32 or bfloat16;
    logw, u and the state are taken in f32."""
    _validate(r, k, v, logw, u, state)
    BH, T, dk = r.shape
    dv = v.shape[-1]
    chunk = max(1, min(chunk, T))
    bh_tile = max(1, min(bh_tile, BH))
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
        tracer.event("plan/dispatch", family="rwkv6", plan="chunked_scan",
                     chunk=chunk, bh_tile=bh_tile, n_bh=BH, seq_len=T)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, state, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cpu or cuda, not {r.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, state)):
        raise NotImplementedError("wkv6 has no backward kernel yet (K6b); "
                                  "a CUDA call under autograd cannot run")
    if not (r.dtype == k.dtype == v.dtype) or v.dtype not in _IO_DTYPES:
        raise TypeError(f"wkv6 on the card takes r, k, v of one dtype, "
                        f"float32 or bfloat16; got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    smem = working_set_bytes(T, dk, dv, chunk)
    if max(dk, dv) > THREADS or smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"wkv6: heads of {dk} x {dv} at chunk {chunk} need "
                         f"{smem} bytes of shared memory (at most "
                         f"{factorization.H100_SMEM_PER_BLOCK}) and at most "
                         f"{THREADS} per side")
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    logw, u, state = (t.to(torch.float32).contiguous()
                      for t in (logw, u, state))
    out = torch.empty_like(v)
    s_out = torch.empty_like(state)
    lib, fn = _entry(v.dtype)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
             u.data_ptr(), state.data_ptr(), out.data_ptr(),
             s_out.data_ptr(), BH, T, dk, dv, chunk, bh_tile, smem,
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, _NAME, err)
    wkv6.launches += 1
    return out, s_out


#: kernel launches since the last reset (CPU calls are not counted)
wkv6.launches = 0
