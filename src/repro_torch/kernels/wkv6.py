"""RWKV6 chunked-scan kernels (K6, K6t, K6b): wrappers, budget tables,
launch counters, plain versions and the autograd Function.

Replaces the JAX package's Pallas kernels ``kernels/wkv6.py:_kernel`` and
``_traj_kernel`` (body ``_fwd_body``, chunk math ``_chunk_math``, launched
by ``_fwd_call``) with the CUDA C++ kernel in ``csrc/wkv6.cu``, and its
``_bwd_kernel`` (launched by ``_bwd_call``) with ``csrc/wkv6_bwd.cu``:
MobiRNN's coarse work-unit factorization applied to the RWKV6 recurrence.
Instead of T tiny state updates (``ref.wkv6_stepwise``) the sequence runs
in chunks of C steps; within a chunk everything is dense arithmetic on
shared-memory tiles, and only the f32 (dk, dv) state crosses chunk
boundaries — it stays in shared memory for the whole scan and never
round-trips to device memory (the paper's preallocated-state-reuse rule).
What bounds each kernel on the H100 and what its design does about it is
written at the top of its CUDA source.

Three launches:
  * ``wkv6`` (K6): out and the final state, one launch;
  * ``wkv6_traj`` (K6t): the same launch of the same kernel with one more
    output, the chunk-incoming states ``s_traj (BH, nt, dk, dv)`` f32 —
    the residual the backward recomputes each chunk from; its out and
    final state are bit-identical to K6's;
  * ``wkv6_bwd`` (K6b): the whole reverse sweep in one launch, chunks in
    reverse order, the state cotangent carried in shared memory.
The JAX package differentiates its chunk math with ``jax.vjp`` inside the
backward kernel; CUDA has nothing like it, so the chunk backward is derived
by hand (``wkv6_bwd_plain`` writes it out in plain PyTorch, the kernel
computes the same sums).  Per chunk, with ``L = cumsum(logw)``, ``Lp = L -
logw``, ``A_ij = sum_c r_ic k_jc e^{Lp_ic - L_jc}`` (j < i), ``b_i = sum_c
r_ic u_c k_ic`` and the cotangents dO and dS' of the chunk's output and
outgoing state:
  dA_ij = dO_i . v_j (j < i),  db_i = dO_i . v_i
  dv_j  = sum_{i>j} A_ij dO_i + b_j dO_j + sum_c k_jc e^{Llast_c - L_jc} dS'_c
  dr_ic = e^{Lp_ic} (S dO_i)_c + sum_{j<i} dA_ij k_jc e^{Lp_ic - L_jc}
          + db_i u_c k_ic
  dk_jc = sum_{i>j} dA_ij r_ic e^{Lp_ic - L_jc} + db_j u_c r_jc
          + e^{Llast_c - L_jc} (v_j . dS'_c)
  du_c += sum_i db_i r_ic k_ic
  dS    = e^{Llast} * dS' + (r * e^{Lp})^T dO     (dS' of the chunk before)
and the log-decays by the rule that an exponent's gradient is its input
times that input's gradient, bonus terms excluded: ``gLp = r * (dr - db u
k)``, ``gL = -k * (dk - db u r)``, plus ``sum_n S'_cn dS'_cn`` on row C-1
(``Llast``'s own term, S' the state the chunk hands on), then ``dlogw_m =
sum_{i>=m} gL_i + sum_{i>m} gLp_i``.

Numerical safety: every exponent the chunk math takes is a difference
``L_a - L_b`` (a >= b) of a running log-decay cumsum, hence <= 0 — no exp
overflow whatever the decay (``logw <= 0``); the masked scores are never
computed, forward or backward.  The kernels take the intra-chunk decays
through sub-chunks of ``SUB_CHUNK`` steps (``csrc/wkv6_math.cuh``): across
sub-chunks as a product of three such exponents' exps, pairwise only
within one; the plain versions compute the same with ``sub_chunk``, and
pairwise by default, the yardstick.  Non-dividing T runs identity steps
(r = k = v = 0, logw = 0) inside the kernels past the end.

Tiling: ``WkvBlocks(chunk, bh_tile)`` presents the family-generic
``core/tiling.TilePlan`` interface.  A thread block runs the ``bh_tile``
rows of its tile one after another, each exactly as it would run alone, so
a row's results are bit-identical at any ``bh_tile`` (the JAX contract of
``bh_tile``).  ``choose_blocks`` keeps the chunk as coarse as the
shared-memory budget of the launch allows and one row per block, which
spreads the rows over the H100's 132 SMs — unlike the JAX search, which
seeds ``bh_tile`` at every row because a TPU core runs the grid in order.
A training call takes its chunk from the backward's table (``mode="bwd"``)
for both launches: the backward re-reads the states the forward wrote at
its own chunk boundaries.

A tensor on the CPU takes the plain versions; a tensor on the card
launches the kernels or raises.  Each wrapper's ``launches`` counts its
kernel launches and nothing else.  ``wkv6`` under autograd runs
``_Wkv6Fn``: K6t forward, K6b backward (on the CPU: ``wkv6_traj_plain``
and ``wkv6_bwd_plain``); with no input needing a gradient it is K6 alone.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build, called, meta_like, ref
from repro_torch.obs import trace as trace_lib

F32 = torch.float32
#: threads of one block (csrc/wkv6.cu and csrc/wkv6_bwd.cu kThreads): dk
#: and dv must not exceed it
THREADS = 256
#: steps of a sub-chunk (csrc/wkv6_math.cuh kSub): the intra-chunk decays
#: factor through sub-chunk boundaries; only the diagonal sub-blocks keep
#: the pairwise exponent
SUB_CHUNK = 8
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
    """Dynamic shared memory of one thread block, exactly as the kernel of
    ``mode`` launches it (``csrc/wkv6_math.cuh: layout``; the C side
    refuses a launch priced otherwise).

    Every term is f32 whatever the IO dtype (the windows are converted as
    they are read); (rows, d) tiles pad each row by one word, so that a
    warp reading down a column hits distinct banks.

    ``mode="fwd"`` prices K6 and K6t: seven (C, dk) tiles (r, k, L, r *
    alpha, k * beta, r * e^{Lp}, k * e^{Llast - L}); v (C, dv); the scores
    A (C, C); the carried (dk, dv) state; gamma, one dk row per pair of
    sub-chunks (``SUB_CHUNK`` steps each); u and the bonus.

    ``mode="bwd"`` prices K6b: seven (C, dk) tiles (r, k, L, r * alpha and
    k * beta, which later hold r * e^{Lp} and k * e^{Llast - L}, and the dr
    and dk partials); v and dO; A with dA transposed in its upper triangle;
    the chunk's incoming state and the carried state cotangent; gamma; u,
    Llast's term (two), du, the bonus and db.

    Neither grows with ``bh_tile``: a block runs its rows one after
    another."""
    mode = tiling.check_mode(mode)
    bwd = mode == "bwd"
    C = max(1, min(chunk, seq_len))
    pk, pv, pc = dk + 1, dv + 1, C + 1
    s = min(SUB_CHUNK, C)
    ns = -(-C // s)
    ws = tiling.WorkingSet(mode)
    ws.add("tiles", 7 * C * pk * 4)
    ws.add("v_dout" if bwd else "v", (2 if bwd else 1) * C * pv * 4)
    ws.add("scores", C * pc * 4)
    ws.add("states" if bwd else "state", (2 if bwd else 1) * dk * pv * 4)
    ws.add("gamma", ns * (ns - 1) // 2 * pk * 4)
    ws.add("vectors", ((4 * dk + 2 * C) if bwd else (dk + C)) * 4)
    return ws.total()


def choose_blocks(seq_len: int, dk: int, dv: int, *, target: int = 32,
                  smem_budget: int | None = None,
                  mode: str = "fwd") -> WkvBlocks | None:
    """Pick ``(chunk, bh_tile)`` for the kernel of ``mode``, or None when
    no chunk fits.

    The chunk halves from ``target`` (clamped to T) until the working set
    of ``mode`` fits ``smem_budget`` (a thread block's shared memory by
    default); the BH tile is one row, so BH rows make BH blocks over the
    SMs, whatever BH is (the JAX search also takes the row count, to seed
    its tile at all of them).  None when even C=1 does not fit — the
    (dk, dv) state itself is too large — or a head is wider than a block
    has threads; the plan then routes to ``chunked_xla`` on the CPU and
    raises on the card.  ``mode="bwd"`` is the training decision: its
    chunk serves the training forward (K6t) and the backward (K6b)."""
    budget = factorization.H100_SMEM_PER_BLOCK if smem_budget is None \
        else smem_budget
    if max(dk, dv) > THREADS:
        return None
    for c in tiling.halving(max(1, min(target, seq_len))):
        if working_set_bytes(seq_len, dk, dv, c, mode=mode) <= budget:
            return WkvBlocks(c, 1)
    return None


# ---------------------------------------------------------------------------
# Plain versions: the CPU path of the wrappers and the kernels' yardsticks
# ---------------------------------------------------------------------------
def _pad_time(chunk: int, *ts: torch.Tensor) -> list[torch.Tensor]:
    """Zero-pad the time axis (dim 1) of each (BH, T, d) tensor to a
    multiple of ``chunk``: identity steps, as the kernels run them."""
    pad = (-ts[0].shape[1]) % chunk
    return [F.pad(t, (0, 0, 0, pad)) if pad else t for t in ts]


def _exp_le0(x: torch.Tensor) -> torch.Tensor:
    """e^x of an exponent that is <= 0 in exact arithmetic, clamped at 0
    as the kernels take it (``exp_le0``)."""
    return torch.exp(torch.clamp(x, max=0.0))


def _exclusive(L: torch.Tensor) -> torch.Tensor:
    """L_{i-1} down the time axis (dim 1), 0 at the first step: the kernels'
    L_prev, a cumsum itself rather than L - logw."""
    return F.pad(L[:, :-1], (0, 0, 1, 0))


def _intra_decay(L: torch.Tensor, Lp: torch.Tensor,
                 sub_chunk: int | None) -> torch.Tensor:
    """The intra-chunk decays ``e^{Lp_ic - L_jc}`` (BH, C, C, dk) for
    j < i, 0 elsewhere.  ``sub_chunk`` None takes each pairwise (the
    exponent masked to -inf above the diagonal); an int takes them as the
    kernels do (``csrc/wkv6_math.cuh``): within a sub-chunk pairwise, across
    sub-chunks as ``alpha_i * gamma_IJ * beta_j`` through the step before
    i's sub-chunk and the last step of j's, every exponent clamped at 0."""
    C = L.shape[1]
    idx = torch.arange(C, device=L.device)
    strict = idx[:, None] > idx[None, :]
    if sub_chunk is None:
        diff = torch.where(strict[..., None],
                           Lp[:, :, None, :] - L[:, None, :, :], -torch.inf)
        return torch.exp(diff)
    s = max(1, min(sub_chunk, C))
    sub = idx // s
    before = torch.clamp(sub * s - 1, min=0)       # b_I, the step before I
    last = torch.clamp((sub + 1) * s, max=C) - 1   # e_J, J's last step
    alpha = _exp_le0(Lp - L[:, before])
    beta = _exp_le0(L[:, last] - L)
    gamma = _exp_le0(L[:, before][:, :, None, :] - L[:, last][:, None, :, :])
    across = alpha[:, :, None, :] * gamma * beta[:, None, :, :]
    within = _exp_le0(Lp[:, :, None, :] - L[:, None, :, :])
    same = (sub[:, None] == sub[None, :])[..., None]
    return torch.where(strict[..., None],
                       torch.where(same, within, across), 0.0)


def _chunk_fwd(r, k, v, logw, u, S, sub_chunk: int):
    """One chunk of the recurrence as the kernels compute it, f32, batched
    over the rows: the factored decays of ``_intra_decay`` and clamped
    exponents.  Returns (out (BH, C, dv), the outgoing state)."""
    L = torch.cumsum(logw, dim=1)
    Lp = _exclusive(L)
    A = torch.einsum("bic,bjc,bijc->bij", r, k, _intra_decay(L, Lp,
                                                             sub_chunk))
    bonus = torch.einsum("bic,bc,bic->bi", r, u, k)
    out = (r * _exp_le0(Lp)) @ S + A @ v + bonus[..., None] * v
    L_last = L[:, -1]
    S_new = (_exp_le0(L_last)[..., None] * S
             + (k * _exp_le0(L_last[:, None] - L)).transpose(1, 2) @ v)
    return out, S_new


def _scan_sub(r, k, v, logw, u, state, chunk: int, sub_chunk: int):
    """``ref.wkv6_traj`` through ``_chunk_fwd``: (out, state', s_traj)."""
    r, k, v, logw = (t.to(F32) for t in _pad_time(chunk, r, k, v, logw))
    u, s = u.to(F32), state.to(F32)
    outs, traj = [], []
    for t0 in range(0, r.shape[1], chunk):
        win = slice(t0, t0 + chunk)
        traj.append(s)
        out, s = _chunk_fwd(r[:, win], k[:, win], v[:, win], logw[:, win],
                            u, s, sub_chunk)
        outs.append(out)
    return torch.cat(outs, dim=1), s, torch.stack(traj, dim=1)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
               chunk: int, sub_chunk: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K6 (the JAX package's ``_oracle``): the
    batched ``ref.wkv6`` over chunks of ``chunk`` steps, T zero-padded at
    the end with identity steps, with the kernel's output dtypes — the CPU
    path of ``wkv6`` and the yardstick the kernel is held to.  With
    ``sub_chunk`` the intra-chunk decays are taken as the kernel takes them
    (``_intra_decay``), sub-chunks of that many steps."""
    T = r.shape[1]
    chunk = max(1, min(chunk, T))
    if sub_chunk is None:
        out, s_out = ref.wkv6(*_pad_time(chunk, r, k, v, logw), u, state,
                              chunk)
    else:
        out, s_out, _ = _scan_sub(r, k, v, logw, u, state, chunk, sub_chunk)
    return out[:, :T].to(v.dtype), s_out.to(F32)


def wkv6_traj_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                    chunk: int, sub_chunk: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K6t: ``ref.wkv6_traj`` on the padded sequence —
    ``wkv6_plain``'s outputs plus the chunk-incoming states ``s_traj (BH,
    ceil(T / chunk), dk, dv)`` f32; ``sub_chunk`` as in ``wkv6_plain``."""
    T = r.shape[1]
    chunk = max(1, min(chunk, T))
    if sub_chunk is None:
        out, s_out, s_traj = ref.wkv6_traj(*_pad_time(chunk, r, k, v, logw),
                                           u, state, chunk)
    else:
        out, s_out, s_traj = _scan_sub(r, k, v, logw, u, state, chunk,
                                       sub_chunk)
    return out[:, :T].to(v.dtype), s_out.to(F32), s_traj


def wkv6_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, s_traj: torch.Tensor,
                   s_fin: torch.Tensor, dout: torch.Tensor,
                   ds_fin: torch.Tensor, chunk: int,
                   sub_chunk: int | None = None) -> tuple[torch.Tensor, ...]:
    """The plain version of K6b: the hand-derived chunk backward of the
    module docstring, chunks in reverse order, f32, batched over the BH
    rows.  ``s_traj`` holds the chunk-incoming states (``wkv6_traj``'s),
    ``s_fin`` the final state; the state each chunk hands on is the next
    chunk's incoming one, or ``s_fin`` for the last.  Returns (dr, dk, dv)
    in r's, k's and v's dtypes and (dlogw, du, ds0) f32.  With
    ``sub_chunk`` the intra-chunk decays are taken as the kernel takes
    them (``_intra_decay``) and every exponent is clamped at 0."""
    BH, T, dk = r.shape
    chunk = max(1, min(chunk, T))
    r_, k_, v_, w_, do_ = (t.to(F32) for t in _pad_time(
        chunk, r, k, v, logw, dout))
    u_ = u.to(F32)
    nt = r_.shape[1] // chunk
    ds = ds_fin.to(F32)
    du = torch.zeros(BH, dk, dtype=F32, device=r.device)
    dr, dk_, dv, dlogw = (torch.empty_like(t) for t in (r_, k_, v_, w_))
    idx = torch.arange(chunk, device=r.device)
    strict = idx[:, None] > idx[None, :]                     # j < i
    ex = torch.exp if sub_chunk is None else _exp_le0
    for ch in reversed(range(nt)):
        win = slice(ch * chunk, (ch + 1) * chunk)
        rc, kc, vc, wc, do = (t[:, win] for t in (r_, k_, v_, w_, do_))
        S = s_traj[:, ch].to(F32)
        S_next = s_traj[:, ch + 1].to(F32) if ch + 1 < nt else s_fin.to(F32)
        L = torch.cumsum(wc, dim=1)
        Lp = L - wc if sub_chunk is None else _exclusive(L)
        L_last = L[:, -1]
        decay = _intra_decay(L, Lp, sub_chunk)               # (BH, C, C, dk)
        A = torch.einsum("bic,bjc,bijc->bij", rc, kc, decay)
        bonus = torch.einsum("bic,bc,bic->bi", rc, u_, kc)
        dA = torch.where(strict, do @ vc.transpose(1, 2), 0.0)
        db = (do * vc).sum(-1)
        D = ex(L_last[:, None] - L)                          # e^{Llast - L}
        E = ex(Lp)
        dv[:, win] = (A.transpose(1, 2) @ do + bonus[..., None] * do
                      + (kc * D) @ ds)
        dr_nb = (E * (do @ S.transpose(1, 2))
                 + torch.einsum("bij,bjc,bijc->bic", dA, kc, decay))
        dk_nb = (torch.einsum("bij,bic,bijc->bjc", dA, rc, decay)
                 + D * (vc @ ds.transpose(1, 2)))
        dbu = db[..., None] * u_[:, None]
        dr[:, win] = dr_nb + dbu * kc
        dk_[:, win] = dk_nb + dbu * rc
        du += (db[..., None] * rc * kc).sum(1)
        g = -kc * dk_nb                                      # gL
        g[:, -1] += (S_next * ds).sum(-1)                    # Llast's term
        g[:, :-1] += rc[:, 1:] * dr_nb[:, 1:]                # gLp, shifted
        dlogw[:, win] = torch.flip(torch.cumsum(torch.flip(g, [1]), 1), [1])
        ds = ex(L_last)[..., None] * ds + (rc * E).transpose(1, 2) @ do
    return (dr[:, :T].to(r.dtype), dk_[:, :T].to(k.dtype),
            dv[:, :T].to(v.dtype), dlogw[:, :T], du, ds)


# ---------------------------------------------------------------------------
# The launches
# ---------------------------------------------------------------------------
def _entry(lib_name: str, symbol: str, n_ptrs: int):
    """A C entry point taking ``n_ptrs`` pointers, then BH, T, dk, dv,
    chunk, bh_tile, the shared-memory bytes and the stream."""
    lib = _build.load(lib_name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _io_suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


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


def _card_smem(what: str, mode: str, chunk: int, r, v, *io) -> int:
    """Check a launch on the card — device, one IO dtype for ``r``, ``v``
    and ``io``, heads a block can hold — and return its shared memory."""
    if r.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {r.device}")
    if any(t.dtype != v.dtype for t in (r, *io)) or v.dtype not in _IO_DTYPES:
        raise TypeError(f"{what} on the card takes its IO tensors in one "
                        f"dtype, float32 or bfloat16; got "
                        f"{[t.dtype for t in (r, v, *io)]}")
    T, dk, dv = r.shape[1], r.shape[2], v.shape[2]
    smem = working_set_bytes(T, dk, dv, chunk, mode=mode)
    if max(dk, dv) > THREADS or smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"{what}: heads of {dk} x {dv} at chunk {chunk} "
                         f"need {smem} bytes of shared memory (at most "
                         f"{factorization.H100_SMEM_PER_BLOCK}) and at "
                         f"most {THREADS} per side")
    return smem


def _launch_fwd(r, k, v, logw, u, state, chunk: int, bh_tile: int,
                traj: bool) -> tuple[torch.Tensor, ...]:
    """One launch of csrc/wkv6.cu: K6, or with ``traj`` K6t."""
    what = "wkv6_traj" if traj else "wkv6"
    smem = _card_smem(what, "fwd", chunk, r, v, k)
    BH, T, dk = r.shape
    dv = v.shape[-1]
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    logw, u, state = (t.to(F32).contiguous() for t in (logw, u, state))
    outs = [torch.empty_like(v), torch.empty_like(state)]
    if traj:
        outs.append(torch.empty(BH, -(-T // chunk), dk, dv, dtype=F32,
                                device=r.device))
    ptrs = [r, k, v, logw, u, state, *outs]
    lib, fn = _entry("wkv6", f"{what}_{_io_suffix(v.dtype)}", len(ptrs))
    err = fn(*(t.data_ptr() for t in ptrs), BH, T, dk, dv, chunk, bh_tile,
             smem, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, "wkv6", err)
    return tuple(outs)


def wkv6_traj(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
              chunk: int = 32, bh_tile: int = 1
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6t: ``wkv6``'s launch with one more output — ONE kernel launch.

    Returns (out, final state, s_traj): out and the final state are
    bit-identical to ``wkv6``'s on the same inputs; ``s_traj (BH,
    ceil(T / chunk), dk, dv)`` f32 holds the state each chunk starts from
    (``ref.wkv6_traj``'s contract).  The CPU runs ``wkv6_traj_plain``."""
    _validate(r, k, v, logw, u, state)
    BH, T, _ = r.shape
    chunk = max(1, min(chunk, T))
    bh_tile = max(1, min(bh_tile, BH))
    nt = -(-T // chunk)
    called("wkv6_traj", -(-BH // bh_tile) * nt)
    if r.device.type == "meta":
        dk, dv = r.shape[-1], v.shape[-1]
        return meta_like((v.shape, v.dtype), ((BH, dk, dv), F32),
                         ((BH, nt, dk, dv), F32))
    if r.device.type == "cpu":
        return wkv6_traj_plain(r, k, v, logw, u, state, chunk)
    outs = _launch_fwd(r, k, v, logw, u, state, chunk, bh_tile, traj=True)
    wkv6_traj.launches += 1
    return outs


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, s_traj: torch.Tensor,
             s_fin: torch.Tensor, dout: torch.Tensor, ds_fin: torch.Tensor,
             *, chunk: int = 32, bh_tile: int = 1
             ) -> tuple[torch.Tensor, ...]:
    """K6b: the whole reverse sweep of the chunked scan — ONE kernel launch.

    Takes the forward's inputs, its chunk-incoming states ``s_traj`` and
    final state ``s_fin`` (``wkv6_traj``'s outputs at the same ``chunk``)
    and the cotangents ``dout`` (BH, T, dv) of out and ``ds_fin`` (BH, dk,
    dv) of the final state.  Returns (dr, dk, dv) in the IO dtype and
    (dlogw, du, ds0) f32; du is per batch-head row.  On the card r, k, v
    and dout share one dtype, float32 or bfloat16.  The CPU runs
    ``wkv6_bwd_plain``."""
    _validate(r, k, v, logw, u, s_fin)
    BH, T, dk = r.shape
    dv = v.shape[-1]
    chunk = max(1, min(chunk, T))
    bh_tile = max(1, min(bh_tile, BH))
    nt = -(-T // chunk)
    if s_traj.shape != (BH, nt, dk, dv) or dout.shape != v.shape \
            or ds_fin.shape != (BH, dk, dv):
        raise ValueError(f"wkv6_bwd shapes: s_traj {tuple(s_traj.shape)} "
                         f"(want {(BH, nt, dk, dv)}), dout "
                         f"{tuple(dout.shape)}, ds_fin {tuple(ds_fin.shape)}")
    if any(t.device != r.device for t in (s_traj, dout, ds_fin)):
        raise ValueError("wkv6_bwd: every tensor must be on r's device")
    called("wkv6_bwd", -(-BH // bh_tile) * nt)
    if r.device.type == "meta":
        return meta_like((r.shape, r.dtype), (k.shape, k.dtype),
                         (v.shape, v.dtype), (logw.shape, F32),
                         (u.shape, F32), (s_fin.shape, F32))
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, logw, u, s_traj, s_fin, dout, ds_fin,
                              chunk)
    smem = _card_smem("wkv6_bwd", "bwd", chunk, r, v, k, dout)
    r, k, v, dout = (t.contiguous() for t in (r, k, v, dout))
    logw, u, s_traj, s_fin, ds_fin = (
        t.to(F32).contiguous() for t in (logw, u, s_traj, s_fin, ds_fin))
    grads = (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
             torch.empty_like(logw), torch.empty_like(u),
             torch.empty_like(s_fin))
    ptrs = (r, k, v, logw, u, s_traj, s_fin, dout, ds_fin, *grads)
    lib, fn = _entry("wkv6_bwd", f"wkv6_bwd_{_io_suffix(v.dtype)}",
                     len(ptrs))
    err = fn(*(t.data_ptr() for t in ptrs), BH, T, dk, dv, chunk, bh_tile,
             smem, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, "wkv6_bwd", err)
    wkv6_bwd.launches += 1
    return grads


class _Wkv6Fn(torch.autograd.Function):
    """The chunked scan under autograd (the JAX package's ``custom_vjp``):
    the forward is K6t, keeping the chunk-incoming states and the final
    state as residuals, the backward is K6b.  Gradients come back in the
    inputs' dtypes; u's is per batch-head row (a caller that broadcast u
    sums it through autograd)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, chunk, bh_tile):
        out, s_out, s_traj = wkv6_traj(r, k, v, logw, u, state, chunk=chunk,
                                       bh_tile=bh_tile)
        ctx.save_for_backward(r, k, v, logw, u, s_traj, s_out)
        ctx.chunk, ctx.bh_tile, ctx.state_dtype = chunk, bh_tile, state.dtype
        return out, s_out

    @staticmethod
    def backward(ctx, dout, ds_fin):
        r, k, v, logw, u, s_traj, s_out = ctx.saved_tensors
        dr, dk, dv, dlogw, du, ds0 = wkv6_bwd(
            r, k, v, logw, u, s_traj, s_out, dout, ds_fin,
            chunk=ctx.chunk, bh_tile=ctx.bh_tile)
        return (dr, dk, dv, dlogw.to(logw.dtype), du.to(u.dtype),
                ds0.to(ctx.state_dtype), None, None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
         chunk: int = 32, bh_tile: int = 1
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked RWKV6 scan over full sequences — ONE kernel launch (K6).

    r, k, logw: (BH, T, dk); v: (BH, T, dv); u: (BH, dk); state:
    (BH, dk, dv).  Any T and BH; ``chunk`` is clamped to T and ``bh_tile``
    to BH.  Returns (out (BH, T, dv) in v's dtype, final state (BH, dk, dv)
    f32).  On the card r, k and v share one dtype, float32 or bfloat16;
    logw, u and the state are taken in f32.

    Differentiable: when autograd would record the call, it runs
    ``_Wkv6Fn`` — K6t forward and K6b backward, 2 launches per gradient
    (on the CPU their plain versions) — at the caller's ``chunk``, which a
    training caller takes from ``choose_blocks(mode="bwd")``."""
    _validate(r, k, v, logw, u, state)
    BH, T, dk = r.shape
    chunk = max(1, min(chunk, T))
    bh_tile = max(1, min(bh_tile, BH))
    tracer = trace_lib.get_tracer()
    if tracer.enabled:
        tracer.event("plan/dispatch", family="rwkv6", plan="chunked_scan",
                     chunk=chunk, bh_tile=bh_tile, n_bh=BH, seq_len=T)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, state)):
        return _Wkv6Fn.apply(r, k, v, logw, u, state, chunk, bh_tile)
    called("wkv6", -(-BH // bh_tile) * -(-T // chunk))
    if r.device.type == "meta":
        return meta_like((v.shape, v.dtype), ((BH, dk, v.shape[-1]), F32))
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, state, chunk)
    out, s_out = _launch_fwd(r, k, v, logw, u, state, chunk, bh_tile,
                             traj=False)
    wkv6.launches += 1
    return out, s_out


#: kernel launches since the last reset (CPU calls are not counted)
wkv6.launches = 0
wkv6_traj.launches = 0
wkv6_bwd.launches = 0
