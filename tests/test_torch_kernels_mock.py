"""K7 and K7t (``csrc/mamba_scan.cu``), K7b (``csrc/mamba_scan_bwd.cu``) and
K3 (``csrc/lstm_seq_bwd.cu``) run on
the CPU under the g++ mock of the CUDA runtime (``tests/cuda_mock``): one
std::thread per CUDA thread, real barriers, shuffles and named barriers,
cp.async copies that land only at their wait, blocks in a shuffled order.
Each is held against its plain version at small shapes (f32, bf16 and int8;
ragged tails; many tiles, so that the multi-level closing sums run), two
runs give the same bits, and every ticket the kernel draws ends where the
next launch expects it.  The C side's shared-memory formula is held to
the budget tables at every shape the tables launch.  The mock's floating
point is the host's (glibc's expf), so the bits are not the card's; the
card runs the same checks in ``chip_smoke.py``."""
import ctypes
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cuda_mock  # noqa: E402

from repro_torch.core import factorization, plans  # noqa: E402
from repro_torch.kernels import lstm_cell as cell_k  # noqa: E402
from repro_torch.kernels import lstm_seq as seq_k  # noqa: E402
from repro_torch.kernels import lstm_seq_bwd as bwd_k  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

OUT = Path(__file__).resolve().parents[1] / "build" / "mock"
GRADS = ("dx", "ddt", "db", "dc", "da", "dh0")


def _lib(name: str) -> ctypes.CDLL:
    lib = cuda_mock.build(name, OUT)
    if lib is None:
        pytest.skip("no g++ to build the mock")
    return lib


def _fwd_call(lib, args, chunk: int, tile: int, traj: bool = False,
              block_b: int = 1, one_phase: bool | None = None,
              smem: int | None = None):
    """One K7 (K7t with ``traj``) launch under the mock: (outputs, error
    code).  At T = 1 the one-phase path unless ``one_phase`` is False;
    ``smem`` the table's price unless given."""
    args = tuple(t.contiguous() for t in args)
    x, dt, b, c, a, h0 = args
    B, T, di = x.shape
    ds = b.shape[-1]
    io = x.element_size()
    one_phase = T == 1 if one_phase is None else one_phase
    if smem is None:
        smem = 0 if one_phase else ms._fwd_ring(chunk, tile, io)
    outs = [torch.full_like(x, float("nan")),
            torch.full((B, di, ds), float("nan"))]
    if traj:
        outs.append(torch.full((B, -(-T // chunk), di, ds), float("nan")))
    fn = getattr(lib, ("mamba_scan_traj_" if traj else "mamba_scan_")
                 + ("f32" if io == 4 else "bf16"))
    ptrs = (*args, *outs)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 8
                   + [ctypes.c_longlong, ctypes.c_void_p])
    err = fn(*(t.data_ptr() for t in ptrs), B, T, di, ds, chunk, block_b,
             tile, int(one_phase), smem, None)
    return outs, err


def _fwd_inputs(B, T, di, ds, dtype, dt_scale, seed):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = rnd(B, T, di).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, T, di)) * dt_scale
    return (x, dt, rnd(B, T, ds), rnd(B, T, ds), -torch.exp(rnd(di, ds)),
            0.3 * rnd(B, di, ds))


@pytest.mark.parametrize("case", [
    # (B, T, d_inner, d_state, chunk, tile, dtype, dt scale, rows a block)
    (2, 40, 24, 16, 32, 32, "float32", 1.0),
    (1, 37, 40, 16, 16, 32, "bfloat16", 1.0),
    (2, 19, 20, 5, 8, 32, "bfloat16", 1.0),
    (1, 50, 64, 16, 48, 64, "float32", 1.0),
    (1, 9, 16, 4, 4, 32, "float32", 1.0),
    (1, 24, 64, 16, 24, 64, "float32", 1e4),
    (1, 21, 48, 16, 7, 64, "bfloat16", 1e4),
    (3, 21, 16, 16, 8, 32, "float32", 1.0, 2),
    (1, 33, 136, 16, 32, 128, "bfloat16", 1.0),
    (2, 1, 40, 16, 1, 32, "float32", 1.0),
    (3, 1, 72, 12, 1, 64, "bfloat16", 1.0),
    (2, 1, 20, 5, 1, 32, "float32", 1.0),
], ids=["family-like", "T37-bf16", "ds5-bf16", "3-windows-a-chunk", "ds4",
        "dt1e4", "dt1e4-bf16", "2-rows-a-block", "tile128-bf16", "T1",
        "T1-bf16", "T1-ds5"])
def test_k7_and_k7t_under_the_mock_match_their_plain_versions(case):
    """K7 against ``mamba_scan_plain`` (y at MAMBA_TOL of its dtype, the
    state at f32's), K7t's y and state bit-equal to K7's and its h_traj
    against ``mamba_scan_traj_plain``; at T = 1 the one-phase path, also
    bit-equal to the general path forced at T = 1; two runs
    bit-identical."""
    B, T, di, ds, chunk, tile, dtype, dt_scale, *block_b = case
    block_b = block_b[0] if block_b else 1
    dtype = getattr(torch, dtype)
    args = _fwd_inputs(B, T, di, ds, dtype, dt_scale, sum(case[:6]))
    want_y, want_h, want_traj = ms.mamba_scan_traj_plain(*args, chunk)
    lib = _lib("mamba_scan")
    (y, h), err = _fwd_call(lib, args, chunk, tile, block_b=block_b)
    assert err == 0 and y.dtype == dtype
    tol = plans.MAMBA_TOL
    torch.testing.assert_close(y.float(), want_y.float(),
                               **tol[str(dtype).split(".")[1]])
    torch.testing.assert_close(h, want_h, **tol["float32"])
    (ty, th, traj), err = _fwd_call(lib, args, chunk, tile, traj=True,
                                    block_b=block_b)
    assert err == 0 and torch.equal(ty, y) and torch.equal(th, h)
    torch.testing.assert_close(traj, want_traj, **tol["float32"])
    again, _ = _fwd_call(lib, args, chunk, tile, block_b=block_b)
    assert torch.equal(again[0], y) and torch.equal(again[1], h)
    if T == 1:
        (gy, gh), err = _fwd_call(lib, args, chunk, tile, one_phase=False)
        assert err == 0 and torch.equal(gy, y) and torch.equal(gh, h)


def test_k7_under_the_mock_is_bit_identical_across_chunks_and_tiles():
    """The chunk (and so the windows), the d_inner tile and the rows a
    block change no bit of y or the final state, in f32 and bf16; a
    split run resumed from its final state equals the whole run; a launch
    priced at other shared memory than the table's is refused."""
    lib = _lib("mamba_scan")
    for dtype in (torch.float32, torch.bfloat16):
        args = _fwd_inputs(2, 45, 72, 16, dtype, 1.0, 7)
        base, err = _fwd_call(lib, args, 45, 32)
        assert err == 0
        for chunk, tile, block_b in ((1, 64, 1), (16, 128, 1), (17, 32, 1),
                                     (32, 64, 2)):
            got, err = _fwd_call(lib, args, chunk, tile, block_b=block_b)
            assert err == 0
            assert torch.equal(got[0], base[0]) and torch.equal(got[1],
                                                                base[1])
        first, _ = _fwd_call(lib, tuple(t[:, :20] for t in args[:4])
                             + args[4:], 16, 64)
        rest, _ = _fwd_call(lib, tuple(t[:, 20:] for t in args[:4])
                            + (args[4], first[1]), 16, 64)
        assert torch.equal(torch.cat([first[0], rest[0]], 1), base[0])
        assert torch.equal(rest[1], base[1])
    x_args = _fwd_inputs(1, 8, 32, 16, torch.float32, 1.0, 8)
    ring = ms._fwd_ring(8, 32, 4)
    for smem in (ring - 16, ring + 16, 0):
        _, err = _fwd_call(lib, x_args, 8, 32, smem=smem)
        assert err != 0
    _, err = _fwd_call(lib, x_args, 8, 32, one_phase=True, smem=0)
    assert err != 0  # the one-phase path takes T = 1 only


def _mamba_call(lib, args, chunk: int, tile: int, block_b: int = 1):
    """One K7b launch under the mock: (grads, tickets, their layout)."""
    x, dt, b, c, a, traj, dy, dhf = args
    B, T, di = x.shape
    ds = b.shape[-1]
    io = x.element_size()
    lib.mamba_scan_bwd_smem_bytes.restype = ctypes.c_longlong
    smem = ms.working_set_bytes(T, ds, chunk, tile, "bwd", io_bytes=io)
    nt, ndt = -(-T // chunk), -(-di // tile)
    ng = -(-ndt // ms.BWD_GROUP)
    grads = tuple(torch.empty_like(t) for t in (x, dt, b, c, a, dhf))
    parts = torch.full((B * nt * (ndt + ng) * chunk * 32,), float("nan"))
    da_parts = torch.full((-(-B // block_b) * di * ds,), float("nan"))
    tickets = torch.zeros(B * nt * (ng + 1) + ndt, dtype=torch.int32)
    ptrs = (*args, *grads, parts, da_parts, tickets)
    fn = getattr(lib, "mamba_scan_bwd_" + ("f32" if io == 4 else "bf16"))
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 7
                   + [ctypes.c_longlong, ctypes.c_void_p])
    err = fn(*(t.data_ptr() for t in ptrs), B, T, di, ds, chunk, block_b,
             tile, smem, None)
    assert err == 0
    return grads, tickets, (B * nt, ng, ndt)


@pytest.mark.parametrize("case", [
    # (B, T, d_inner, d_state, chunk, tile, dtype, dt scale, rows a block)
    (2, 40, 24, 16, 32, 8, "float32", 1.0),
    (1, 19, 40, 16, 16, 16, "float32", 1.0),
    (2, 37, 20, 5, 8, 8, "bfloat16", 1.0),
    (1, 50, 33, 16, 32, 32, "bfloat16", 1.0),
    (1, 9, 16, 4, 4, 8, "float32", 1.0),
    (1, 24, 64, 16, 24, 64, "float32", 1e4),
    (1, 40, 323, 16, 16, 8, "float32", 1.0),
    (3, 21, 16, 16, 8, 16, "float32", 1.0, 2),
], ids=["family-like", "T19", "ds5-bf16", "tail-bf16", "ds4", "dt1e4",
        "3-groups", "2-rows-a-block"])
def test_k7b_under_the_mock_matches_its_plain_version(case):
    """Against ``mamba_scan_bwd_plain`` at MAMBA_GRAD_TOL's rtol of each
    gradient's largest entry (bf16 dx within one bf16 step); two runs
    bit-identical; each (row, chunk) drew every d-tile's ticket once, each
    group's top ticket once, and each tile's dA ticket once a row tile."""
    B, T, di, ds, chunk, tile, dtype, dt_scale, *block_b = case
    block_b = block_b[0] if block_b else 1
    g = torch.Generator().manual_seed(sum(case[:6]))
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    dtype = getattr(torch, dtype)
    x, dy = rnd(B, T, di).to(dtype), rnd(B, T, di).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, T, di)) * dt_scale
    b, c = rnd(B, T, ds), rnd(B, T, ds)
    a, h0, dhf = -torch.exp(rnd(di, ds)), 0.3 * rnd(B, di, ds), rnd(B, di, ds)
    _, _, traj = ms.mamba_scan_traj_plain(x, dt, b, c, a, h0, chunk)
    args = (x, dt, b, c, a, traj, dy, dhf)
    want = ms.mamba_scan_bwd_plain(*args, chunk)
    lib = _lib("mamba_scan_bwd")
    got, tickets, (rows, ng, ndt) = _mamba_call(lib, args, chunk, tile,
                                                block_b)
    again, _, _ = _mamba_call(lib, args, chunk, tile, block_b)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    tk = tickets[:rows * (ng + 1)].view(rows, ng + 1)
    assert bool((tk[:, :ng].sum(1) == ndt).all())
    assert ng == 1 or bool((tk[:, ng] == ng).all())
    assert bool((tickets[rows * (ng + 1):] == -(-B // block_b)).all())
    for name, u, w in zip(GRADS, got, want):
        assert u.dtype == w.dtype, name
        m = float(w.float().abs().max())
        e = float((u.float() - w.float()).abs().max())
        limit = 2.0 ** -7 * m if (name == "dx" and dtype == torch.bfloat16) \
            else 1e-4 * max(1.0, m)
        assert e <= limit, (name, e, m)


def _lstm_call(lib, w, b, x, ct, ht, dc, dh, block_b, tc, scales):
    """One K3 launch under the mock: (dw, db, dx, tickets)."""
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    q8 = scales is not None
    reg = seq_k.weight_home(L, P, H, block_b) == "registers"
    smem = seq_k.working_set_bytes(T, L, P, H, block_b, mode="bwd",
                                   time_chunk=None if tc == T else tc,
                                   quantized=q8)
    parts = seq_k.gate_parts(H)
    threads = L * seq_k.BWD_REG_THREADS if reg else \
        factorization.round_up(parts * 4 * H, factorization.WARP)
    n_tiles = -(-B // block_b)
    n_parts, n_tickets = bwd_k.close_workspace(n_tiles,
                                               w.numel() + b.numel())
    dw, db = torch.empty(w.shape), torch.empty(b.shape)
    dx = torch.full((B, T, P), float("nan"))
    partials = torch.full((max(1, n_parts),), float("nan"))
    tickets = torch.zeros(max(1, n_tickets), dtype=torch.int32)
    dg_work = torch.full((B * L * T * 4 * H if reg else 1,), float("nan"))
    fn = lib.lstm_seq_bwd_q8 if q8 else lib.lstm_seq_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * (14 if q8 else 13)
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_void_p])
    wp = (w.data_ptr(), scales.data_ptr()) if q8 else (w.data_ptr(),)
    err = fn(*wp, b.data_ptr(), x.data_ptr(), ct.data_ptr(), ht.data_ptr(),
             dc.data_ptr(), dh.data_ptr(), dw.data_ptr(), db.data_ptr(),
             dx.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
             dg_work.data_ptr(), B, T, L,
             P, H, x.stride(0), x.stride(1), block_b, tc, int(reg), parts,
             bwd_k.dot_parts(P + H, threads), threads, smem, None)
    assert err == 0
    return dw, db, dx, tickets


@pytest.mark.parametrize("case", [
    # (B, T, L, H, P, block_b, time chunks, int8, x padded by)
    (3, 20, 2, 32, 32, 1, (20, 7), False, 0),
    (2, 9, 1, 32, 32, 1, (9,), False, 0),
    (2, 1, 2, 32, 32, 1, (1,), False, 0),
    (3, 20, 2, 32, 32, 1, (20, 3), True, 0),
    (19, 5, 2, 32, 32, 1, (5,), False, 3),
    (5, 12, 2, 32, 32, 2, (12, 5), False, 0),
    (5, 12, 2, 16, 32, 4, (5,), True, 0),
    (20, 6, 2, 16, 32, 1, (6,), False, 0),
], ids=["2x32-wave", "1x32-wave", "T1-wave", "q8-wave", "3-groups-wave",
        "shared-tile2", "q8-shared-tile4", "3-groups-shared"])
def test_k3_under_the_mock_matches_its_plain_version(case):
    """Against ``lstm_seq_bwd_plain`` (``scales=`` for int8) at 1e-4 of each
    gradient's largest entry, the register home's wavefront and the shared
    home alike; bit-identical across time chunks and two runs; every
    closing-sum ticket back at 0 for the next launch."""
    B, T, L, H, P, block_b, chunks, q8, pad = case
    g = torch.Generator().manual_seed(B * T + L * H + block_b)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    w = rnd(L, P + H, 4 * H) * (P + H) ** -0.5
    b = rnd(L, 4 * H) * 0.1
    x = rnd(B, T, P + pad)[:, :, :P]
    dc, dh = rnd(L, B, H), rnd(L, B, H)
    if q8:
        wq, s = ref.quantize_q8(w)
        _, _, ct, ht = seq_k.lstm_seq_q8_traj_plain(wq, s, b, x)
        want = bwd_k.lstm_seq_bwd_plain(wq, b, x, ct, ht, dc, dh, scales=s)
        w, scales = wq, s
    else:
        _, _, ct, ht = ref.lstm_seq_traj(w, b, x)
        want = bwd_k.lstm_seq_bwd_plain(w, b, x, ct, ht, dc, dh)
        scales = None
    lib = _lib("lstm_seq_bwd")
    runs = [_lstm_call(lib, w, b, x, ct, ht, dc, dh, block_b, tc, scales)
            for tc in chunks + chunks[:1]]
    for run in runs:
        assert int(run[3].abs().sum()) == 0
        assert all(torch.equal(u, v) for u, v in zip(run[:3], runs[0][:3]))
    for name, u, r in zip(("dw", "db", "dx"), runs[0], want):
        m = float(r.abs().max())
        assert float((u - r).abs().max()) <= 1e-4 * max(1.0, m), name


BF16 = torch.bfloat16
#: (stack, input) dtypes of each instance pair, by the C entry's suffix
_PAIRS = {"f32": (torch.float32, torch.float32), "bf16": (BF16, BF16),
          "q8": (torch.int8, torch.float32), "q8_bf16": (torch.int8, BF16)}


def _lstm_inputs(B, T, L, H, P, seed, pad=0):
    """f32 (w, b, x, dc, dh) for an LSTM stack, x strided when padded."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return (rnd(L, P + H, 4 * H) * (P + H) ** -0.5, rnd(L, 4 * H) * 0.1,
            rnd(B, T, P + pad)[:, :, :P], rnd(L, B, H), rnd(L, B, H))


def _as_pair(pair, w, b, x, dc=None, dh=None):
    """The operands of the ``pair`` instance from f32 ones: (w, scales, b,
    x, dc, dh), the int8 stack quantized with its scales."""
    wt, io = _PAIRS[pair]
    cast = (lambda t: None if t is None else t.to(io))  # noqa: E731
    if wt == torch.int8:
        wq, s = ref.quantize_q8(w)
        return wq, s, b, cast(x), cast(dc), cast(dh)
    return w.to(wt), None, b.to(wt), cast(x), cast(dc), cast(dh)


def _k2_call(lib, pair, w, s, b, x, block_b, tc, traj):
    """One K2 (K2t with ``traj``) launch under the mock: (c, h) or (c, h,
    c_traj, h_traj)."""
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    reg = seq_k.weight_home(L, P, H, block_b) == "registers"
    smem = seq_k.working_set_bytes(T, L, P, H, block_b,
                                   time_chunk=None if tc == T else tc,
                                   **seq_k._bytes(w, x))
    outs = [torch.full((L, B, H), float("nan")).to(x.dtype)
            for _ in range(2)]
    outs += [torch.full((T, L, B, H), float("nan")) for _ in range(2)] \
        if traj else []
    fn = getattr(lib, f"lstm_seq_fwd_{pair}")
    ptrs = [w.data_ptr()] + ([s.data_ptr()] if s is not None else []) + [
        b.data_ptr(), x.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
        outs[2].data_ptr() if traj else None,
        outs[3].data_ptr() if traj else None]
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p])
    err = fn(*ptrs, B, T, L, P, H, x.stride(0), x.stride(1), block_b, tc,
             int(reg), seq_k.fwd_threads(L, H), smem, None)
    assert err == 0
    # a launch priced one byte off is refused
    assert fn(*ptrs, B, T, L, P, H, x.stride(0), x.stride(1), block_b, tc,
              int(reg), seq_k.fwd_threads(L, H), smem + 1, None) != 0
    return tuple(outs)


def _step(t: torch.Tensor) -> float:
    """One bf16 step of the largest entry: 2^-7 x max|t|."""
    return 2.0 ** -7 * float(t.float().abs().max())


@pytest.mark.parametrize("case", [
    # (B, T, L, H, P, block_b, time chunks, x padded by)
    (2, 12, 2, 32, 32, 1, (12, 5), 0),
    (3, 7, 2, 8, 9, 2, (7, 3), 0),
    (5, 6, 3, 16, 16, 4, (6, 4), 3),
], ids=["2x32-registers", "odd-P-tile2", "3x16-tile4-strided-x"])
@pytest.mark.parametrize("pair", list(_PAIRS))
def test_k2_and_k2t_under_the_mock_match_their_plain_versions(case, pair):
    """K2 and K2t, every instance pair, both weight homes: against the plain
    versions (f32 at 1e-5 of each output's largest entry; a bf16 (c, h)
    within one bf16 step, 2^-7 x max|out|; the f32 trajectories at 2e-5);
    bit-identical across time chunks, two runs and, at 2 x 32, the
    register home (tile 1) and the shared one (tile 2); the trajectory
    launch's final (c, h) the plain launch's; and a bf16 instance equal to
    its f32 instance on the widened operands, bit for bit (the bf16
    instance runs the f32 multiply-add chain; only (c, h) are rounded)."""
    B, T, L, H, P, block_b, chunks, pad = case
    w, b, x, _, _ = _lstm_inputs(B, T, L, H, P, seed=B * T + H, pad=pad)
    wk, s, bk, xk, _, _ = _as_pair(pair, w, b, x)
    lib = _lib("lstm_seq")
    runs = [(_k2_call(lib, pair, wk, s, bk, xk, block_b, tc, False),
             _k2_call(lib, pair, wk, s, bk, xk, block_b, tc, True))
            for tc in chunks + chunks[:1]]
    (c0, h0), traj0 = runs[0]
    for plain, traj in runs[1:]:
        assert all(torch.equal(u, v) for u, v in
                   zip((*plain, *traj), (c0, h0, *traj0)))
    assert torch.equal(traj0[0], c0) and torch.equal(traj0[1], h0)
    if s is None:
        want = ref.lstm_seq_traj(wk, bk, xk)
    else:
        want = seq_k.lstm_seq_q8_traj_plain(wk, s, bk, xk)
    for u, r in zip(traj0[:2], want[:2]):
        assert u.dtype == xk.dtype
        limit = _step(r) if xk.dtype == BF16 else 1e-5 * max(
            1.0, float(r.abs().max()))
        assert float((u.float() - r.float()).abs().max()) <= limit
    for u, r in zip(traj0[2:], want[2:]):
        assert u.dtype == torch.float32
        assert float((u - r).abs().max()) <= 2e-5
    if H == 32 and P == 32:
        shared = _k2_call(lib, pair, wk, s, bk, xk, 2, T, True)
        assert all(torch.equal(u, v) for u, v in zip(shared, traj0))
    if xk.dtype == BF16:
        wide = "f32" if s is None else "q8"
        f32 = _k2_call(lib, wide, wk if s is not None else wk.float(), s,
                       bk.float(), xk.float(), block_b, T, True)
        assert all(torch.equal(u, v.to(BF16))
                   for u, v in zip(traj0[:2], f32[:2]))
        assert all(torch.equal(u, v) for u, v in zip(traj0[2:], f32[2:]))


def _k3_call(lib, pair, w, s, b, x, ct, ht, dc, dh, block_b, tc):
    """One K3 launch of the ``pair`` instance under the mock: (dw, db, dx,
    tickets)."""
    L, H = w.shape[0], w.shape[-1] // 4
    P = w.shape[1] - H
    B, T, _ = x.shape
    q8 = s is not None
    reg = seq_k.weight_home(L, P, H, block_b) == "registers"
    smem = seq_k.working_set_bytes(T, L, P, H, block_b, mode="bwd",
                                   time_chunk=None if tc == T else tc,
                                   **seq_k._bytes(w, x))
    parts = seq_k.gate_parts(H)
    threads = L * seq_k.BWD_REG_THREADS if reg else \
        factorization.round_up(parts * 4 * H, factorization.WARP)
    n_tiles = -(-B // block_b)
    n_parts, n_tickets = bwd_k.close_workspace(n_tiles,
                                               w.numel() + b.numel())
    dw = torch.full(w.shape, float("nan")).to(torch.float32 if q8
                                              else w.dtype)
    db = torch.full(b.shape, float("nan")).to(b.dtype)
    dx = torch.full((B, T, P), float("nan")).to(x.dtype)
    partials = torch.full((max(1, n_parts),), float("nan"))
    tickets = torch.zeros(max(1, n_tickets), dtype=torch.int32)
    dg_work = torch.full((B * L * T * 4 * H if reg else 1,), float("nan"))
    fn = getattr(lib, f"lstm_seq_bwd_{pair}")
    fn.argtypes = ([ctypes.c_void_p] * (14 if q8 else 13)
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_void_p])
    wp = (w.data_ptr(), s.data_ptr()) if q8 else (w.data_ptr(),)
    err = fn(*wp, b.data_ptr(), x.data_ptr(), ct.data_ptr(), ht.data_ptr(),
             dc.data_ptr(), dh.data_ptr(), dw.data_ptr(), db.data_ptr(),
             dx.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
             dg_work.data_ptr(), B, T, L, P, H, x.stride(0), x.stride(1),
             block_b, tc, int(reg), parts, bwd_k.dot_parts(P + H, threads),
             threads, smem, None)
    assert err == 0
    return dw, db, dx, tickets


@pytest.mark.parametrize("case", [
    # (B, T, L, H, P, block_b, time chunks, instance pair)
    (3, 12, 2, 32, 32, 1, (12, 5), "bf16"),
    (2, 9, 1, 32, 32, 1, (9,), "bf16"),
    (3, 10, 2, 32, 32, 1, (10, 3), "q8_bf16"),
    (5, 9, 2, 16, 32, 2, (9, 4), "bf16"),
    (5, 8, 2, 16, 32, 4, (8, 3), "q8_bf16"),
    (20, 4, 2, 16, 16, 1, (4,), "bf16"),
], ids=["2x32-wave", "1x32-wave", "q8-wave", "shared-tile2",
        "q8-shared-tile4", "3-groups-shared"])
def test_k3_bf16_under_the_mock_matches_its_plain_version(case):
    """The bf16 instances of K3 (a bf16 stack, and the int8 stack over bf16
    x), the register home's wavefront and the shared home, on the f32
    trajectories of K2t's bf16 instance: against ``lstm_seq_bwd_plain``
    within one bf16 step of each gradient's largest entry (2^-7 x max, a
    bf16 gradient rounded once; an int8 stack's f32 dw and db at 1e-4);
    bit-identical across time chunks and two runs, tickets back at 0; and
    equal, bit for bit, to the f32 instance on the widened operands with
    its bf16 outputs rounded once -- so the bf16 recompute is the f32
    instance's, which runs lstm_gates.cuh's order as K2t does."""
    B, T, L, H, P, block_b, chunks, pair = case
    w, b, x, dc, dh = _lstm_inputs(B, T, L, H, P, seed=B * T + L * H)
    wk, s, bk, xk, dck, dhk = _as_pair(pair, w, b, x, dc, dh)
    lib = _lib("lstm_seq")
    _, _, ct, ht = _k2_call(lib, pair, wk, s, bk, xk, block_b, T, True)
    want = bwd_k.lstm_seq_bwd_plain(wk, bk, xk, ct, ht, dck, dhk, scales=s)
    lib = _lib("lstm_seq_bwd")
    runs = [_k3_call(lib, pair, wk, s, bk, xk, ct, ht, dck, dhk, block_b, tc)
            for tc in chunks + chunks[:1]]
    for run in runs:
        assert int(run[3].abs().sum()) == 0
        assert all(torch.equal(u, v) for u, v in zip(run[:3], runs[0][:3]))
    for name, u, r in zip(("dw", "db", "dx"), runs[0], want):
        assert u.dtype == r.dtype, name
        limit = _step(r) if r.dtype == BF16 else 1e-4 * max(
            1.0, float(r.abs().max()))
        assert float((u.float() - r.float()).abs().max()) <= limit, name
    wide = "f32" if s is None else "q8"
    f32 = _k3_call(lib, wide, wk if s is not None else wk.float(), s,
                   bk.float(), xk.float(), ct, ht, dck.float(), dhk.float(),
                   block_b, T)
    for name, u, v in zip(("dw", "db", "dx"), runs[0], f32):
        assert torch.equal(u, v.to(u.dtype)), name


@pytest.mark.parametrize("B,D,H", [(1, 9, 32), (5, 32, 20), (3, 64, 64)])
def test_k1_bf16_under_the_mock_matches_its_plain_version(B, D, H):
    """K1's bf16 instance at ``choose_blocks``'s tile (x a strided row, as
    the plans pass it; H = 20 takes the unvectorised loads): (c', h') within
    one bf16 step of the plain version, two runs bit-identical, and equal to
    the f32 instance on the widened operands rounded once."""
    g = torch.Generator().manual_seed(B + D + H)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    w = (rnd(D + H, 4 * H) * (D + H) ** -0.5).to(BF16)
    b = (rnd(4 * H) * 0.1).to(BF16)
    x = rnd(B, 3, D).to(BF16)[:, 1]
    c, h = rnd(B, H).to(BF16), rnd(B, H).to(BF16)
    blocks = cell_k.choose_blocks(B, D, H)
    lib = _lib("lstm_cell")

    def call(suffix, *ops):
        fn = getattr(lib, f"lstm_cell_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_void_p])
        wo, bo, xo, co, ho = ops
        outs = [torch.full((B, H), float("nan")).to(co.dtype)
                for _ in range(2)]
        err = fn(*(t.data_ptr() for t in (wo, bo, xo, co, ho, *outs)), B, D,
                 H, xo.stride(0), ho.stride(0), blocks.block_b,
                 blocks.block_h, blocks.k_slices, blocks.smem, None)
        assert err == 0
        return outs

    got = call("bf16", w, b, x, c, h)
    assert all(torch.equal(u, v) for u, v in
               zip(got, call("bf16", w, b, x, c, h)))
    for u, r in zip(got, cell_k.lstm_cell_plain(w, b, x, c, h)):
        assert u.dtype == r.dtype == BF16
        assert float((u.float() - r.float()).abs().max()) <= _step(r)
    f32 = call("f32", *(t.float() for t in (w, b, x, c, h)))
    assert all(torch.equal(u, v.to(BF16)) for u, v in zip(got, f32))


def _lstm_launch_shapes():
    """(B, T, L, P, H) of the LSTM launches the tables price: the paper's
    width served and trained, the Fig 5/6 widths, the family's cases, and
    the batch and sequence lengths the tests and the chip run take."""
    shapes = set()
    for L, P, H in ((2, 32, 32), (1, 32, 32), (3, 32, 32), (2, 64, 64),
                    (3, 64, 64), (2, 96, 96), (2, 48, 48), (2, 9, 8),
                    (2, 48, 48), (3, 33, 33), (2, 40, 16), (2, 16, 16)):
        for B in (1, 3, 37, 64, 1024):
            for T in (1, 7, 50, 128, 300):
                shapes.add((B, T, L, P, H))
    return sorted(shapes)


@pytest.mark.parametrize("pair", list(_PAIRS))
def test_the_c_side_prices_every_lstm_launch_as_the_table_does(pair):
    """``lstm_seq_fwd_smem_bytes`` and ``lstm_seq_bwd_smem_bytes`` (what
    K2/K2t and the shared-home K3 refuse a launch against) equal
    ``working_set_bytes`` at every tiling ``choose_batch_block`` picks for
    the instance pair, forward and backward, and at every tile and time
    chunk beside it; the register home's K3 (``lstm_seq_bwd_wave_smem_bytes``)
    too."""
    wt, io = _PAIRS[pair]
    wb = {torch.float32: 4, BF16: 2, torch.int8: 1}[wt]
    kw = dict(dtype_bytes=io.itemsize, w_dtype_bytes=None if wb == 1 else wb,
              quantized=wb == 1)
    fwd = _lib("lstm_seq").lstm_seq_fwd_smem_bytes
    fwd.restype = ctypes.c_longlong
    bwd_lib = _lib("lstm_seq_bwd")
    bwd = bwd_lib.lstm_seq_bwd_smem_bytes
    bwd.restype = ctypes.c_longlong
    wave = bwd_lib.lstm_seq_bwd_wave_smem_bytes
    wave.restype = ctypes.c_longlong
    priced = 0
    for B, T, L, P, H in _lstm_launch_shapes():
        tilings = {(bm, tc) for bm in seq_k.TILE_ROWS
                   for tc in (None, 1, 3, T // 2)
                   if tc is None or 1 <= tc < T}
        for mode in ("fwd", "bwd"):
            got = seq_k.choose_batch_block(B, T, L, P, H, mode=mode, **kw)
            if got is not None:
                tilings.add(tuple(got))
        for bm, tc in tilings:
            reg = seq_k.weight_home(L, P, H, bm) == "registers"
            for mode in ("fwd", "bwd"):
                want = seq_k.working_set_bytes(T, L, P, H, bm, mode=mode,
                                               time_chunk=tc, **kw)
                if mode == "fwd":
                    got = fwd(T, L, P, H, bm, tc or T, int(reg), wb,
                              io.itemsize)
                elif reg:
                    got = wave(L, wb)
                else:
                    got = bwd(T, L, P, H, bm, tc or T, wb)
                assert got == want, (pair, B, T, L, P, H, bm, tc, mode)
                priced += 1
    assert priced > 1000


def _mamba_launch_shapes():
    """(T, d_state, chunk, tile) of every K7b launch the tables make: the
    training table at Jamba's width and the family's and tests' shapes,
    each chunk it can take, and every tile the wrapper accepts."""
    shapes = set()
    for T, di, ds in ((512, 16384, 16), (500, 16384, 16), (64, 16, 16),
                      (70, 16, 16), (13, 6, 4), (9, 6, 4), (40, 24, 5)):
        for target in (None, 1, 4, 8, 16, 32, 64):
            got = ms.choose_blocks(T, di, ds, target=target, mode="bwd")
            if got is not None:
                shapes.add((T, ds, got.chunk, got.di_tile))
                shapes.add((T, ds, got.chunk, ms._bwd_tile(di)))
    for ds in (1, 5, 16):
        for C in (1, 7, 8, 9, 33, 64):
            for tile in (8, 16, 32, 64):
                shapes.add((512, ds, C, tile))
    return sorted(shapes)


def _fwd_launch_shapes():
    """(T, d_state, chunk, tile) of every K7 and K7t launch the tables
    make (the serving and the training table at Jamba's width and the
    family's and tests' shapes, each chunk they can take) and every tile
    and chunk the wrapper accepts, at T = 1 (the one-phase path) too."""
    shapes = set()
    for T, di, ds in ((512, 16384, 16), (500, 16384, 16), (1, 16384, 16),
                      (64, 16, 16), (70, 16, 16), (13, 6, 4), (9, 6, 4),
                      (40, 24, 5), (40, 72, 16), (40, 100, 8)):
        for target in (None, 1, 4, 8, 16, 32, 64):
            for mode in ("fwd", "bwd"):
                got = ms.choose_blocks(T, di, ds, target=target, mode=mode)
                if got is not None:
                    # the kernel takes a power of two of threads a block
                    assert got.di_tile in (32, 64, 128), (di, got)
                    shapes.add((T, ds, got.chunk, got.di_tile))
    for T in (1, 512):
        for ds in (1, 5, 16):
            for C in (1, 7, 16, 17, 33, 64):
                for tile in (32, 64, 128):
                    shapes.add((T, ds, C, tile))
    return sorted(shapes)


def test_the_c_side_prices_every_launch_as_the_tables_do():
    """``mamba_scan_smem_bytes`` and ``mamba_scan_bwd_smem_bytes`` (what
    the launches of K7/K7t and of K7b check their shared memory against)
    equal ``working_set_bytes(mode="fwd")`` and ``(mode="bwd")`` at every
    shape the tables and the wrapper launch, f32 and bf16 IO (0 on the
    one-phase path at T = 1); the register home's
    ``lstm_seq_bwd_wave_smem_bytes`` equals the LSTM table's at 1 and 2
    layers, f32 and int8, at every T and time chunk."""
    lib = _lib("mamba_scan")
    fn = lib.mamba_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    shapes = _fwd_launch_shapes()
    assert {(512, 16, 64, 128), (512, 16, 32, 64), (1, 16, 1, 128)} <= \
        set(shapes)
    for T, ds, C, tile in shapes:
        for io in (4, 2):
            want = ms.working_set_bytes(T, ds, C, tile, "fwd", io_bytes=io)
            assert fn(T, min(C, T), ds, tile, io) == want, (T, ds, C, tile,
                                                             io)
            assert want <= factorization.H100_SMEM_PER_BLOCK
            assert (want == 0) == (T == 1)
    lib = _lib("mamba_scan_bwd")
    fn = lib.mamba_scan_bwd_smem_bytes
    fn.restype = ctypes.c_longlong
    shapes = _mamba_launch_shapes()
    assert (512, 16, 32, 64) in shapes
    for T, ds, C, tile in shapes:
        for io in (4, 2):
            want = ms.working_set_bytes(T, ds, C, tile, "bwd", io_bytes=io)
            assert fn(min(C, T), ds, tile, io) == want, (T, ds, C, tile, io)
    lib = _lib("lstm_seq_bwd")
    fn = lib.lstm_seq_bwd_wave_smem_bytes
    fn.restype = ctypes.c_longlong
    for L in (1, 2):
        for q8 in (False, True):
            for T, tc in ((128, None), (128, 32), (300, 37), (1, None)):
                assert seq_k.weight_home(L, 32, 32, 1) == "registers"
                want = seq_k.working_set_bytes(T, L, 32, 32, 1, mode="bwd",
                                               time_chunk=tc, quantized=q8)
                assert fn(L, 1 if q8 else 4) == want
                assert want <= factorization.H100_SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# Attention training: the SIMT instances of K8t (csrc/flash_prefill.cu) and
# K8b with its reduction (csrc/flash_prefill_bwd.cu); the tensor-core
# instances need wgmma and TMA, and are held on the card
# ---------------------------------------------------------------------------
def _k8_call(lib, q, k, v, qb, kb, window, lse, smem=None):
    """One K8 launch of the SIMT instance (K8t with ``lse``) under the
    mock: (error code, o, lse)."""
    from repro_torch.kernels import flash_prefill as fp

    B, S, Hq, dh = q.shape
    o = torch.full_like(q, float("nan"))
    rows = torch.full((B, Hq, S), float("nan"))
    fn = lib.flash_prefill_f32_traj if lse else lib.flash_prefill_f32
    ptrs = (q, k, v, o) + ((rows,) if lse else ())
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p])
    smem = fp.working_set_bytes(qb, kb, dh) if smem is None else smem
    err = fn(*(t.data_ptr() for t in ptrs), B, S, Hq, k.shape[2], dh, qb, kb,
             window, dh ** -0.5, smem, None)
    return err, o, rows


def _k8b_call(lib, args, window, blocks, smem=None, part=None):
    """One K8b call of the SIMT instance (its dQ, dK/dV and, for GQA,
    reduction kernels) under the mock, with ``part`` the partials' scratch
    (allocated NaN-filled for Hq > Hkv unless given): (error code, dq, dk,
    dv, D, part)."""
    from repro_torch.kernels import flash_prefill as fp

    q, k, v, o, lse, dout = args
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    d = torch.full((B, Hq, S), float("nan"))
    grads = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    if part is None and Hq > Hkv:
        part = torch.full((2, B, S, Hq, dh), float("nan"))
    fn = lib.flash_prefill_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_void_p])
    if smem is None:
        smem = (fp.bwd_working_set_bytes(blocks.dq_rows, blocks.tile, dh,
                                         q.dtype, True),
                fp.bwd_working_set_bytes(blocks.dkv_rows, blocks.tile, dh,
                                         q.dtype, False))
    err = fn(*(t.data_ptr() for t in (q, k, v, o, dout, lse, d, *grads)),
             None if part is None else part.data_ptr(), B, S, Hq, Hkv, dh,
             *blocks, window, dh ** -0.5, *smem, None)
    return (err, *grads, d, part)


def _attn_inputs(B, S, Hq, Hkv, dh, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, S, Hq, dh, generator=g),
            torch.randn(B, S, Hkv, dh, generator=g),
            torch.randn(B, S, Hkv, dh, generator=g),
            torch.randn(B, S, Hq, dh, generator=g))


@pytest.mark.parametrize("case", [
    # (B, S, Hq, Hkv, dh, window, q_block, k_block): a ragged tail, GQA
    # groups of 2 and 4, a window, several q and kv tiles
    (1, 37, 4, 2, 16, 0, 16, 8), (1, 45, 4, 1, 32, 12, 32, 16),
    (2, 20, 2, 2, 64, 0, 16, 4)])
def test_simt_k8t_under_the_mock_matches_its_plain_version(case):
    """K8t's SIMT instance writes K8's output bit for bit and each row's
    lse, both against ``flash_prefill_traj_plain`` at the same tiles; two
    runs give the same bits."""
    from repro_torch.kernels import flash_prefill as fp

    B, S, Hq, Hkv, dh, w, qb, kb = case
    lib = _lib("flash_prefill")
    q, k, v, _ = _attn_inputs(B, S, Hq, Hkv, dh, seed=S)
    err8, o8, _ = _k8_call(lib, q, k, v, qb, kb, w, lse=False)
    err, o, lse = _k8_call(lib, q, k, v, qb, kb, w, lse=True)
    _, o2, lse2 = _k8_call(lib, q, k, v, qb, kb, w, lse=True)
    assert err8 == err == 0
    assert torch.equal(o, o8) and torch.equal(o, o2) and torch.equal(lse,
                                                                     lse2)
    want_o, want_lse = fp.flash_prefill_traj_plain(q, k, v, window=w,
                                                   q_block=qb, k_block=kb)
    torch.testing.assert_close(o, want_o, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert _k8_call(lib, q, k, v, qb, kb, w, lse=True,
                    smem=fp.working_set_bytes(qb, kb, dh) + 16)[0] != 0


@pytest.mark.parametrize("dtype", [torch.float32])  # the SIMT instance's
@pytest.mark.parametrize("case", [
    # (B, S, Hq, Hkv, dh, window, (dq_rows, dkv_rows, tile)): a ragged
    # tail, GQA groups of 2, 4 and 1, a window, many dQ, dK/dV and
    # streamed tiles
    (1, 37, 4, 2, 16, 0, (16, 8, 8)), (1, 30, 4, 1, 32, 12, (8, 8, 4)),
    (2, 20, 2, 2, 16, 0, (8, 16, 16))])
def test_k8b_under_the_mock_matches_its_plain_version(case, dtype):
    """K8b's SIMT kernels (f32: the dK/dV grid over query heads, each
    group's partials summed by the reduction) against
    ``flash_prefill_bwd_plain`` at the same tiles, on K8t's plain o and
    lse, at 1e-5 (the same f32 sums in another order).  D is rowsum(dO o);
    two runs give the same bits; a mispriced launch of either kernel is
    refused, and so is scratch given for g = 1 or missing for g > 1."""
    from repro_torch.kernels import flash_prefill as fp

    B, S, Hq, Hkv, dh, w, bl = case
    blocks = fp.BwdBlocks(*bl)
    lib = _lib("flash_prefill_bwd")
    q, k, v, dout = (t.to(dtype) for t in _attn_inputs(B, S, Hq, Hkv, dh,
                                                        seed=S + 1))
    o, lse = fp.flash_prefill_traj_plain(q, k, v, window=w)
    args = (q, k, v, o, lse, dout)
    err, *got, d, _ = _k8b_call(lib, args, w, blocks)
    err2, *again, _, _ = _k8b_call(lib, args, w, blocks)
    assert err == err2 == 0
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.testing.assert_close(
        d, (dout * o).sum(-1).transpose(1, 2), rtol=1e-5, atol=1e-5)
    want = fp.flash_prefill_bwd_plain(*args, window=w, blocks=blocks)
    for g, t in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, t, rtol=1e-5, atol=1e-5)
    for which in (0, 1):
        smem = [fp.bwd_working_set_bytes(bl[0], bl[2], dh, dtype, True),
                fp.bwd_working_set_bytes(bl[1], bl[2], dh, dtype, False)]
        smem[which] += 16
        assert _k8b_call(lib, args, w, blocks, smem=smem)[0] != 0
    wrong = torch.zeros(2, B, S, Hq, dh) if Hq == Hkv else None
    if wrong is not None:
        assert _k8b_call(lib, args, w, blocks, part=wrong)[0] != 0


@pytest.mark.parametrize("case", [
    # (B, S, Hq, Hkv, dh, window, (dq_rows, dkv_rows, tile)): a group of
    # 7 (Qwen2's), and of 1
    (1, 33, 7, 1, 16, 0, (8, 16, 8)), (2, 21, 3, 3, 32, 5, (8, 8, 4))])
def test_k8b_reduction_sums_the_heads_in_order(case):
    """The reduction reads the partials the dK/dV kernel left in the
    scratch, (2, B, S, Hq, dh): each kv head's dk is its g query heads'
    partials added in head order 0 ... g - 1, times the scale, and its dv
    the same sum, bit for bit (``head_order_sum``).  With g = 1 there is
    no scratch and the dK/dV kernel's output is the plain version's."""
    from repro_torch.kernels import flash_prefill as fp

    B, S, Hq, Hkv, dh, w, bl = case
    blocks = fp.BwdBlocks(*bl)
    lib = _lib("flash_prefill_bwd")
    q, k, v, dout = _attn_inputs(B, S, Hq, Hkv, dh, seed=S + 2)
    o, lse = fp.flash_prefill_traj_plain(q, k, v, window=w)
    args = (q, k, v, o, lse, dout)
    err, _, dk, dv, _, part = _k8b_call(lib, args, w, blocks)
    assert err == 0
    want = fp.flash_prefill_bwd_plain(*args, window=w, blocks=blocks)
    if Hq == Hkv:
        assert part is None
    else:
        g = Hq // Hkv
        parts = part.reshape(2, B, S, Hkv, g, dh).permute(0, 1, 3, 4, 2, 5)
        assert not parts.isnan().any()
        sums = [fp.head_order_sum(x).transpose(1, 2) for x in parts]
        assert torch.equal(dk, sums[0] * dh ** -0.5)
        assert torch.equal(dv, sums[1])
    torch.testing.assert_close(dk, want[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, want[2], rtol=1e-5, atol=1e-5)


def test_the_c_side_prices_k8b_as_the_table_does():
    """``flash_prefill_bwd_smem_bytes`` and ``flash_prefill_bwd_tc_smem_
    bytes`` (what each K8b launch checks its shared memory against) equal
    ``bwd_working_set_bytes``: the SIMT kernels' at every head width, row
    count and tile they take in f32; the tensor-core kernels' at every
    head width at the tiles ``choose_bwd_blocks`` gives bf16."""
    from repro_torch.kernels import flash_prefill as fp

    lib = _lib("flash_prefill_bwd")
    simt = lib.flash_prefill_bwd_smem_bytes
    simt.argtypes = [ctypes.c_int] * 4
    simt.restype = ctypes.c_longlong
    tc = lib.flash_prefill_bwd_tc_smem_bytes
    tc.argtypes = [ctypes.c_int] * 2
    tc.restype = ctypes.c_longlong
    for dh in fp.HEAD_DIMS:
        for rows in (8, 16, 32, 64):
            for tile in (4, 16, 32, 64):
                for dq in (True, False):
                    assert simt(int(dq), rows, tile, dh) == \
                        fp.bwd_working_set_bytes(rows, tile, dh,
                                                 torch.float32, dq)
        bl = fp.choose_bwd_blocks(512, dh, torch.bfloat16)
        for rows, dq in ((bl.dq_rows, True), (bl.dkv_rows, False)):
            assert tc(int(dq), dh) == fp.bwd_working_set_bytes(
                rows, bl.tile, dh, torch.bfloat16, dq)
