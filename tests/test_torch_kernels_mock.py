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
