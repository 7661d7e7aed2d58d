"""K7b (``csrc/mamba_scan_bwd.cu``) and K3 (``csrc/lstm_seq_bwd.cu``) run on
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

from repro_torch.core import factorization  # noqa: E402
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


def test_the_c_side_prices_every_launch_as_the_tables_do():
    """``mamba_scan_bwd_smem_bytes`` (what K7b's launch checks its shared
    memory against) equals ``working_set_bytes(mode="bwd")`` at every shape
    the training table and the wrapper launch, f32 and bf16 IO; the
    register home's ``lstm_seq_bwd_wave_smem_bytes`` equals the LSTM
    table's at 1 and 2 layers, f32 and int8, at every T and time chunk."""
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
