"""The port's Mamba selective-scan kernels' CPU half
(``repro_torch.kernels.mamba_scan``: the plain versions of K7, K7t and the
hand-derived backward K7b, ``_MambaFn``, the entry's clamps and ragged tails,
the budget tables) against torch autograd and the JAX package on the CPU.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``; here the plain versions meet JAX's ``mamba_scan_ref``
and its Pallas kernel (interpret mode: ``_kernel``, ``_traj_kernel`` and
through ``jax.vjp`` the fused backward ``_bwd_kernel``) on the same numpy
inputs, over the JAX family's cases, at the family's tolerances
``MAMBA_TOL`` and ``MAMBA_GRAD_TOL``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plans as jax_plans  # noqa: E402
from repro.kernels import mamba_scan as jax_ms  # noqa: E402

from repro_torch.core import factorization, plans  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402

TOL = plans.MAMBA_TOL
GRAD_TOL = plans.MAMBA_GRAD_TOL["float32"]
CASES = jax_plans._MAMBA_CASES
CASE_IDS = [c.label for c in CASES]
GRADS = ("dx", "ddt", "db", "dc", "da", "dh0")


def _np_inputs(B, T, di, ds, seed, dt_scale=1.0):
    """x, dt (> 0), b, c, a (< 0), h0 and the cotangents dy, dh_fin."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = (np.log1p(np.exp(f(B, T, di))) * dt_scale).astype(np.float32)
    return ([f(B, T, di), dt, f(B, T, ds), f(B, T, ds),
             -np.exp(f(di, ds)), (0.3 * f(B, di, ds)).astype(np.float32)],
            [f(B, T, di), f(B, di, ds)])


def _case(case, seed=0):
    B, T, di, ds, chunk, block_b = case.shape
    return _np_inputs(B, T, di, ds, seed), chunk, block_b


def _torch(arrays, dtype="float32"):
    """The port's tensors: x (and dy) in ``dtype``, the rest f32."""
    out = [torch.from_numpy(a) for a in arrays]
    out[0] = out[0].to(getattr(torch, dtype))
    return out


def _jax(arrays, dtype="float32"):
    out = [jnp.asarray(a) for a in arrays]
    out[0] = out[0].astype(jnp.dtype(dtype))
    return out


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _plain_bwd(args, cots, chunk):
    """The port's trajectory forward, then its hand-derived backward."""
    _, _, h_traj = ms.mamba_scan_traj(*args, chunk=chunk)
    return ms.mamba_scan_bwd_plain(*args[:5], h_traj, *cots, chunk)


def _autograd(args, cots, chunk):
    args = [a.clone().requires_grad_() for a in args]
    out = ms.mamba_scan_plain(*args, chunk)
    return torch.autograd.grad(out, args, cots)


# ---------------------------------------------------------------------------
# the forward and the trajectory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_versions_match_the_jax_reference_and_kernel(case, dtype):
    """``mamba_scan_plain``, ``mamba_scan_traj_plain`` and the entry
    against JAX's ``mamba_scan_ref`` and ``mamba_scan(interpret=True)``
    (the Pallas ``_kernel``) at the case's chunk and batch tile, y in x's
    dtype and the state f32, at MAMBA_TOL of the dtype (the state at
    f32's: it is f32 math on the same inputs)."""
    (a, _), chunk, block_b = _case(case, seed=1)
    ref = jax_ms.mamba_scan_ref(*_jax(a, dtype))
    kern = jax_ms.mamba_scan(*_jax(a, dtype), chunk=chunk, block_b=block_b)
    args = _torch(a, dtype)
    plain = ms.mamba_scan_plain(*args, chunk)
    traj = ms.mamba_scan_traj_plain(*args, chunk)
    entry = ms.mamba_scan(*args, chunk=chunk, block_b=block_b)
    for got in (plain, traj[:2], entry):
        assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
        for want in (ref, kern):
            np.testing.assert_allclose(_np(got[0]), _np(want[0]), **TOL[dtype])
            np.testing.assert_allclose(_np(got[1]), _np(want[1]),
                                       **TOL["float32"])


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c.shape[1] % c.shape[4] == 0],
                         ids=[c.label for c in CASES
                              if c.shape[1] % c.shape[4] == 0])
def test_trajectory_matches_the_jax_trajectory_kernel(case):
    """Against JAX's ``_fwd_call(traj=True)`` (``_traj_kernel``, interpret
    mode), which takes T a multiple of the chunk and B of the tile."""
    (a, _), chunk, block_b = _case(case, seed=2)
    B = a[0].shape[0]
    bm = block_b if B % block_b == 0 else 1
    jy, jh, jtraj = jax_ms._fwd_call(*_jax(a), chunk, bm, True, traj=True)
    y, h, traj = ms.mamba_scan_traj(*_torch(a), chunk=chunk)
    assert traj.dtype == torch.float32
    assert traj.shape == (B, a[0].shape[1] // chunk, *a[4].shape)
    for g, w in ((y, jy), (h, jh), (traj, jtraj)):
        np.testing.assert_allclose(_np(g), _np(w), **TOL["float32"])


def test_trajectory_holds_each_chunks_incoming_state():
    """At T=23 and chunk 8: three chunks, the first starting from h0, the
    others from the state after 8 and 16 steps; y and the final state are
    ``mamba_scan_plain``'s, bit for bit, also in bf16 (the trajectory stays
    f32)."""
    a, _ = _np_inputs(3, 23, 6, 4, seed=3)
    for dtype in ("float32", "bfloat16"):
        args = _torch(a, dtype)
        y, h, traj = ms.mamba_scan_traj(*args, chunk=8)
        want = ms.mamba_scan_plain(*args, 8)
        assert torch.equal(y, want[0]) and torch.equal(h, want[1])
        assert traj.shape == (3, 3, 6, 4) and traj.dtype == torch.float32
        assert torch.equal(traj[:, 0], args[5])
        for k in (1, 2):
            _, mid = ms.mamba_scan_plain(*(t[:, :8 * k] for t in args[:4]),
                                         args[4], args[5], 8)
            torch.testing.assert_close(traj[:, k], mid, rtol=0, atol=1e-6)


def test_the_chunk_is_io_granularity_only():
    """The chunk, the batch tile and the d_inner tile change no number:
    the entry is bit-identical at chunks 1, 5, 8, 23 and at tiles of 1 to
    3 rows (the last chunk and the last batch tile run short)."""
    a, _ = _np_inputs(3, 23, 8, 4, seed=4)
    args = _torch(a)
    base = ms.mamba_scan(*args, chunk=23)
    for chunk in (1, 5, 8):
        for block_b in (1, 2, 3):
            got = ms.mamba_scan(*args, chunk=chunk, block_b=block_b,
                                di_tile=32)
            assert all(torch.equal(g, w) for g, w in zip(got, base))


def test_rows_are_independent():
    a, _ = _np_inputs(4, 19, 8, 4, seed=5)
    args = _torch(a)
    base = ms.mamba_scan(*args, chunk=8)
    for i in (0, 3):
        alone = ms.mamba_scan(*(t[i:i + 1] if t.dim() == 3 and
                                t.shape[0] == 4 else t for t in args),
                              chunk=8)
        assert torch.equal(alone[0][0], base[0][i])
        assert torch.equal(alone[1][0], base[1][i])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dt_scale", [1e2, 1e4])
def test_finite_at_extreme_dt(dt_scale, dtype):
    """A large dt A underflows the decay to 0; no 0 * inf appears,
    forward or backward."""
    a, c = _np_inputs(2, 19, 8, 4, seed=6, dt_scale=dt_scale)
    args, cots = _torch(a, dtype), _torch(c, dtype)
    y, h, _ = ms.mamba_scan_traj(*args, chunk=8)
    assert bool(torch.isfinite(y.float()).all()) and bool(
        torch.isfinite(h).all())
    for g in _plain_bwd(args, cots, 8):
        assert bool(torch.isfinite(g.float()).all())


# ---------------------------------------------------------------------------
# the hand-derived backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bwd_plain_matches_torch_autograd(case):
    (a, c), chunk, _ = _case(case, seed=7)
    got = _plain_bwd(_torch(a), _torch(c), chunk)
    want = _autograd(_torch(a), _torch(c), chunk)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32, name
        torch.testing.assert_close(g, w, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bwd_plain_matches_the_jax_kernel(case):
    """Against ``jax.vjp`` of the JAX entry with its fused backward
    (``_bwd_kernel``, interpret mode) on the same cotangents, at the case's
    chunk and batch tile (JAX pads both; the port's plain versions run the
    tail chunk short)."""
    (a, c), chunk, block_b = _case(case, seed=8)
    _, vjp = jax.vjp(lambda *x: jax_ms.mamba_scan(
        *x, chunk=chunk, block_b=block_b, bwd=jax_ms.FUSED_BWD), *_jax(a))
    want = vjp(tuple(_jax(c)))
    got = _plain_bwd(_torch(a), _torch(c), chunk)
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("T", [64, 70])
def test_plain_versions_at_the_training_chunk_match_the_jax_kernels(T):
    """K7t's and K7b's plain versions at the chunk the training table takes
    (32 here, as at Jamba's width), on a small width, against JAX's Pallas
    ``_traj_kernel`` (``_fwd_call(traj=True)``, T a multiple of the chunk)
    and ``jax.vjp`` of the entry with its fused ``_bwd_kernel``, interpret
    mode."""
    chunk = ms.choose_blocks(T, 16, 16, target=64, mode="bwd").chunk
    assert chunk == 32
    a, c = _np_inputs(2, T, 16, 16, seed=20)
    if T % chunk == 0:
        jy, jh, jtraj = jax_ms._fwd_call(*_jax(a), chunk, 1, True, traj=True)
        y, h, traj = ms.mamba_scan_traj(*_torch(a), chunk=chunk)
        for g, w in ((y, jy), (h, jh), (traj, jtraj)):
            np.testing.assert_allclose(_np(g), _np(w), **TOL["float32"])
    _, vjp = jax.vjp(lambda *x: jax_ms.mamba_scan(
        *x, chunk=chunk, block_b=1, bwd=jax_ms.FUSED_BWD), *_jax(a))
    want = vjp(tuple(_jax(c)))
    got = _plain_bwd(_torch(a), _torch(c), chunk)
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(_np(g), _np(w), **GRAD_TOL, err_msg=name)


def test_bwd_plain_output_dtypes_follow_the_io():
    a, c = _np_inputs(2, 9, 6, 4, seed=9)
    got = _plain_bwd(_torch(a, "bfloat16"), _torch(c, "bfloat16"), 4)
    assert [g.dtype for g in got] == [torch.bfloat16] + [torch.float32] * 5
    assert [tuple(g.shape) for g in got] == [(2, 9, 6), (2, 9, 6), (2, 9, 4),
                                              (2, 9, 4), (6, 4), (2, 6, 4)]


def test_bwd_wrapper_checks_its_shapes():
    a, c = _np_inputs(2, 9, 4, 4, seed=10)
    args, cots = _torch(a), _torch(c)
    _, _, h_traj = ms.mamba_scan_traj(*args, chunk=4)
    assert h_traj.shape == (2, 3, 4, 4)
    with pytest.raises(ValueError, match="h_traj"):
        ms.mamba_scan_bwd(*args[:5], h_traj[:, :2], *cots, chunk=4)
    with pytest.raises(ValueError, match="dy"):
        ms.mamba_scan_bwd(*args[:5], h_traj, cots[0][:, :4], cots[1],
                          chunk=4)
    before = ms.mamba_scan_bwd.launches
    got = ms.mamba_scan_bwd(*args[:5], h_traj, *cots, chunk=4)
    want = ms.mamba_scan_bwd_plain(*args[:5], h_traj, *cots, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ms.mamba_scan_bwd.launches == before


# ---------------------------------------------------------------------------
# the autograd Function and the oracle route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_under_autograd_equals_autograd_of_the_plain_version(dtype):
    """``mamba_scan`` under autograd runs ``_MambaFn`` (on the CPU the
    trajectory forward's and the backward's plain versions) on the inputs
    as given, a short last chunk and batch tile included; its gradients
    equal autograd of the plain scan, in the inputs' dtypes."""
    a, c = _np_inputs(3, 13, 6, 4, seed=11)
    args, cots = _torch(a, dtype), _torch(c, dtype)
    mine = [t.clone().requires_grad_() for t in args]
    out = ms.mamba_scan(*mine, chunk=4, block_b=2)
    assert out[1].grad_fn is not None
    got = torch.autograd.grad(out, mine, cots)
    want = _autograd(args, cots, 4)
    tol = GRAD_TOL if dtype == "float32" else TOL[dtype]
    for g, w, x in zip(got, want, args):
        assert g.dtype == x.dtype
        torch.testing.assert_close(g.float(), w.float(), **tol)


def test_oracle_bwd_differentiates_the_plain_scan_on_the_cpu():
    """``bwd=ORACLE_BWD`` (JAX's fallback past the backward's table) takes
    autograd of the plain scan on the CPU: no ``_MambaFn`` in the graph,
    the same gradients; the plan takes it where the table finds nothing,
    with a ``plan/dispatch fallback=`` event."""
    a, c = _np_inputs(2, 12, 8, 4, seed=12)
    args, cots = _torch(a), _torch(c)
    mine = [t.clone().requires_grad_() for t in args]
    y, h = ms.mamba_scan(*mine, chunk=4)
    assert h.grad_fn.name().startswith("_MambaFn")
    y, h = ms.mamba_scan(*mine, chunk=4, bwd=ms.ORACLE_BWD)
    assert not h.grad_fn.name().startswith("_MambaFn")
    got = torch.autograd.grad((y, h), mine, cots)
    for g, w in zip(got, _autograd(args, cots, 4)):
        torch.testing.assert_close(g, w, **GRAD_TOL)
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        mine = [t.clone().requires_grad_() for t in args]
        with pytest.MonkeyPatch.context() as mp:
            real = ms.choose_blocks
            mp.setattr(ms, "choose_blocks", lambda *p, mode="fwd", **k:
                       None if mode == "bwd" else real(*p, mode=mode, **k))
            y, h = plans.MAMBA_PLANS["fused_scan"](*mine, chunk=4,
                                                   block_b=None)
    finally:
        trace_lib.set_tracer(old)
    got = torch.autograd.grad((y, h), mine, cots)
    for g, w in zip(got, _autograd(args, cots, 4)):
        torch.testing.assert_close(g, w, **GRAD_TOL)
    events = [r["attrs"] for r in sink.records
              if r["name"] == "plan/dispatch"]
    assert events[0]["fallback"] == "oracle_bwd" and events[0]["train"]
    assert events[1]["bwd"] == ms.ORACLE_BWD


def test_no_gradient_means_no_function():
    a = [t.requires_grad_() for t in _torch(_np_inputs(2, 8, 4, 4,
                                                       seed=13)[0])]
    with torch.no_grad():
        y, h = ms.mamba_scan(*a, chunk=4)
    assert y.grad_fn is None and h.grad_fn is None


# ---------------------------------------------------------------------------
# the budget tables
# ---------------------------------------------------------------------------
def test_working_set_term_by_term():
    """Jamba's width (d_state 16) at the training chunk 32: the forward (K7,
    K7t) at a tile of 64 channels, one a thread, holds the x and dt windows
    (32, 64) and the B and C rows (32, 16), 20,480 bytes, eight blocks and
    sixteen warps an SM; K7b at the same tile, four lanes a channel (256
    threads), holds no per-step state of the chunk, 98,304 bytes in f32
    IO, two blocks and sixteen warps an SM."""
    fwd = {"x_dt": 2 * 32 * 64 * 4, "b_c": 2 * 32 * 16 * 4}
    threads = ms.BWD_LANES * 64
    bwd = {
        # the state at each sub-chunk's start, a float4 a lane: 4 of 8 steps
        "checkpoints": 32 // ms.BWD_SUB * threads * 16,
        # each warp's 32 dB/dC sums of each of a sub-chunk's 8 steps, in
        # two slots by sub-chunk parity
        "sums": 2 * ms.BWD_SUB * threads * 4,
        # two chunk windows: dt f32, x and dy in the IO dtype (f32 here),
        # the chunk's incoming state (64, 16) and the B and C rows (32, 16)
        "ring": 2 * (32 * 64 * (4 + 2 * 4) + 64 * 16 * 4 + 2 * 32 * 16 * 4)}
    assert ms.working_set_bytes(512, 16, 32, 64) == sum(fwd.values()) \
        == 20_480
    assert ms.working_set_bytes(512, 16, 32, 64, mode="bwd") == \
        sum(bwd.values()) == 98_304
    for nbytes, blocks in ((20_480, 8), (98_304, 2)):
        assert blocks * (nbytes + factorization.H100_SMEM_RESERVED_PER_BLOCK)\
            <= factorization.H100_SMEM_PER_SM
    # bf16 IO stages x and dy at 2 bytes
    assert ms.working_set_bytes(512, 16, 32, 64, mode="bwd", io_bytes=2) == \
        98_304 - 2 * 32 * 64 * 2 * 2
    # the d_inner tile is a term of both tables; the chunk clamps to T; an
    # odd window rounds up to 16 bytes
    assert ms.working_set_bytes(512, 16, 32, 32, mode="bwd") < 98_304
    assert ms.working_set_bytes(512, 16, 32, 32) < sum(fwd.values())
    assert ms.working_set_bytes(5, 16, 8, 128) == \
        ms.working_set_bytes(5, 16, 5, 128)
    assert ms.working_set_bytes(512, 5, 7, 8, mode="bwd") % 16 == 0
    with pytest.raises(ValueError):
        ms.working_set_bytes(512, 16, 4, 128, mode="train")


def test_block_budget_keeps_sixteen_warps_an_sm():
    for threads, blocks in ((256, 2), (128, 4), (64, 8), (32, 16)):
        assert ms.block_budget(threads) == \
            factorization.H100_SMEM_PER_SM // blocks - 1024
        assert blocks * threads // 32 == ms.MIN_WARPS_PER_SM


def test_choose_blocks_at_jambas_width():
    """Serving halves the config's chunk 64 to 32, where four blocks of
    the widest tile share an SM.  Training takes chunk 32 at a tile of 64
    channels: there K7t's windows fit eight blocks an SM and K7b (which no
    longer stages a chunk's states) two, so K7t writes its trajectory every
    32 steps; at chunk 64 K7t's windows fit no tile at sixteen warps, nor
    K7b's two chunk windows at the widest tile."""
    assert ms.choose_blocks(512, 16384, 16, target=64) == \
        ms.MambaBlocks(1, 32, 128)
    train = ms.choose_blocks(512, 16384, 16, target=64, mode="bwd")
    assert train == ms.MambaBlocks(1, 32, 64) and train.chunk >= 32
    for tile in (64, 32):
        assert ms.working_set_bytes(512, 16, 64, tile) > \
            ms.block_budget(tile)
    assert ms.working_set_bytes(512, 16, 64, 64, mode="bwd") > \
        ms.block_budget(ms.BWD_LANES * 64)
    assert ms.choose_blocks(1, 16384, 16, target=64) == \
        ms.MambaBlocks(1, 1, 128)
    for chunk in (1, 4, 64):
        for tile in (32, 64):
            assert ms.working_set_bytes(512, 16, chunk, tile, mode="bwd") > \
                ms.working_set_bytes(512, 16, chunk, tile)
    # an explicit budget: the tile halves before the chunk does
    at = ms.working_set_bytes(512, 16, 8, 64, mode="bwd")
    assert ms.choose_blocks(512, 16384, 16, target=8, smem_budget=at,
                            mode="bwd") == ms.MambaBlocks(1, 8, 64)
    assert ms.choose_blocks(512, 16384, 16, target=8, smem_budget=at - 1,
                            mode="bwd") == ms.MambaBlocks(1, 8, 32)
    at = ms.working_set_bytes(512, 16, 8, 32, mode="bwd")
    assert ms.choose_blocks(512, 16384, 16, target=8, smem_budget=at - 1,
                            mode="bwd") == ms.MambaBlocks(1, 4, 32)
    # narrow d_inner: one warp; too many states for the registers: None
    assert ms.choose_blocks(24, 8, 4, target=8) == ms.MambaBlocks(1, 8, 32)
    assert ms.choose_blocks(24, 8, 4, target=8, mode="bwd") == \
        ms.MambaBlocks(1, 8, 32)
    assert ms.choose_blocks(512, 16384, 17, target=64) is None
    assert ms.choose_blocks(512, 16384, 16, smem_budget=1024,
                            mode="bwd") is None


def test_mamba_viability_for_serving_and_training():
    assert plans.mamba_viability(512, 16384, 16, chunk=64)("fused_scan")
    assert plans.mamba_viability(512, 16384, 16, chunk=64,
                                 train=True)("fused_scan")
    at = ms.working_set_bytes(512, 16, 1, 32, mode="bwd")
    tight = plans.mamba_viability(512, 16384, 16, smem_budget=at - 1,
                                  train=True)
    assert not tight("fused_scan") and tight("scan")
    assert plans.mamba_viability(512, 16384, 16,
                                 smem_budget=at - 1)("fused_scan")


def test_training_on_the_card_raises_past_the_budget(monkeypatch):
    """Past the backward's table a CUDA training call raises naming the
    working set (no plain version stands in for K7b there); the CPU gets
    None and takes the oracle VJP.  The forward's table past its end
    raises the same way."""
    real = ms.choose_blocks
    monkeypatch.setattr(ms, "choose_blocks", lambda *p, mode="fwd", **k:
                        None if mode == "bwd" else real(*p, mode=mode, **k))
    with pytest.raises(ValueError, match="working set of the bwd kernel"):
        plans._mamba_scan_blocks(512, 16384, 16, 64, torch.device("cuda"),
                                 train=True)
    assert plans._mamba_scan_blocks(512, 16384, 16, 64, torch.device("cpu"),
                                    train=True) is None
    assert plans._mamba_scan_blocks(512, 16384, 16, 64,
                                    torch.device("cuda")) is not None
    monkeypatch.setattr(ms, "choose_blocks", real)
    with pytest.raises(ValueError, match="working set of the fwd kernel"):
        plans._mamba_scan_blocks(512, 16384, 32, 64, torch.device("cuda"))
