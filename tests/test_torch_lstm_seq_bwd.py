"""The port's training half of the sequence-resident LSTM — the
trajectory oracle, the backward's plain version, the backward budget table
and the autograd wiring, all on the CPU — against the JAX package (its
Pallas kernels in interpret mode) and against torch autograd."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import tiling as jax_tiling  # noqa: E402
from repro.kernels import lstm_seq as jax_seq  # noqa: E402
from repro.kernels import lstm_seq_bwd as jax_bwd  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402

from repro_torch.configs.mobirnn_lstm import LSTMConfig  # noqa: E402
from repro_torch.core import factorization, lstm, tiling  # noqa: E402
from repro_torch.kernels import lstm_seq as seq_k  # noqa: E402
from repro_torch.kernels import lstm_seq_bwd as bwd_k  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402

#: the JAX package's f32 gradient tolerance (core/plans.LSTM_GRAD_TOL)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
#: the trajectory contract's tolerance (tests/test_lstm_seq.py)
TRAJ_TOL = dict(rtol=1e-6, atol=1e-6)
#: (L, H, D, B, T) of tests/test_lstm_seq.py's trajectory and backward cases
SHAPES = {"odd": (2, 32, 9, 3, 7), "T1": (1, 8, 5, 2, 1),
          "L1": (1, 16, 16, 4, 6), "DgtH": (3, 16, 40, 5, 4)}


def _operands(seed, L, H, D, B, T):
    """numpy stacked weights (L, P+H, 4H), bias, padded input and final
    state cotangents, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    P = max(D, H)
    w = (rng.standard_normal((L, P + H, 4 * H)) * 0.3).astype(np.float32)
    w[0, D:P] = 0.0                         # layer 0's padded input rows
    if P > H:
        w[1:, H:P] = 0.0                    # later layers' padded rows
    b = (rng.standard_normal((L, 4 * H)) * 0.1).astype(np.float32)
    x = np.zeros((B, T, P), np.float32)
    x[..., :D] = rng.standard_normal((B, T, D))
    dc = rng.standard_normal((L, B, H)).astype(np.float32)
    dh = rng.standard_normal((L, B, H)).astype(np.float32)
    return w, b, x, dc, dh


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _autograd_ref(w, b, x, dc, dh):
    """torch autograd of ref.lstm_seq under the cotangents (dc, dh)."""
    w, b, x = (t.clone().requires_grad_() for t in (w, b, x))
    c, h = ref.lstm_seq(w, b, x)
    return torch.autograd.grad((c, h), (w, b, x), (dc, dh))


@pytest.mark.parametrize("shape", [SHAPES["odd"], SHAPES["T1"],
                                   SHAPES["DgtH"]],
                         ids=["odd", "T1", "DgtH"])
def test_ref_traj_matches_jax_ref_and_pallas(shape):
    w, b, x, _, _ = _operands(0, *shape)
    got = ref.lstm_seq_traj(*_t(w, b, x))
    c, h, ct, ht = got
    T, L, B, H = x.shape[1], w.shape[0], x.shape[0], w.shape[-1] // 4
    assert ct.dtype == ht.dtype == torch.float32
    assert ct.shape == ht.shape == (T, L, B, H)
    for want in (jax_ref.lstm_seq_traj(jnp.asarray(w), jnp.asarray(b),
                                       jnp.asarray(x)),
                 jax_seq._lstm_seq_traj_call(jnp.asarray(w), jnp.asarray(b),
                                             jnp.asarray(x), 2, True)):
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TRAJ_TOL)
    # (c, h) are exactly lstm_seq's, and the last trajectory row is them
    c0, h0 = ref.lstm_seq(*_t(w, b, x))
    assert torch.equal(c, c0) and torch.equal(h, h0)
    assert torch.equal(ct[-1], c) and torch.equal(ht[-1], h)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_bwd_plain_matches_pallas_and_autograd(shape):
    w, b, x, dc, dh = _operands(1, *shape)
    tw, tb, tx, tdc, tdh = _t(w, b, x, dc, dh)
    _, _, ct, ht = ref.lstm_seq_traj(tw, tb, tx)
    got = bwd_k.lstm_seq_bwd_plain(tw, tb, tx, ct, ht, tdc, tdh)
    pallas = jax_bwd.lstm_seq_bwd(
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(x),
        jnp.asarray(ct.numpy()), jnp.asarray(ht.numpy()), jnp.asarray(dc),
        jnp.asarray(dh), block_b=2, interpret=True)
    for g, r in zip(got, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL)
    for g, r in zip(got, _autograd_ref(tw, tb, tx, tdc, tdh)):
        torch.testing.assert_close(g, r, **GRAD_TOL)
    assert all(float(g.abs().max()) > 0 for g in got)


def test_bwd_wrapper_takes_its_plain_version_on_the_cpu():
    w, b, x, dc, dh = _t(*_operands(2, *SHAPES["odd"]))
    _, _, ct, ht = ref.lstm_seq_traj(w, b, x)
    before = bwd_k.lstm_seq_bwd.launches
    got = bwd_k.lstm_seq_bwd(w, b, x, ct, ht, dc, dh, block_b=2,
                             time_chunk=3)
    want = bwd_k.lstm_seq_bwd_plain(w, b, x, ct, ht, dc, dh)
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    assert bwd_k.lstm_seq_bwd.launches == before  # CPU calls are not counted


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    w, b, x, dc, dh = _t(*_operands(3, *SHAPES["odd"]))
    _, _, ct, ht = ref.lstm_seq_traj(w, b, x)
    with pytest.raises(TypeError):
        bwd_k.lstm_seq_bwd(w, b, x.double(), ct, ht, dc, dh, block_b=2)
    with pytest.raises(ValueError):
        bwd_k.lstm_seq_bwd(w, b, x, ct[1:], ht, dc, dh, block_b=2)
    with pytest.raises(ValueError, match="block_b"):
        bwd_k.lstm_seq_bwd(w, b, x, ct, ht, dc, dh, block_b=3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        bwd_k.lstm_seq_bwd(*(t.to("meta") for t in (w, b, x, ct, ht, dc,
                                                    dh)), block_b=2)


#: 2 x 64: its weight stack and dW accumulators fit no thread block
PAST_BUDGET = (2, 64, 9, 3, 5)


@pytest.mark.parametrize("bwd", [(None, None), (2, 3), (1, 1), "2x64"],
                         ids=["auto", "streamed", "tc1", "oracle"])
def test_autograd_function_matches_autograd_of_ref(bwd):
    """``lstm_seq`` under autograd — the trajectory forward and the
    backward's plain version on the CPU, or, at a width whose backward fits
    no thread block, the oracle — gives the grads of autograd through
    ``ref.lstm_seq``, and the forward's outputs."""
    shape = PAST_BUDGET if bwd == "2x64" else SHAPES["odd"]
    w, b, x, dc, dh = _t(*_operands(4, *shape))
    ins = [t.clone().requires_grad_() for t in (w, b, x)]
    kw = {} if bwd == "2x64" else dict(bwd_block_b=bwd[0],
                                       bwd_time_chunk=bwd[1])
    c, h = ops.lstm_seq(*ins, **kw)
    assert c.grad_fn is not None
    c0, h0 = ref.lstm_seq(w, b, x)
    assert torch.equal(c.detach(), c0) and torch.equal(h.detach(), h0)
    got = torch.autograd.grad((c, h), ins, (dc, dh))
    for g, r in zip(got, _autograd_ref(w, b, x, dc, dh)):
        torch.testing.assert_close(g, r, **GRAD_TOL)


def test_autograd_matches_the_pallas_custom_vjp():
    """The port's training path against the JAX package's ``custom_vjp``
    (trajectory kernel + reverse-sweep kernel, Pallas interpret mode) on a
    streamed tiling."""
    w, b, x, dc, dh = _operands(5, *SHAPES["DgtH"])
    ins = [t.requires_grad_() for t in _t(w, b, x)]
    c, h = ops.lstm_seq(*ins, bwd_block_b=2, bwd_time_chunk=3)
    got = torch.autograd.grad((c, h), ins, tuple(_t(dc, dh)))
    jc, jh = jnp.asarray(dc), jnp.asarray(dh)

    def loss(w, b, x):
        c, h = jax_seq.lstm_seq(w, b, x, bwd_block_b=2, bwd_time_chunk=3,
                                interpret=True)
        return jnp.sum(c * jc) + jnp.sum(h * jh)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(b),
                                             jnp.asarray(x))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL)


def test_no_grad_runs_the_plain_forward():
    w, b, x, _, _ = _t(*_operands(6, *SHAPES["odd"]))
    w.requires_grad_()
    with torch.no_grad():
        c, h = ops.lstm_seq(w, b, x)
    assert c.grad_fn is None and not h.requires_grad


@pytest.mark.parametrize("bm_tc", [(1, None), (4, None), (1, 32), (16, 8)])
def test_bwd_working_set_terms(bm_tc):
    """The backward's set, term by term, is exactly the shared memory
    lstm_seq_bwd.cu carves out, and holds every forward term at least as
    large, so it is larger than the forward's."""
    bm, tc = bm_tc
    L, P, H, T = 2, 32, 32, 128
    fwd = seq_k.working_set_bytes(T, L, P, H, bm, time_chunk=tc)
    bwd = seq_k.working_set_bytes(T, L, P, H, bm, mode="bwd", time_chunk=tc)
    x_rows = T if tc is None else 2 * tc
    traj_rows = T + 1 if tc is None else 2 * (tc + 1)
    shared = (L * (P + H) * (4 * H + 8) * 4 + L * 4 * H * 4  # W, bias
              + x_rows * bm * P * 4                         # x ring
              + 2 * L * bm * H * 4 + bm * 4 * H * 4)        # (dc, dh), gates
    own = (L * (P + H) * (4 * H + 8) * 4 + L * 4 * H * 4    # dW, db accum
           + 2 * traj_rows * L * bm * H * 4                 # c, h windows
           + bm * 4 * H * 4 + bm * H * 4)                   # dgates, dinp
    assert bwd == shared + own
    assert bwd > fwd


@pytest.mark.parametrize("case", [
    # (T, L, P, H, block_b, kwargs, bytes): what the backward kernel
    # launched with before the forward became a wavefront, unchanged
    (128, 2, 32, 32, 1, {}, 225408),
    (128, 2, 32, 32, 4, {}, 477696),
    (128, 2, 32, 32, 1, dict(time_chunk=32), 184960),
    (128, 2, 32, 32, 16, dict(time_chunk=8), 348160),
    (128, 2, 32, 32, 1, dict(quantized=True), 175744),
    (300, 2, 32, 32, 1, dict(time_chunk=37), 191360),
    (300, 2, 32, 32, 1, dict(time_chunk=75, quantized=True), 190336),
    (128, 2, 64, 64, 1, dict(time_chunk=1, quantized=True), 355072),
    (20, 2, 9, 8, 1, {}, 15216),
], ids=["B1", "tile4", "tc32", "tile16-tc8", "q8", "T300-tc37",
        "q8-T300-tc75", "q8-2x64-tc1", "PgtH"])
def test_bwd_bytes_are_unchanged(case):
    T, L, P, H, bm, kw, nbytes = case
    assert seq_k.working_set_bytes(T, L, P, H, bm, mode="bwd", **kw) == nbytes


def test_a_bwd_tiling_fits_the_trajectory_launch_that_feeds_it():
    """Wherever the training table finds a tiling, the trajectory forward
    launches at it: its bytes within the budget and its threads within its
    instance's bound."""
    budget = factorization.H100_SMEM_PER_BLOCK
    for L, H in ((1, 32), (2, 32), (3, 32), (1, 8), (2, 48), (4, 16),
                 (2, 20)):
        P = max(9, H)
        for B in (1, 64, 300, 2000):
            for T in (1, 7, 128, 300, 2048):
                for q8 in (False, True):
                    got = seq_k.choose_batch_block(B, T, L, P, H, mode="bwd",
                                                   quantized=q8)
                    if got is None:
                        continue
                    home = seq_k.weight_home(L, P, H, got.block_b)
                    assert seq_k.working_set_bytes(
                        T, L, P, H, got.block_b, time_chunk=got.time_chunk,
                        quantized=q8) <= budget, (L, H, B, T, q8, got)
                    assert seq_k.fwd_threads(L, H) <= \
                        seq_k.fwd_max_threads(got.block_b, home)


@pytest.mark.parametrize("case", [
    # (L, H, B, T, expected): the paper's 2 x 32 keeps whole T at T=128
    # (225,408 of 232,448 bytes) in one-row blocks; at T=300 the halving
    # walk 150, 75, 37 first fits at 37 (75 needs 240,000 bytes); the
    # 16-row tiles of a batch of 2000 hold 168 KiB before any window, so
    # only 2-step chunks fit; 2 x 64 fits neither forward nor backward
    (2, 32, 1, 128, seq_k.SeqBlocks(1, None)),
    (2, 32, 64, 128, seq_k.SeqBlocks(1, None)),
    (2, 32, 64, 300, seq_k.SeqBlocks(1, 37)),
    (2, 32, 2000, 128, seq_k.SeqBlocks(16, 2)),
    (2, 64, 1, 128, None),
], ids=["2x32-B1", "2x32-B64", "2x32-T300", "2x32-B2000", "2x64"])
def test_choose_batch_block_bwd_on_the_hopper_budget(case):
    L, H, B, T, expected = case
    got = seq_k.choose_batch_block(B, T, L, max(9, H), H, mode="bwd")
    assert got == expected
    if got is not None:
        assert seq_k.working_set_bytes(
            T, L, H, H, got.block_b, mode="bwd",
            time_chunk=got.time_chunk) <= factorization.H100_SMEM_PER_BLOCK


def test_budget_window_routes_the_backward_to_the_oracle():
    """A budget that holds the forward but not the backward: the forward
    stays fused and a training call of ``fused_seq`` runs on
    ``fused_cell``.  Where the backward fits nowhere, ``lstm_seq`` itself
    takes autograd of the oracle on the CPU, each named by a plan/dispatch
    event, while a CUDA call would raise."""
    cfg = LSTMConfig(hidden=16, n_layers=2, seq_len=6)
    P = max(cfg.input_dim, cfg.hidden)
    fwd_min = seq_k.working_set_bytes(6, 2, P, 16, 1, time_chunk=1)
    bwd_min = seq_k.working_set_bytes(6, 2, P, 16, 1, mode="bwd",
                                      time_chunk=1)
    budget = (fwd_min + bwd_min) // 2
    assert seq_k.choose_batch_block(3, 6, 2, P, 16, smem_budget=budget)
    assert seq_k.choose_batch_block(3, 6, 2, P, 16, smem_budget=budget,
                                    mode="bwd") is None
    viable = lstm.plan_viability(cfg, 3, 6, smem_budget=budget)
    viable_train = lstm.plan_viability(cfg, 3, 6, smem_budget=budget,
                                       train=True)
    assert viable("fused_seq") and not viable_train("fused_seq")
    assert viable_train("sequential")

    params = lstm.init_params(torch.Generator().manual_seed(0), cfg)
    leaves = [params["layers"][0]["w"], params["head"]["w"]]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 6, 9)).astype(np.float32))
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        served = lstm.forward_fused_seq(params, x, cfg, smem_budget=budget)
        for t in leaves:
            t.requires_grad_()
        out = lstm.forward_fused_seq(params, x, cfg, smem_budget=budget)
        full = lstm.forward_fused_seq(params, x, cfg)
        wide = [t.requires_grad_() for t in _t(*_operands(8, *PAST_BUDGET))]
        c, h = ops.lstm_seq(*wide[:3])
    finally:
        trace_lib.set_tracer(old)
    attrs = [r["attrs"] for r in sink.records if r["name"] == "plan/dispatch"]
    assert len(attrs) == 4
    assert attrs[0]["block_b"] >= 1 and not attrs[0]["train"]
    assert "fallback" not in attrs[0] and "bwd_block_b" not in attrs[0]
    assert attrs[1]["fallback"] == "fused_cell" and attrs[1]["train"]
    assert attrs[2]["train"] and attrs[2]["bwd_block_b"] >= 1
    assert attrs[2]["bwd_block_b"] == attrs[2]["block_b"]
    assert attrs[3]["fallback"] == "oracle_bwd"
    assert attrs[3]["bwd_block_b"] == seq_k.ORACLE_BWD
    torch.testing.assert_close(served, out.detach(), rtol=2e-5, atol=2e-5)
    want = torch.autograd.grad(lstm.forward_sequential(params, x, cfg).sum(),
                               leaves)
    for logits in (out, full):
        got = torch.autograd.grad(logits.sum(), leaves)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, **GRAD_TOL)
    assert h.grad_fn is not None
    L, H, _, B, T = PAST_BUDGET
    with pytest.raises(ValueError, match="working set of .* bytes"):
        seq_k._resolve_specs(B, T, L, H, H, bwd_block_b=None,
                             bwd_time_chunk=None, device=torch.device("cuda"))
    with pytest.raises(ValueError, match="bwd_block_b"):
        ops.lstm_seq(*wide[:3], bwd_block_b=seq_k.ORACLE_BWD)


@pytest.mark.parametrize("args", [(128, 32), (7, 3), (5, 5), (1, 1)])
def test_bwd_window_rows_match_jax(args):
    assert tiling.bwd_window_rows(*args) == jax_tiling.bwd_window_rows(*args)


def test_working_set_mode_is_checked():
    with pytest.raises(ValueError):
        tiling.WorkingSet("train")
    ws = tiling.WorkingSet().add("a", 3).add("b", 4, bwd_only=True)
    assert ws.terms == {"a": 3}
    ws = tiling.WorkingSet("bwd").add("a", 3).add("b", 4, bwd_only=True)
    assert ws.total() == 7


@pytest.mark.parametrize("rows_threads", [(64, 512, 8), (17, 128, 4),
                                          (56, 256, 4), (2000, 128, 1),
                                          (5, 1024, 32)])
def test_dot_parts_cover_the_rows(rows_threads):
    rows, threads, parts = rows_threads
    assert bwd_k.dot_parts(rows, threads) == parts
    assert parts == 1 or parts * rows <= threads
