"""The port's int8 plan ``fused_seq_q8`` against the JAX package on the CPU:
the scale contract (codes and scales bit-equal), the q8 forward and its
trajectory launch (their plain versions here) against the Pallas q8 kernels
in interpret mode and the dequantize oracle, the straight-through
gradients, the q8 budget table, and the plan with its routes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mobirnn_lstm import LSTMConfig as JaxConfig  # noqa: E402
from repro.core import lstm as jax_lstm  # noqa: E402
from repro.kernels import lstm_seq as jax_seq  # noqa: E402
from repro.kernels import lstm_seq_bwd as jax_bwd  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.mobirnn_lstm import LSTMConfig  # noqa: E402
from repro_torch.core import lstm, plans  # noqa: E402
from repro_torch.kernels import lstm_seq as seq_k  # noqa: E402
from repro_torch.kernels import lstm_seq_bwd as bwd_k  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

#: kernel-vs-dequantize-oracle agreement (tests/test_plan_equivalence.py):
#: fp rounding of the folded per-channel scale only
Q8_ORACLE_TOL = dict(rtol=1e-4, atol=1e-5)
#: the trajectory contract's tolerance at q8 (tests/test_lstm_seq.py)
Q8_TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
#: the JAX package's f32 gradient tolerance (core/plans.LSTM_GRAD_TOL)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
#: (L, H, D, B, T) of tests/test_lstm_seq.py's q8 cases
SHAPES = {"odd": (2, 32, 9, 3, 7), "T1": (1, 8, 5, 2, 1),
          "L1": (1, 16, 16, 4, 6), "DgtH": (3, 16, 40, 5, 4)}


def _operands(seed, L, H, D, B, T):
    """numpy stacked weights (L, P+H, 4H), bias, padded input and final
    state cotangents, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    P = max(D, H)
    w = (rng.standard_normal((L, P + H, 4 * H)) * 0.3).astype(np.float32)
    w[0, D:P] = 0.0
    if P > H:
        w[1:, H:P] = 0.0
    b = (rng.standard_normal((L, 4 * H)) * 0.1).astype(np.float32)
    x = np.zeros((B, T, P), np.float32)
    x[..., :D] = rng.standard_normal((B, T, D))
    dc = rng.standard_normal((L, B, H)).astype(np.float32)
    dh = rng.standard_normal((L, B, H)).astype(np.float32)
    return w, b, x, dc, dh


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, **tol):
    for g, r in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), **tol)


def _events(fn):
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        out = fn()
    finally:
        trace_lib.set_tracer(old)
    return out, [r["attrs"] for r in sink.records
                 if r["name"] == "plan/dispatch"]


# ---------------------------------------------------------------------------
# The scale contract
# ---------------------------------------------------------------------------
def _boundary_stack(seed):
    """A stack with a third of its entries planted on .5 code boundaries:
    (k + 0.5) * scale, where f32 division and round-half-to-even decide."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((2, 41, 64)) * 0.3).astype(np.float32)
    amax = np.abs(w).max(axis=1)
    scales = (np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)
              ).astype(np.float32)
    k = rng.integers(-126, 126, size=(2, 14, 64))
    w[:, :14] = ((k + 0.5) * scales[:, None, :]).astype(np.float32)
    return w


@pytest.mark.parametrize("stack", ["seed0", "seed1", "wide", "zeros",
                                   "boundaries0", "boundaries1"])
def test_quantize_is_bit_equal_to_jax(stack):
    rng = np.random.default_rng(len(stack))
    w = {"seed0": lambda: rng.standard_normal((2, 41, 128)),
         "seed1": lambda: rng.standard_normal((3, 56, 64)) * 1e-3,
         "wide": lambda: rng.standard_normal((1, 9, 8)) * 50.0,
         "zeros": lambda: np.zeros((2, 5, 16)),
         "boundaries0": lambda: _boundary_stack(0),
         "boundaries1": lambda: _boundary_stack(1)}[stack]()
    w = np.asarray(w, np.float32)
    wq, scales = ref.quantize_q8(torch.from_numpy(w))
    jq, js = jax_ref.quantize_q8(jnp.asarray(w))
    assert wq.dtype == torch.int8 and scales.dtype == torch.float32
    assert scales.shape == (w.shape[0], w.shape[-1])
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        ref.dequantize_q8(wq, scales).numpy(),
        np.asarray(jax_ref.dequantize_q8(jq, js)))


def test_boundary_codes_need_f32_division():
    """The planted stack really sits on .5 boundaries: f64 arithmetic
    rounds some of its codes the other way, so the bit-equality above
    pins the f32 division."""
    w = _boundary_stack(0)
    wq, scales = ref.quantize_q8(torch.from_numpy(w))
    f64 = np.clip(np.round(w.astype(np.float64)
                           / scales.numpy()[:, None, :].astype(np.float64)),
                  -127, 127).astype(np.int8)
    assert not np.array_equal(f64, wq.numpy())


def test_quantize_is_symmetric_and_within_half_a_step():
    w = torch.from_numpy(_operands(0, *SHAPES["odd"])[0])
    wq, scales = ref.quantize_q8(w)
    assert int(wq.to(torch.int32).abs().max()) <= 127
    neg_q, neg_s = ref.quantize_q8(-w)
    assert torch.equal(neg_s, scales)
    assert torch.equal(neg_q.to(torch.int32), -wq.to(torch.int32))
    err = (ref.dequantize_q8(wq, scales) - w).abs()
    assert float((err - scales[:, None, :] / 2).max()) <= 1e-6


def test_ste_has_the_dequantized_value_and_the_identity_gradient():
    w = torch.from_numpy(_operands(1, *SHAPES["odd"])[0]).requires_grad_()
    ste = ref.quantize_dequantize_ste(w)
    assert torch.equal(ste.detach(), ref.dequantize_q8(*ref.quantize_q8(w)))
    (g,) = torch.autograd.grad(ste, w, torch.full_like(w, 3.0))
    assert torch.equal(g, torch.full_like(w, 3.0))
    np.testing.assert_array_equal(
        ste.detach().numpy(),
        np.asarray(jax_ref.quantize_dequantize_ste(jnp.asarray(
            w.detach().numpy()))))


# ---------------------------------------------------------------------------
# The q8 forward, its trajectory launch and the q8 backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_lstm_seq_q8_matches_the_jax_kernel_and_the_oracle(shape):
    w, b, x, _, _ = _operands(2, *shape)
    got = ops.lstm_seq_q8(*_t(w, b, x))
    _close(got, jax_seq.lstm_seq_q8(*_j(w, b, x), interpret=True),
           **Q8_ORACLE_TOL)
    jq, js = jax_ref.quantize_q8(jnp.asarray(w))
    _close(got, jax_ref.lstm_seq_q8(jq, js, *_j(b, x)), **Q8_ORACLE_TOL)
    wq, scales = ref.quantize_q8(torch.from_numpy(w))
    _close(got, ref.lstm_seq_q8(wq, scales, *_t(b, x)), **Q8_ORACLE_TOL)
    # the CPU path is the plain version of the kernel, the scale folded in
    plain = seq_k.lstm_seq_q8_plain(wq, scales, *_t(b, x))
    assert all(torch.equal(g, r) for g, r in zip(got, plain))


def test_q8_traj_matches_the_jax_trajectory_kernel():
    w, b, x, _, _ = _operands(3, 2, 16, 9, 3, 7)
    wq, scales = ref.quantize_q8(torch.from_numpy(w))
    got = seq_k.lstm_seq_q8_traj(wq, scales, *_t(b, x))
    c, h, ct, ht = got
    assert ct.dtype == ht.dtype == torch.float32
    assert ct.shape == ht.shape == (7, 2, 3, 16)
    want = jax_seq._lstm_seq_traj_call(
        jnp.asarray(wq.numpy()), *_j(b, x), 2, True,
        scales=jnp.asarray(scales.numpy()))
    _close(got, want, **Q8_TRAJ_TOL)
    _close(got, ref.lstm_seq_q8_traj(wq, scales, *_t(b, x)), **Q8_TRAJ_TOL)
    # final (c, h) are the plain q8 launch's, and the last trajectory row
    c0, h0 = seq_k.lstm_seq_q8_plain(wq, scales, *_t(b, x))
    assert torch.equal(c, c0) and torch.equal(h, h0)
    assert torch.equal(ct[-1], c) and torch.equal(ht[-1], h)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_q8_grads_match_jax_and_the_ste_oracle(shape):
    """torch.autograd of the port's ``lstm_seq_q8`` (trajectory forward and
    the backward's plain version on the CPU) against jax.grad of the JAX
    package's q8 custom VJP (Pallas interpret, bwd_block_b=2) and of the
    straight-through oracle: dw, db and dx, every one nonzero."""
    w, b, x, dc, dh = _operands(4, *shape)
    ins = [t.requires_grad_() for t in _t(w, b, x)]
    c, h = ops.lstm_seq_q8(*ins)
    assert c.grad_fn is not None
    got = torch.autograd.grad((c, h), ins, tuple(_t(dc, dh)))
    jc, jh = _j(dc, dh)

    def loss(fn):
        def f(w, b, x):
            c, h = fn(w, b, x)
            return jnp.sum(c * jc) + jnp.sum(h * jh)
        return f

    for fn in (lambda w, b, x: jax_seq.lstm_seq_q8(
                   w, b, x, bwd_block_b=2, interpret=True),
               lambda w, b, x: jax_ref.lstm_seq(
                   jax_ref.quantize_dequantize_ste(w), b, x)):
        want = jax.grad(loss(fn), argnums=(0, 1, 2))(*_j(w, b, x))
        _close(got, want, rtol=1e-4, atol=1e-5)
    assert all(float(g.abs().max()) > 0 for g in got)
    assert got[0].dtype == torch.float32


@pytest.mark.parametrize("shape", [SHAPES["odd"], SHAPES["DgtH"]],
                         ids=["odd", "DgtH"])
def test_bwd_plain_with_scales_matches_the_jax_q8_backward(shape):
    w, b, x, dc, dh = _operands(5, *shape)
    wq, scales = ref.quantize_q8(torch.from_numpy(w))
    _, _, ct, ht = seq_k.lstm_seq_q8_traj_plain(wq, scales, *_t(b, x))
    got = bwd_k.lstm_seq_bwd_plain(wq, *_t(b, x), ct, ht, *_t(dc, dh),
                                   scales=scales)
    assert all(g.dtype == torch.float32 for g in got)
    want = jax_bwd.lstm_seq_bwd(
        jnp.asarray(wq.numpy()), *_j(b, x), jnp.asarray(ct.numpy()),
        jnp.asarray(ht.numpy()), *_j(dc, dh), block_b=2, interpret=True,
        scales=jnp.asarray(scales.numpy()))
    _close(got, want, **GRAD_TOL)
    # the wrapper takes its plain version on the CPU, counting nothing
    before = bwd_k.lstm_seq_bwd_q8.launches
    again = bwd_k.lstm_seq_bwd(wq, *_t(b, x), ct, ht, *_t(dc, dh),
                               block_b=2, time_chunk=3, scales=scales)
    assert all(torch.equal(g, r) for g, r in zip(got, again))
    assert bwd_k.lstm_seq_bwd_q8.launches == before


def test_scaling_dg_in_place_would_show_in_dw_and_db():
    """The straight-through dW/db take the UNSCALED gate gradients: the
    plain version's dw differs from the one that scales dg first by the
    per-column scale, while dx is the same — why the tests compare dw and
    db, not only dx."""
    w, b, x, dc, dh = _operands(6, *SHAPES["odd"])
    wq, scales = ref.quantize_q8(torch.from_numpy(w))
    _, _, ct, ht = seq_k.lstm_seq_q8_traj_plain(wq, scales, *_t(b, x))
    dw, db, dx = bwd_k.lstm_seq_bwd_plain(wq, *_t(b, x), ct, ht,
                                          *_t(dc, dh), scales=scales)
    dw_f32, db_f32, dx_f32 = bwd_k.lstm_seq_bwd_plain(
        ref.dequantize_q8(wq, scales), *_t(b, x), ct, ht, *_t(dc, dh))
    torch.testing.assert_close(dx, dx_f32, **GRAD_TOL)
    torch.testing.assert_close(dw, dw_f32, **GRAD_TOL)
    torch.testing.assert_close(db, db_f32, **GRAD_TOL)
    assert not torch.allclose(dw * scales[:, None, :], dw, **GRAD_TOL)


def test_q8_wrappers_reject_what_the_kernel_does_not_take():
    w, b, x, _, _ = _t(*_operands(7, *SHAPES["odd"]))
    wq, scales = ref.quantize_q8(w)
    with pytest.raises(TypeError, match="int8"):
        seq_k.lstm_seq_q8_traj(w, scales, b, x)
    with pytest.raises(TypeError):
        seq_k.lstm_seq_q8_traj(wq, scales.double(), b, x)
    with pytest.raises(ValueError, match="scales"):
        seq_k.lstm_seq_q8_traj(wq, scales[:, 1:], b, x)
    with pytest.raises(TypeError):
        ops.lstm_seq_q8(w.double(), b, x)


def test_quantize_runs_inside_the_autograd_function():
    """If the quantize were recorded outside the Function, autograd would
    differentiate through ``torch.round`` and dw would be all zero."""
    w, b, x, dc, dh = _t(*_operands(8, *SHAPES["L1"]))
    w.requires_grad_()
    c, h = ops.lstm_seq_q8(w, b, x)
    assert type(c.grad_fn).__name__.startswith("_LstmSeqQ8Fn")
    (dw,) = torch.autograd.grad((c, h), (w,), (dc, dh))
    assert int((dw == 0).sum()) < dw.numel() // 4


# ---------------------------------------------------------------------------
# The budget table
# ---------------------------------------------------------------------------
def test_q8_bytes_at_the_paper_width_are_the_kernels_layout():
    """2 x 32 (P = H = 32), one row, whole T = 128: the forward holds the
    codes in registers (as their f32 values), so its shared memory is the x
    ring and h; so does the backward's wavefront (the register home), whose
    shared memory is f32 throughout: the trajectory ring, the parity slots
    (with dg * s for the int8 products) and the closing dW pass's stages.
    The shared home, which 2 x 32 takes from two rows a tile, holds the
    int8 rows, 4H = 128 bytes padded to 144 (16-byte aligned, off a 0/64
    bank offset)."""
    L, P, H, T = 2, 32, 32, 128
    rows, G = L * (P + H), 4 * H
    assert seq_k.row_stride(H, 1) == 144 and seq_k.row_stride(H) == 136
    assert seq_k.weight_home(L, P, H, 1) == "registers"
    fwd = (T * P * 4              # x ring, whole T
           + 2 * L * H * 4)       # h of each layer, two slots
    assert seq_k.working_set_bytes(T, L, P, H, 1, quantized=True) == fwd
    wave = (seq_k.BWD_RING * (2 * L * H + P) * 4     # trajectory ring
            + 2 * L * (G + H + G + H + P) * 4         # parity slots
            + 2 * L * G * 4                           # dg * s, int8 only
            + 2 * (seq_k.BWD_STAGE + 1) * (L * (G + H) + P) * 4)  # dW pass
    assert seq_k.working_set_bytes(T, L, P, H, 1, mode="bwd",
                                   quantized=True) == wave
    assert seq_k.working_set_bytes(T, L, P, H, 1, mode="bwd") == \
        wave - 2 * L * G * 4
    bm = 2                                  # the shared home from 2 rows
    bwd = (rows * 144            # int8 stack
           + L * G * 4 * 2       # f32 bias and scales
           + T * bm * P * 4      # x ring, whole T
           + 2 * L * bm * H * 4  # (dc, dh)
           + bm * G * 4          # gate buffer
           + (rows * 136 + L * G) * 4   # f32 dW/db accumulators
           + 2 * (T + 1) * L * bm * H * 4    # both trajectories, zero row
           + bm * (G * 4 + H * 4)            # dg, the layer-below input grad
           + bm * G * 4)                     # dg * s for the products
    assert seq_k.weight_home(L, P, H, bm) == "shared"
    assert seq_k.working_set_bytes(T, L, P, H, bm, mode="bwd",
                                   quantized=True) == bwd
    ws = seq_k.working_set_bytes(T, L, P, H, bm, mode="bwd")
    assert ws - bwd == rows * (136 * 4 - 144) - L * G * 4 - bm * G * 4


@pytest.mark.parametrize("L,H", [(2, 64), (3, 64), (2, 96)])
def test_q8_fits_widths_where_f32_does_not(L, H):
    """The int8 stack fits one block where the f32 one fits none and is
    split over co-resident blocks."""
    P = max(9, H)
    assert seq_k.choose_batch_block(1, 128, L, P, H).n_blocks > 1
    assert seq_k.choose_batch_block(1, 128, L, P, H, quantized=True) == \
        seq_k.SeqBlocks(1, None)


@pytest.mark.parametrize("mode", ["fwd", "bwd"])
def test_q8_is_never_tiled_finer_than_f32(mode):
    cfg = LSTMConfig()
    P = max(cfg.input_dim, cfg.hidden)
    for B in (1, 64, 1024):
        for T in (32, 128, 512, 1024, 2048):
            f32 = seq_k.choose_batch_block(B, T, cfg.n_layers, P, cfg.hidden,
                                           mode=mode)
            q8 = seq_k.choose_batch_block(B, T, cfg.n_layers, P, cfg.hidden,
                                          mode=mode, quantized=True)
            assert q8 is not None and f32 is not None, (B, T)
            assert q8.block_b >= f32.block_b, (B, T, f32, q8)
            if f32.time_chunk is None:
                assert q8.time_chunk is None, (B, T, f32, q8)
            elif q8.time_chunk is not None:
                assert q8.time_chunk >= f32.time_chunk, (B, T, f32, q8)


def test_q8_backward_fits_no_block_at_2x64():
    """No one block holds the q8 backward at 2 x 64 (its f32 dW alone is
    264 KiB): the table splits it over co-resident blocks."""
    assert seq_k.choose_batch_block(1, 128, 2, 64, 64, mode="bwd",
                                    quantized=True).n_blocks > 1
    assert seq_k.working_set_bytes(128, 2, 64, 64, 1, mode="bwd",
                                   time_chunk=1, quantized=True) > \
        seq_k.factorization.H100_SMEM_PER_BLOCK


def test_q8_streams_coarser_than_f32_at_t300():
    """The training table at the paper's width, T=300: at batch 64 (one row
    a block, the register home's wavefront, whose ring does not grow with
    T) both take whole T; where the batch needs 2- to 16-row tiles (the
    shared home) the int8 stack leaves room for twice the chunk of the f32
    one."""
    for q8 in (False, True):
        assert seq_k.choose_batch_block(64, 300, 2, 32, 32, mode="bwd",
                                        quantized=q8) == \
            seq_k.SeqBlocks(1, None)
    for B, f32, q8 in ((200, (2, 18), (2, 37)), (2000, (16, 2), (16, 4))):
        assert seq_k.choose_batch_block(B, 300, 2, 32, 32, mode="bwd") == \
            seq_k.SeqBlocks(*f32)
        assert seq_k.choose_batch_block(B, 300, 2, 32, 32, mode="bwd",
                                        quantized=True) == seq_k.SeqBlocks(*q8)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
def _plan_inputs(seed, B, **shape):
    jcfg = JaxConfig(**shape)
    jparams = jax_lstm.init_params(jax.random.PRNGKey(seed), jcfg)
    plain, _ = split(jparams)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, jcfg.seq_len, jcfg.input_dim)).astype(np.float32)
    return jcfg, jparams, LSTMConfig(**shape), tparams, x


def test_fused_seq_q8_at_full_width_matches_jax():
    """2 x 32, T=128, B=2: the port's plan against the JAX package's
    (Pallas interpret) at the oracle tolerance, and within the int8 band of
    the sequential plan."""
    jcfg, jparams, cfg, params, x = _plan_inputs(7, 2)
    got = lstm.forward_fused_seq_q8(params, torch.from_numpy(x), cfg)
    want = jax_lstm.forward_fused_seq_q8(jparams, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Q8_ORACLE_TOL)
    seq = lstm.forward_sequential(params, torch.from_numpy(x), cfg)
    torch.testing.assert_close(got, seq, **plans.Q8_BAND)


def test_fused_seq_q8_matches_the_dequantize_oracle_logits():
    _, _, cfg, params, x = _plan_inputs(9, 3, hidden=16, seq_len=9)
    xt = torch.from_numpy(x)
    got = lstm.forward_fused_seq_q8(params, xt, cfg)
    w, b, P = seq_k.stack_params(params["layers"], cfg.hidden)
    _, h = ref.lstm_seq_q8(*ref.quantize_q8(w), b, seq_k.pad_input(xt, P))
    want = h[-1] @ params["head"]["w"] + params["head"]["b"]
    torch.testing.assert_close(got, want, **Q8_ORACLE_TOL)


def test_q8_plan_grads_are_the_ste_reference():
    """The plan's gradients equal those of the sequential oracle over
    ``quantize_dequantize_ste`` weights of the same stacked layout, and
    the JAX package's plan gradients."""
    jcfg, jparams, cfg, params, x = _plan_inputs(
        11, 3, hidden=16, n_layers=2, seq_len=7)
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    xt = torch.from_numpy(x)
    labels = torch.tensor([0, 3, 5])

    def ste_forward(p, x, cfg):
        w, b, P = seq_k.stack_params(p["layers"], cfg.hidden)
        _, h = ref.lstm_seq(ref.quantize_dequantize_ste(w), b,
                            seq_k.pad_input(x, P))
        return h[-1] @ p["head"]["w"] + p["head"]["b"]

    got = torch.autograd.grad(lstm.loss_fn(
        params, xt, labels, cfg, forward=lstm.forward_fused_seq_q8),
        tree_leaves(params))
    want = torch.autograd.grad(lstm.loss_fn(
        params, xt, labels, cfg, forward=ste_forward), tree_leaves(params))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
        assert float(g.abs().max()) > 0
    jgrads = jax.grad(jax_lstm.loss_fn)(
        jparams, jnp.asarray(x), jnp.asarray(labels.numpy()), jcfg,
        forward=jax_lstm.forward_fused_seq_q8)
    flat = iter(got)
    tree = convert.params_to_numpy(tree_map(lambda _: next(flat), params))
    for g, r in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 split(jgrads)[0]))):
        np.testing.assert_allclose(g, r, **GRAD_TOL)


def test_q8_plan_serves_2x64_in_one_sequence_call():
    """2 x 64, B=1: ``fused_seq`` runs on the split home (its event names
    it); ``fused_seq_q8`` runs the q8 sequence path with its one-block
    tiling."""
    cfg = LSTMConfig().with_complexity(64, 2)
    params = lstm.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 5, 9, generator=torch.Generator().manual_seed(1))
    out, events = _events(lambda: lstm.forward_fused_seq(params, x, cfg))
    assert "fallback" not in events[0]
    assert events[0]["weight_home"] == "split"
    out_q8, events = _events(lambda: lstm.forward_fused_seq_q8(params, x,
                                                               cfg))
    assert len(events) == 1 and "fallback" not in events[0]
    assert events[0]["plan"] == "fused_seq_q8" and events[0]["block_b"] == 1
    assert events[0]["weight_home"] == "shared"
    torch.testing.assert_close(out_q8, out, **plans.Q8_BAND)


def test_q8_training_at_2x64_routes_to_fused_cell():
    """A q8 training step at 2 x 64: its f32 dW accumulators fit no block,
    so the table splits the step over co-resident blocks (one trajectory
    launch, one backward launch) and its gradients are the straight-through
    ones of ``ref.lstm_seq`` over the dequantized stack.  At 2 x 1024 no
    split fits the card: the plan trains on ``fused_cell`` (f32 weights, as
    the JAX package's route does) with a ``plan="fused_seq_q8",
    fallback="fused_cell"`` event naming ``train``."""
    x = torch.randn(2, 4, 9, generator=torch.Generator().manual_seed(3))
    y = torch.tensor([1, 4])

    def q8_oracle(p, v, c):
        w, b, P = seq_k.stack_params(p["layers"], c.hidden)
        _, h = ref.lstm_seq(ref.quantize_dequantize_ste(w), b,
                            seq_k.pad_input(v, P))
        return h[-1] @ p["head"]["w"] + p["head"]["b"]

    for hidden, routed in ((64, False), (1024, True)):
        cfg = LSTMConfig().with_complexity(hidden, 2)
        params = lstm.init_params(torch.Generator().manual_seed(2), cfg)
        for leaf in tree_leaves(params):
            leaf.requires_grad_()
        loss, events = _events(lambda: lstm.loss_fn(
            params, x, y, cfg, forward=lstm.forward_fused_seq_q8))
        if routed:
            assert events == [dict(family="lstm", plan="fused_seq_q8",
                                   fallback="fused_cell", train=True,
                                   batch=2, seq_len=4)]
        else:
            assert len(events) == 1 and "fallback" not in events[0]
            assert events[0]["train"] and events[0]["bwd_n_blocks"] > 1
            assert events[0]["weight_home"] == "split"
        got = torch.autograd.grad(loss, tree_leaves(params))
        want = torch.autograd.grad(lstm.loss_fn(
            params, x, y, cfg, forward=lstm.forward_fused_kernel if routed
            else q8_oracle), tree_leaves(params))
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, **GRAD_TOL)


def test_cpu_oracle_backward_names_itself():
    """A bare ``lstm_seq_q8`` under autograd at 17 x 16 on CPU tensors: no
    q8 backward tiling fits (every block of any split needs 17 warps), so
    it is autograd of ``ref.lstm_seq`` over the straight-through weights,
    named by a ``plan/dispatch`` event."""
    w, b, x, dc, dh = _t(*_operands(12, 17, 16, 9, 3, 5))
    ins = [t.clone().requires_grad_() for t in (w, b, x)]
    (c, h), events = _events(lambda: ops.lstm_seq_q8(*ins))
    assert events == [dict(family="lstm", plan="lstm_seq_q8",
                           fallback="oracle_bwd", bwd_block_b=0, batch=3,
                           seq_len=5)]
    got = torch.autograd.grad((c, h), ins, (dc, dh))
    ste = [t.clone().requires_grad_() for t in (w, b, x)]
    want = torch.autograd.grad(
        ref.lstm_seq(ref.quantize_dequantize_ste(ste[0]), ste[1], ste[2]),
        ste, (dc, dh))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r)


def test_q8_no_grad_is_one_plain_forward():
    w, b, x, _, _ = _t(*_operands(13, *SHAPES["odd"]))
    w.requires_grad_()
    with torch.no_grad():
        c, h = ops.lstm_seq_q8(w, b, x)
    assert c.grad_fn is None and not h.requires_grad
    wq, scales = ref.quantize_q8(w.detach())
    c0, h0 = seq_k.lstm_seq_q8_plain(wq, scales, b, x)
    assert torch.equal(c, c0) and torch.equal(h, h0)
