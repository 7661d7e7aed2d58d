"""The split weight home of the sequence-resident LSTM kernels (K2, K2t, K3
and their int8 instances) on the CPU, against the JAX package.

Where one H100 thread block cannot hold the (L, P+H, 4H) stack, the port's
budget table (``kernels/lstm_seq.choose_batch_block``) splits its gate
columns over G co-resident blocks of one launch, so that the paper's Fig 5
sweep (hidden 32 to 256 x 1 to 3 layers) runs ``fused_seq`` and
``fused_seq_q8`` in one launch a forward and two a training step, as the
JAX package does against its VMEM budget.  Held here: ``plan_viability``
equal to JAX's at every Fig 5 config, batch, mode and dtype; the split
table's own rules (bytes a block, the fewest G, co-residency, the
one-block answers unchanged); ``fused_seq`` at 2 x 64, 3 x 128 and 3 x 256
against JAX's ``forward_fused_seq`` (Pallas in interpret mode) and its
gradients; and the launch counts.  The split kernels themselves run under
the g++ mock (``tests/test_torch_kernels_mock.py``) and on the card
(``chip_smoke.py``'s F2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mobirnn_lstm import LSTMConfig as JaxConfig  # noqa: E402
from repro.core import lstm as jax_lstm  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs.mobirnn_lstm import LSTMConfig  # noqa: E402
from repro_torch.core import factorization, lstm, plans, tiling  # noqa: E402
from repro_torch.kernels import lstm_seq as seq_k  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402

#: the paper's Fig 5 sweep (MobiRNN's configs/mobirnn_lstm.py)
FIG5 = [(h, n) for h in (32, 64, 128, 256) for n in (1, 2, 3)]
#: the JAX package's f32 LSTM tolerances (core/plans.LSTM_TOL and
#: LSTM_GRAD_TOL)
TOL = plans.LSTM_TOL["float32"]
GRAD_TOL = plans.LSTM_GRAD_TOL["float32"]
DTYPES = {"f32": dict(dtype_bytes=4), "bf16": dict(dtype_bytes=2,
                                                    w_dtype_bytes=2)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("hidden,n_layers", FIG5,
                         ids=[f"{n}x{h}" for h, n in FIG5])
def test_plan_viability_matches_jax_at_fig5(hidden, n_layers, batch, train,
                                            dtype):
    """``fused_seq`` and ``fused_seq_q8`` are viable where the JAX
    package's are: at every Fig 5 config, serving and training, f32 and
    bf16, B = 1 and 64, at the paper's T = 128."""
    kw = dict(train=train, **DTYPES[dtype])
    port = lstm.plan_viability(
        LSTMConfig().with_complexity(hidden, n_layers), batch, 128, **kw)
    want = jax_lstm.plan_viability(
        JaxConfig().with_complexity(hidden, n_layers), batch, 128, **kw)
    for plan in ("fused_seq", "fused_seq_q8"):
        assert port(plan) == want(plan), plan
    assert port("fused_seq") and port("fused_seq_q8")


def _one_block(batch, T, L, P, H, mode, **kw):
    """The tiling the one-block homes give, the table's search before the
    split home: None where no block holds the stack."""
    budget = factorization.H100_SMEM_PER_BLOCK
    threads = seq_k.fwd_threads(L, H)
    modes = ("fwd",) if mode == "fwd" else ("fwd", "bwd")

    def fits(bm, tc):
        home = seq_k.weight_home(L, P, H, bm)
        return threads <= seq_k.fwd_max_threads(bm, home) and all(
            seq_k.working_set_bytes(T, L, P, H, bm, mode=m, time_chunk=tc,
                                    **kw) <= budget for m in modes)

    need = -(-batch // factorization.H100_SMS)
    seed = next((r for r in seq_k.TILE_ROWS if r >= need),
                seq_k.TILE_ROWS[-1])
    found = tiling.joint_search(batch, T, fits, seed_batch_tile=seed)
    return None if found is None else seq_k.SeqBlocks(*found)


def _block_bytes(T, L, P, H, got, mode, **kw):
    modes = ("fwd",) if mode == "fwd" else ("fwd", "bwd")
    return max(seq_k.working_set_bytes(T, L, P, H, got.block_b, mode=m,
                                       time_chunk=got.time_chunk,
                                       n_blocks=got.n_blocks, **kw)
               for m in modes)


def _resident(T, L, P, H, got, mode, **kw):
    """Split blocks the card holds at once for every launch of ``mode``:
    132 SMs x the fewer of the blocks an SM's 227 KiB of shared memory
    hold and those its 65,536 registers hold at 128 a thread (the
    kernels' ``__launch_bounds__(512, 1)``)."""
    modes = ("fwd",) if mode == "fwd" else ("fwd", "bwd")
    cap = []
    for m in modes:
        smem = seq_k.working_set_bytes(T, L, P, H, got.block_b, mode=m,
                                       n_blocks=got.n_blocks, **kw)
        threads = seq_k.split_threads(L, H, got.n_blocks, mode=m,
                                      block_b=got.block_b)
        by_smem = 233_472 // (smem + 1024)
        by_regs = 65_536 // (-(-threads // 32) * 32 * 128)
        cap.append(132 * min(by_smem, by_regs))
    return min(cap)


@pytest.mark.parametrize("mode", ["fwd", "bwd"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "q8"])
def test_split_table_rules(mode, kind):
    """Wherever a one-block home holds the stack the table's answer is the
    one-block answer; elsewhere the split home's: every block within a
    thread block's shared memory and its instance's threads, G the fewest
    that fits at any tile, and G x tiles blocks within what the card holds
    at once (132 SMs x blocks an SM at the block's shared memory and
    registers)."""
    kw = {"f32": {}, "bf16": DTYPES["bf16"], "q8": dict(quantized=True)}[kind]
    split_seen = 0
    for H, L in FIG5 + [(48, 2), (96, 2), (8, 2), (1024, 3)]:
        P = max(9, H)
        for B in (1, 3, 37, 64, 1000):
            for T in (1, 50, 128):
                got = seq_k.choose_batch_block(B, T, L, P, H, mode=mode,
                                               **kw)
                old = _one_block(B, T, L, P, H, mode, **kw)
                if old is not None:
                    assert got == old and got.n_blocks == 1
                    continue
                if got is None:
                    continue
                split_seen += 1
                G, bm = got.n_blocks, got.block_b
                assert G > 1 and H % G == 0 and got.time_chunk is None
                assert bm in seq_k.SPLIT_TILE_ROWS
                assert seq_k.weight_home(L, P, H, bm, G) == "split"
                smem = _block_bytes(T, L, P, H, got, mode, **kw)
                assert smem <= factorization.H100_SMEM_PER_BLOCK
                assert seq_k.split_threads(L, H, G, block_b=bm) <= \
                    seq_k.SPLIT_MAX_THREADS
                assert G * -(-B // bm) <= _resident(T, L, P, H, got, mode,
                                                    **kw)
                for g in range(2, G):
                    if H % g:
                        continue
                    for rows in seq_k.SPLIT_TILE_ROWS:
                        fewer = seq_k.SeqBlocks(rows, None, g)
                        s = _block_bytes(T, L, P, H, fewer, mode, **kw)
                        assert s > factorization.H100_SMEM_PER_BLOCK or \
                            g * -(-B // rows) > _resident(
                                T, L, P, H, fewer, mode, **kw) or \
                            seq_k.split_threads(L, H, g) > \
                            seq_k.SPLIT_MAX_THREADS, (H, L, B, T, g, rows)
    assert split_seen > 20
    # a backward block (512 threads at up to 128 registers) is one an SM
    # whatever its shared memory: 1 x 128 f32 (bf16) training at B = 600
    # would need 16 blocks x 19 tiles of 32 rows, above the card's 132, and
    # routes to the per-cell kernel (one block holds the int8 stack)
    wide = seq_k.choose_batch_block(600, 128, 1, 128, 128, mode="bwd", **kw)
    assert (wide is None) == (kind != "q8")
    # 3 x 1024 f32 training splits into no set of blocks the card holds
    assert seq_k.choose_batch_block(64, 128, 3, 1024, 1024, mode="bwd") \
        is None


def test_split_working_set_terms():
    """One split block, term by term: the forward's column slice (rows in
    groups of 4, no pad), the staged h of every layer and x of one step,
    c of its units; the backward's padded slice, f32 dW and db, bias (and
    scales), activations and gate gradients (and dg * s) and dc."""
    L, P, H, G, bm = 3, 256, 256, 32, 16
    U = H // G
    assert seq_k.working_set_bytes(128, L, P, H, bm, n_blocks=G) == \
        L * 512 * 4 * U * 4 + (L * bm * H + bm * P) * 4 + L * bm * U * 4
    assert seq_k.working_set_bytes(128, L, P, H, 1, n_blocks=G,
                                   quantized=True) == \
        L * 512 * 4 * U + (L * H + P) * 4 + L * U * 4
    assert seq_k.working_set_bytes(128, L, P, H, bm, mode="bwd",
                                   n_blocks=G) == \
        L * 512 * (4 * U * 4 + 4) + L * 513 * 4 * U * 4 \
        + L * 4 * U * 4 + 2 * L * bm * 4 * U * 4 + L * bm * U * 4
    assert seq_k.working_set_bytes(128, L, P, H, 1, mode="bwd", n_blocks=G,
                                   quantized=True) == \
        L * 512 * (4 * U + 4) + L * 513 * 4 * U * 4 \
        + 2 * L * 4 * U * 4 + 3 * L * 4 * U * 4 + L * U * 4
    # a row tile pads to 4 rows in every (rows, ...) term
    assert seq_k.working_set_bytes(128, L, P, H, 2, n_blocks=G) == \
        seq_k.working_set_bytes(128, L, P, H, 4, n_blocks=G)


def _both(seed, hidden, n_layers, T):
    jcfg = JaxConfig(hidden=hidden, n_layers=n_layers, seq_len=T)
    jparams = jax_lstm.init_params(jax.random.PRNGKey(seed), jcfg)
    plain, _ = split(jparams)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    return jcfg, jparams, LSTMConfig(hidden=hidden, n_layers=n_layers,
                                     seq_len=T), params


def _leaves(params):
    out = []
    for layer in params["layers"]:
        out += [layer["w"], layer["b"]]
    return out + [params["head"]["w"], params["head"]["b"]]


def _dispatch(fn):
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        out = fn()
    finally:
        trace_lib.set_tracer(old)
    return out, [r["attrs"] for r in sink.records
                 if r["name"] == "plan/dispatch"]


@pytest.mark.parametrize("hidden,n_layers", [(64, 2), (128, 3), (256, 3)],
                         ids=["2x64", "3x128", "3x256"])
def test_fused_seq_on_the_split_home_matches_jax(hidden, n_layers):
    """``fused_seq`` at a width whose stack no block holds (T=8, B=2): its
    logits against JAX's ``forward_fused_seq`` (Pallas, interpret mode) at
    ``LSTM_TOL``, its gradients against JAX's at ``LSTM_GRAD_TOL``, from
    JAX's weights; one ``lstm_seq`` call a forward and one
    ``lstm_seq_traj`` plus one ``lstm_seq_bwd`` a training step, no
    ``lstm_cell`` call, and events that name the split home and no
    fallback."""
    jcfg, jparams, cfg, params = _both(3, hidden, n_layers, 8)
    x = np.random.default_rng(4).standard_normal((2, 8, 9)).astype(
        np.float32)
    y = np.asarray([1, 4])
    jx = jnp.asarray(x)

    def jfwd(p, v, c):
        return jax_lstm.forward_fused_seq(p, v, c, interpret=True)

    want = np.asarray(jfwd(jparams, jx, jcfg))
    jgrads = split(jax.grad(lambda p: jax_lstm.loss_fn(
        p, jx, jnp.asarray(y), jcfg, forward=jfwd))(jparams))[0]

    tx = torch.from_numpy(x)
    before = dict(kernels.CALLS)
    got, served = _dispatch(lambda: lstm.forward_fused_seq(params, tx, cfg))
    fwd_calls = {k: v - before.get(k, 0) for k, v in kernels.CALLS.items()
                 if v != before.get(k, 0)}
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    leaves = [t.requires_grad_() for t in _leaves(params)]
    before = dict(kernels.CALLS)
    grads, trained = _dispatch(lambda: torch.autograd.grad(
        lstm.loss_fn(params, tx, torch.from_numpy(y), cfg,
                     forward=lstm.forward_fused_seq), leaves))
    step_calls = {k: v - before.get(k, 0) for k, v in kernels.CALLS.items()
                  if v != before.get(k, 0)}
    for g, r in zip(grads, _leaves(convert.params_from_numpy(
            jax.tree.map(np.asarray, jgrads)))):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **GRAD_TOL)

    assert fwd_calls == {"lstm_seq": 1}
    assert step_calls == {"lstm_seq_traj": 1, "lstm_seq_bwd": 1}
    for events, train in ((served, False), (trained, True)):
        assert len(events) == 1
        ev = events[0]
        assert "fallback" not in ev and ev["train"] is train
        assert ev["weight_home"] == "split" and ev["n_blocks"] > 1
        if train:
            assert ev["bwd_n_blocks"] == ev["n_blocks"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_plan_on_the_split_home_counts_its_calls(dtype):
    """``fused_seq_q8`` at 3 x 256 (T=6, B=3), whose int8 stack no block
    holds either: finite logits, in f32 within ``Q8_BAND`` of
    ``sequential``; one
    ``lstm_seq_q8`` call a forward, one ``lstm_seq_q8_traj`` plus one
    ``lstm_seq_bwd_q8`` a training step, its events on the split home."""
    cfg = LSTMConfig(hidden=256, n_layers=3, seq_len=6, dtype=dtype)
    params = lstm.init_params(torch.Generator().manual_seed(5), cfg)
    x = torch.randn(3, 6, 9, generator=torch.Generator().manual_seed(6)).to(
        getattr(torch, dtype))
    before = dict(kernels.CALLS)
    got, served = _dispatch(lambda: lstm.forward_fused_seq_q8(params, x,
                                                              cfg))
    assert {k: v - before.get(k, 0) for k, v in kernels.CALLS.items()
            if v != before.get(k, 0)} == {"lstm_seq_q8": 1}
    assert got.shape == (3, cfg.n_classes) and got.dtype == x.dtype
    assert bool(torch.isfinite(got).all())
    if dtype == "float32":
        torch.testing.assert_close(
            got, lstm.forward_sequential(params, x, cfg),
            **plans.get_family("lstm").tol("fused_seq_q8", dtype))
    leaves = [t.requires_grad_() for t in _leaves(params)]
    before = dict(kernels.CALLS)
    _, trained = _dispatch(lambda: torch.autograd.grad(
        lstm.loss_fn(params, x, torch.tensor([0, 2, 5]), cfg,
                     forward=lstm.forward_fused_seq_q8), leaves))
    assert {k: v - before.get(k, 0) for k, v in kernels.CALLS.items()
            if v != before.get(k, 0)} == {"lstm_seq_q8_traj": 1,
                                          "lstm_seq_bwd_q8": 1}
    for ev in served + trained:
        assert "fallback" not in ev and ev["weight_home"] == "split"
