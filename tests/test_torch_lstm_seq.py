"""The port's sequence-resident LSTM (host half, budget table, and the
wrapper's plain version on the CPU) against the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import tiling as jax_tiling  # noqa: E402
from repro.kernels import lstm_seq as jax_seq  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402

from repro_torch.core import factorization, tiling  # noqa: E402
from repro_torch.kernels import lstm_seq as seq_k  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: the JAX package's f32 LSTM tolerance (core/plans.LSTM_TOL)
TOL = dict(rtol=2e-5, atol=2e-5)


def _layers(seed, n_layers, hidden, input_dim):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_layers):
        d = input_dim if i == 0 else hidden
        out.append({
            "w": (rng.standard_normal((d + hidden, 4 * hidden))
                  * (d + hidden) ** -0.5).astype(np.float32),
            "b": (rng.standard_normal(4 * hidden) * 0.1).astype(np.float32)})
    return out


def _stacked(seed, L, H, D, B, T):
    """Stacked params and padded input from both packages' stack_params."""
    layers = _layers(seed, L, H, D)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, T, D)).astype(np.float32)
    tw, tb, p = seq_k.stack_params(
        [{k: torch.from_numpy(v) for k, v in layer.items()}
         for layer in layers], H)
    jw, jb, jp = jax_seq.stack_params(
        [{k: jnp.asarray(v) for k, v in layer.items()} for layer in layers],
        H)
    assert p == jp
    return (tw, tb, seq_k.pad_input(torch.from_numpy(x), p),
            jw, jb, jax_seq.pad_input(jnp.asarray(x), jp))


@pytest.mark.parametrize("dims", [(2, 8, 9), (2, 16, 9), (1, 16, 16),
                                  (3, 16, 40)],
                         ids=["PgtH", "PeqH", "noPad", "DgtH"])
def test_stack_params_and_pad_input_equal_jax(dims):
    L, H, D = dims
    tw, tb, tx, jw, jb, jx = _stacked(0, L, H, D, 3, 4)
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("tiles", [(2, None), (2, 5), (8, None)],
                         ids=["ragged", "ragged-streamed", "whole"])
def test_lstm_seq_matches_pallas_interpret(tiles):
    """P > H (hidden 8, input 9) and a batch of 5, through the Pallas
    kernels in interpret mode — whole-T and time-streamed — against the
    port's wrapper, which takes its plain version for CPU tensors."""
    block_b, tc = tiles
    tw, tb, tx, jw, jb, jx = _stacked(1, 2, 8, 9, 5, 12)
    got = ops.lstm_seq(tw, tb, tx, block_b=block_b, time_chunk=tc)
    want = jax_seq.lstm_seq(jw, jb, jx, block_b=block_b, time_chunk=tc,
                            interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dims", [(2, 32, 9, 4, 16), (3, 8, 9, 3, 7)],
                         ids=["paper", "PgtH"])
def test_ref_lstm_seq_matches_jax_ref(dims):
    tw, tb, tx, jw, jb, jx = _stacked(2, *dims)
    for g, w in zip(ref.lstm_seq(tw, tb, tx), jax_ref.lstm_seq(jw, jb, jx)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_time_chunk_never_changes_the_result():
    tw, tb, tx, *_ = _stacked(3, 2, 16, 9, 5, 11)
    outs = [ops.lstm_seq(tw, tb, tx, block_b=2, time_chunk=tc)
            for tc in (None, 1, 11, 4)]
    for c, h in outs[1:]:
        assert torch.equal(c, outs[0][0]) and torch.equal(h, outs[0][1])


@pytest.mark.parametrize("case", [
    # (L, H, B, T, expected): the paper's 2 x 32 holds whole T in one-row
    # blocks up to 132 rows, streams 512-step chunks at T=2048, and streams
    # 32-step chunks once a batch of 2000 needs 16-row blocks; the f32 stack
    # of 2 x 64 (256 KiB) or 3 x 256 (6 MiB) alone exceeds a thread block
    (2, 32, 1, 128, seq_k.SeqBlocks(1, None)),
    (2, 32, 64, 128, seq_k.SeqBlocks(1, None)),
    (2, 32, 1, 2048, seq_k.SeqBlocks(1, 512)),
    (2, 32, 2000, 128, seq_k.SeqBlocks(16, 32)),
    (2, 64, 1, 128, None),
    (3, 256, 1, 128, None),
], ids=["2x32-B1", "2x32-B64", "2x32-T2048", "2x32-B2000", "2x64", "3x256"])
def test_choose_batch_block_on_the_hopper_budget(case):
    L, H, B, T, expected = case
    got = seq_k.choose_batch_block(B, T, L, max(9, H), H)
    assert got == expected
    if got is not None:
        assert seq_k.working_set_bytes(
            T, L, H, H, got.block_b, time_chunk=got.time_chunk) \
            <= factorization.H100_SMEM_PER_BLOCK
        assert isinstance(got, tiling.TilePlan)


@pytest.mark.parametrize("batch_and_tile", [(1, 1), (64, 1), (132, 1),
                                            (133, 2), (300, 4), (5000, 16)])
def test_batch_tile_spreads_the_batch_over_the_sms(batch_and_tile):
    B, tile = batch_and_tile
    assert seq_k.choose_batch_block(B, 8, 1, 16, 16).block_b == tile


@pytest.mark.parametrize("bm", [1, 4, 16])
def test_working_set_terms(bm):
    """The forward's exact shared memory: at one row a block the 2 x 32
    stack is in registers, past it in padded shared rows; h of every layer
    in two slots and the x ring either way (bias, scales, c and the gates
    are in registers)."""
    L, P, H, T, tc = 2, 32, 32, 128, 32
    whole = seq_k.working_set_bytes(T, L, P, H, bm)
    streamed = seq_k.working_set_bytes(T, L, P, H, bm, time_chunk=tc)
    assert seq_k.weight_home(L, P, H, bm) == \
        ("registers" if bm == 1 else "shared")
    fixed = ((0 if bm == 1 else L * (P + H) * (4 * H + 8) * 4)  # weights
             + 2 * L * bm * H * 4)                        # h, two slots
    assert whole == fixed + T * bm * P * 4
    assert streamed == fixed + 2 * tc * bm * P * 4


@pytest.mark.parametrize("case", [
    # (L, H, quantized, home, threads, bytes at B=1, T=128 whole): the
    # paper's width keeps its weights in registers, f32 and int8; the int8
    # widths that only fit as codes keep them in padded shared rows
    (2, 32, False, "registers", 256, 128 * 32 * 4 + 2 * 2 * 32 * 4),
    (2, 32, True, "registers", 256, 128 * 32 * 4 + 2 * 2 * 32 * 4),
    (2, 64, True, "shared", 512,
     2 * 128 * 272 + 128 * 64 * 4 + 2 * 2 * 64 * 4),
    (3, 64, True, "shared", 768,
     3 * 128 * 272 + 128 * 64 * 4 + 2 * 3 * 64 * 4),
    (2, 96, True, "shared", 768,
     2 * 192 * 400 + 128 * 96 * 4 + 2 * 2 * 96 * 4),
], ids=["2x32", "2x32-q8", "2x64-q8", "3x64-q8", "2x96-q8"])
def test_forward_table_bytes_and_weight_home(case):
    L, H, q8, home, threads, nbytes = case
    P = max(9, H)
    assert seq_k.weight_home(L, P, H, 1) == home
    assert seq_k.fwd_threads(L, H) == threads
    assert seq_k.working_set_bytes(128, L, P, H, 1, quantized=q8) == nbytes
    assert seq_k.choose_batch_block(1, 128, L, P, H, quantized=q8) == \
        seq_k.SeqBlocks(1, None)


@pytest.mark.parametrize("shape", [(1, 32, 1), (2, 32, 1), (2, 32, 2),
                                   (3, 32, 1), (2, 16, 1), (2, 32, 1, 40)],
                         ids=["L1", "L2", "tile2", "L3", "H16", "P40"])
def test_weight_home_is_registers_only_at_the_paper_width(shape):
    """Registers hold each lane's 64 weights only where H = P = 32, at most
    2 layers, one row a block; everything else keeps its weights in shared
    memory."""
    L, H, bm, *p = shape
    P = p[0] if p else H
    want = "registers" if (H, P, bm) == (32, 32, 1) and L <= 2 else "shared"
    assert seq_k.weight_home(L, P, H, bm) == want
    assert seq_k.fwd_threads(L, H) <= seq_k.fwd_max_threads(bm, want)


@pytest.mark.parametrize("shape", [(9, 32, False), (5, 64, True),
                                   (17, 16, False)],
                         ids=["9x32", "5x64-q8", "17x16"])
def test_a_wavefront_past_1024_threads_fits_no_block(shape):
    """Every layer needs its own warps at once: L x ceil(H / 8) warps past
    32 fit no thread block, whatever the bytes, so the table finds nothing
    (core/lstm routes to fused_cell), for training too."""
    L, H, q8 = shape
    assert seq_k.fwd_threads(L, H) > seq_k.MAX_THREADS
    for mode in ("fwd", "bwd"):
        assert seq_k.choose_batch_block(1, 8, L, H, H, mode=mode,
                                        quantized=q8) is None


def test_budget_functions_are_memoised():
    """The wrapper's per-call host work: the tile search, the bytes and
    the weight home are looked up, not recomputed, on a repeated shape."""
    args = (64, 128, 2, 32, 32)
    first = seq_k.choose_batch_block(*args, mode="bwd")
    hits = seq_k.choose_batch_block.cache_info().hits
    assert seq_k.choose_batch_block(*args, mode="bwd") is first
    assert seq_k.choose_batch_block.cache_info().hits == hits + 1
    for fn, fn_args in ((seq_k.working_set_bytes, (128, 2, 32, 32, 1)),
                        (seq_k.gate_parts, (32,)),
                        (seq_k.weight_home, (2, 32, 32, 1)),
                        (seq_k.fwd_threads, (2, 32))):
        want = fn(*fn_args)
        hits = fn.cache_info().hits
        assert fn(*fn_args) == want
        assert fn.cache_info().hits == hits + 1


@pytest.mark.parametrize("hidden_parts", [(5, 4), (32, 4), (64, 4), (128, 2),
                                          (256, 1), (300, 0)])
def test_gate_parts_fill_a_thread_block(hidden_parts):
    H, parts = hidden_parts
    assert seq_k.gate_parts(H) == parts
    assert parts * 4 * H <= seq_k.MAX_THREADS


def test_lstm_seq_raises_when_no_tile_fits():
    tw, tb, tx, *_ = _stacked(4, 2, 64, 9, 1, 3)
    with pytest.raises(ValueError, match="per-cell"):
        ops.lstm_seq(tw, tb, tx)


def test_seq_wrapper_rejects_what_the_kernel_does_not_take():
    tw, tb, tx, *_ = _stacked(5, 2, 8, 9, 2, 3)
    with pytest.raises(TypeError):
        seq_k.lstm_seq(tw, tb, tx.double())
    with pytest.raises(ValueError):
        seq_k.lstm_seq(tw, tb, tx[..., 1:])
    with pytest.raises(ValueError, match="block_b"):
        seq_k.lstm_seq(tw, tb, tx, block_b=3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        seq_k.lstm_seq(tw.to("meta"), tb.to("meta"), tx.to("meta"))
    before = seq_k.lstm_seq.launches
    seq_k.lstm_seq(tw, tb, tx)
    assert seq_k.lstm_seq.launches == before      # CPU calls are not counted


@pytest.mark.parametrize("args", [(8, 128), (5, 7), (1, 1), (64, 100)])
def test_joint_search_matches_jax(args):
    """The copied search walks the same surface in the same order."""
    batch, seq_len = args

    def fits(bm, tc):
        return bm * (seq_len if tc is None else 2 * tc) <= 40

    for seed in (None, 4):
        assert tiling.joint_search(batch, seq_len, fits,
                                   seed_batch_tile=seed) == \
            jax_tiling.joint_search(batch, seq_len, fits,
                                    seed_batch_tile=seed)
    assert list(tiling.halving(seq_len)) == list(jax_tiling.halving(seq_len))
    assert tiling.streamed_rows(seq_len, 3) == \
        jax_tiling.streamed_rows(seq_len, 3)
