"""The port's blocked causal prefill attention (K8, ``kernels/
flash_prefill.py``) on the CPU: its plain version (what ``ops.flash_prefill``
runs for CPU tensors, and what the kernel is held to on the card) against
the JAX package's Pallas kernel in interpret mode and against both
packages' naive oracles, on the JAX package's own sweep cases
(tests/test_flash_prefill.py) plus the port's head widths; and K8's budget
table.  The kernel itself runs on the card only (chip_smoke.py, phase
A1)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import factorization  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: tests/test_flash_prefill.py's tolerance for the kernel against the oracle
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(B, S, Hq, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh))]


def _torch(*arrays):
    return [convert.params_from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,qb,kb,w", [
    # tests/test_flash_prefill.py::test_flash_prefill_sweep
    (2, 64, 4, 2, 32, 16, 16, 0),
    (1, 128, 8, 8, 16, 32, 64, 0),
    (2, 96, 4, 1, 32, 32, 32, 24),
    (1, 60, 2, 2, 16, 16, 16, 0),      # partial blocks
    (1, 60, 2, 2, 16, 16, 16, 20),     # partial blocks + window
    # the port's head widths: Qwen2 and Yi (64, 128), StableLM (160)
    (1, 70, 7, 1, 64, 32, 32, 0),
    (1, 70, 4, 2, 128, 32, 16, 0),
    (1, 50, 2, 1, 160, 16, 16, 0),
    (1, 70, 4, 2, 64, 64, 64, 16),
])
def test_plain_matches_jax_pallas_and_the_oracles(B, S, Hq, Hkv, dh, qb, kb,
                                                  w):
    q, k, v = _inputs(B, S, Hq, Hkv, dh, seed=S + Hq + w)
    want = np.asarray(jax_ops.flash_prefill(*_jax(q, k, v), window=w,
                                            q_block=qb, k_block=kb))
    got = ops.flash_prefill(*_torch(q, k, v), window=w, q_block=qb,
                            k_block=kb)
    assert got.shape == (B, S, Hq, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    oracle = ref.prefill_attn(*_torch(q, k, v), window=w)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(
        jax_ref.prefill_attn(*_jax(q, k, v), window=w)), **TOL)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)
    assert fp.flash_prefill.launches == 0      # CPU calls are not counted


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_dtypes_match_jax_pallas(dtype, tol):
    """tests/test_flash_prefill.py::test_flash_prefill_dtypes: the same
    values in both packages (bf16 carried bit for bit), the output in the
    input dtype, at JAX's tolerance for the dtype."""
    q, k, v = (jnp.asarray(a).astype(dtype)
               for a in _inputs(1, 64, 4, 2, 32, seed=0))
    want = np.asarray(jax_ops.flash_prefill(q, k, v, q_block=32,
                                            k_block=32), np.float32)
    got = ops.flash_prefill(*_torch(*(np.asarray(t) for t in (q, k, v))),
                            q_block=32, k_block=32)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_blocks_never_change_results():
    """tests/test_flash_prefill.py::test_block_size_never_changes_results,
    and a ragged S at every tiling."""
    for S in (64, 57):
        q, k, v = _torch(*_inputs(1, S, 2, 2, 16, seed=1))
        outs = [fp.flash_prefill(q, k, v, q_block=qb, k_block=kb)
                for qb, kb in [(16, 16), (64, 64), (32, 16), (16, 64)]]
        for o in outs[1:]:
            torch.testing.assert_close(outs[0], o, **TOL)


def test_plain_matches_the_model_attention():
    """tests/test_flash_prefill.py::test_flash_prefill_matches_model_
    attention: K8's function is the model's blocked attention."""
    from repro_torch.models.attention import flash_attention
    q, k, v = _torch(*_inputs(2, 96, 4, 2, 16, seed=7))
    torch.testing.assert_close(
        fp.flash_prefill(q, k, v, q_block=32, k_block=32),
        flash_attention(q, k, v, q_block=32, kv_block=32), **TOL)


def test_live_tiles_skip_only_tiles_without_a_valid_key():
    """The tiles the kernel visits: every tile with a key some query of the
    q tile may attend, and no other (the Pallas kernel's ``pl.when``)."""
    for S, qb, kb, w in [(60, 16, 16, 0), (60, 16, 16, 20), (500, 64, 32, 64),
                         (129, 32, 64, 1)]:
        for q0 in range(0, S, qb):
            rows = range(q0, min(q0 + qb, S))
            want = {kp // kb for qp in rows for kp in range(S)
                    if kp <= qp and (not w or qp - kp < w)}
            assert set(fp.live_tiles(q0, qb, kb, S, w)) == want, \
                (S, qb, kb, w, q0)


@pytest.mark.parametrize("dh,kb", [(64, 64), (128, 64), (160, 32)])
def test_budget_table_at_the_served_head_widths(dh, kb):
    """Qwen2 (64), Yi and Command-R (128), StableLM (160): a 64-row q tile
    of 128 threads, the kv tile as coarse as keeps two such blocks (8
    warps) on an SM, and the working set priced exactly."""
    blocks = fp.choose_blocks(500, dh)
    assert blocks == fp.PrefillBlocks(64, kb)
    ws = fp.working_set_bytes(64, kb, dh)
    assert ws == (64 + 2 * kb) * (dh + fp.PAD) * 4
    assert ws <= fp.block_budget(64) <= factorization.H100_SMEM_PER_BLOCK
    per_block = ws + factorization.H100_SMEM_RESERVED_PER_BLOCK
    assert 2 * per_block <= factorization.H100_SMEM_PER_SM
    if kb < fp.MAX_K_BLOCK:       # the next coarser tile would not fit
        assert fp.working_set_bytes(64, 2 * kb, dh) > fp.block_budget(64)


def test_budget_table_edges():
    assert fp.choose_blocks(5, 64).q_block == 16       # one warp of rows
    assert fp.choose_blocks(40, 64).q_block == 48
    assert fp.choose_blocks(500, 96) is None           # no instance
    assert fp.choose_blocks(500, 16) == fp.PrefillBlocks(64, 64)


def test_wrapper_rejects_mismatched_shapes():
    q, k, v = _torch(*_inputs(1, 8, 4, 2, 16, seed=0))
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        fp.flash_prefill(q, k[:, :4], v)
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        fp.flash_prefill(q[:, :, :3], k, v)


# ---------------------------------------------------------------------------
# The tensor-core (bf16) instance: its budget table, block order and route,
# and the plain version at its tiles and with its rounding of p
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16


@pytest.mark.parametrize("dh,dhp,kb,blocks", [(64, 64, 64, 5),
                                              (128, 128, 64, 2),
                                              (160, 192, 32, 3)])
def test_bf16_budget_table_at_the_served_head_widths(dh, dhp, kb, blocks):
    """Qwen2 (64), Yi and Command-R (128), StableLM (160, padded to three
    128-byte swizzle rows): the 64-row q tile of one warpgroup, the
    coarsest kv tile that leaves two blocks on an SM, and the dynamic
    shared memory priced exactly: the 1024-byte alignment slack, the q
    tile and two stages of k and v in bf16, five mbarriers (the q tile's,
    a full and an empty one per stage)."""
    assert fp.padded_head_dim(dh) == dhp
    assert fp.choose_blocks(500, dh, BF16) == fp.PrefillBlocks(64, kb)
    ws = fp.working_set_bytes(64, kb, dh, BF16)
    assert ws == 1024 + 64 * dhp * 2 + 2 * 2 * kb * dhp * 2 + 5 * 8
    assert factorization.blocks_per_sm(ws) == blocks \
        >= fp.TC_MIN_BLOCKS_PER_SM
    per_block = ws + factorization.H100_SMEM_RESERVED_PER_BLOCK
    assert blocks * per_block <= factorization.H100_SMEM_PER_SM \
        < (blocks + 1) * per_block
    # every tile starts on a 1024-byte swizzle atom: q, then each k and v
    # tile, from a base the slack aligns
    for tile in (64 * dhp * 2, kb * dhp * 2, fp.SWIZZLE_COLS * 2 * 8):
        assert tile % fp.SWIZZLE_ALIGN == 0
    coarser = [b for b in fp.TC_K_BLOCKS if b > kb]
    for b in coarser:           # a coarser kv tile leaves fewer blocks
        assert factorization.blocks_per_sm(
            fp.working_set_bytes(64, b, dh, BF16)) < fp.TC_MIN_BLOCKS_PER_SM


@pytest.mark.parametrize("S,dh,want", [
    (5, 64, (64, 32)), (40, 64, (64, 64)), (468, 64, (64, 64)),
    (500, 64, (64, 64)), (5, 128, (64, 32)), (40, 128, (64, 64)),
    (468, 128, (64, 64)), (500, 160, (64, 32)), (40, 16, (64, 64)),
    (5, 32, (64, 32))])
def test_bf16_choose_blocks_at_the_edges(S, dh, want):
    """The q tile is always the warpgroup's 64 rows; the kv tile is no
    longer than the sequence needs (S rounded up to a power of two, 32 at
    least) and the coarsest that leaves two blocks on an SM; f32 keeps its
    own table."""
    assert fp.choose_blocks(S, dh, BF16) == fp.PrefillBlocks(*want)
    assert fp.choose_blocks(S, dh) == fp.choose_blocks(S, dh, torch.float32)
    assert fp.choose_blocks(S, 96, BF16) is None


@pytest.mark.parametrize("B,H,S,window", [(1, 1, 1, 0), (2, 3, 130, 0),
                                          (4, 14, 500, 0), (2, 2, 500, 64)])
def test_tile_order_is_heaviest_first_and_covers_every_tile_once(B, H, S,
                                                                 window):
    """The tensor-core launch's block order as the kernel decodes
    blockIdx.x: every (row, head, q tile) exactly once, the q tiles from
    the last, the heads of a row side by side; without a window no block
    reads more kv tiles than one before it."""
    order = fp.tile_order(B, H, S)
    n_q = -(-S // fp.TC_Q_BLOCK)
    assert len(order) == len(set(order)) == B * H * n_q
    assert set(order) == {(b, h, t) for b in range(B) for h in range(H)
                          for t in range(n_q)}
    assert [t for _, _, t in order] == sorted((t for _, _, t in order),
                                              reverse=True)
    assert order[:H] == [(0, h, n_q - 1) for h in range(H)]
    work = [len(fp.live_tiles(t * fp.TC_Q_BLOCK, fp.TC_Q_BLOCK, 64, S,
                              window)) for _, _, t in order]
    if not window:
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,kb,w", [
    (1, 130, 4, 2, 64, 64, 0),      # Qwen2's head width, a ragged tail
    (1, 100, 4, 1, 128, 64, 0),     # Yi's
    (1, 70, 2, 2, 160, 32, 0),      # StableLM's
    (2, 96, 4, 1, 32, 64, 24),      # a window
    (1, 60, 2, 2, 16, 32, 20),      # a window shorter than the kv tile
    (1, 5, 2, 1, 64, 32, 0),        # shorter than one tile
])
def test_plain_at_the_tensor_core_tiles_matches_jax_pallas(B, S, Hq, Hkv, dh,
                                                           kb, w):
    """The plain version at the tensor-core instance's tiles (q_block 64,
    k_block 64 or 32) against JAX's Pallas kernel at the same tiles in
    interpret mode: the kernel on the card is held to this plain version."""
    q, k, v = _inputs(B, S, Hq, Hkv, dh, seed=S + dh + w)
    want = np.asarray(jax_ops.flash_prefill(*_jax(q, k, v), window=w,
                                            q_block=64, k_block=kb))
    got = fp.flash_prefill_plain(*_torch(q, k, v), window=w, q_block=64,
                                 k_block=kb)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("S,Hq,Hkv,dh,w", [(130, 4, 2, 64, 0),
                                           (100, 4, 1, 128, 0),
                                           (70, 2, 2, 160, 16)])
def test_round_p_moves_the_output_by_at_most_a_bf16_step(S, Hq, Hkv, dh, w):
    """``round_p`` rounds p to bf16 before the PV product, as the
    tensor-core instance does: in bf16 the output moves by at most one
    bf16 step of max|o| (2^-7 of it), and by something (it is not a
    no-op)."""
    q, k, v = (t.to(BF16) for t in _torch(*_inputs(1, S, Hq, Hkv, dh,
                                                   seed=S)))
    kw = dict(window=w, q_block=64, k_block=64)
    base = fp.flash_prefill_plain(q, k, v, **kw).float()
    rounded = fp.flash_prefill_plain(q, k, v, round_p=True, **kw)
    assert rounded.dtype == BF16
    diff = (rounded.float() - base).abs().max().item()
    assert 0 < diff <= 2 ** -7 * base.abs().max().item()


@pytest.mark.parametrize("dtype,dh,want", [
    *[(BF16, dh, "tc") for dh in fp.HEAD_DIMS],
    *[(torch.float32, dh, "simt") for dh in fp.HEAD_DIMS]])
def test_route_names_the_instance(dtype, dh, want):
    """Every bf16 head width runs on the tensor cores, every f32 one on the
    SIMT instance; decided from the dtype and dh, never by a failure."""
    assert fp.route(dtype, dh) == want


@pytest.mark.parametrize("dtype,dh,exc", [(torch.float16, 64, TypeError),
                                          (torch.float64, 128, TypeError),
                                          (BF16, 96, ValueError),
                                          (torch.float32, 256, ValueError)])
def test_route_raises_without_an_instance(dtype, dh, exc):
    with pytest.raises(exc):
        fp.route(dtype, dh)
