"""The port's single-token decode attention (K9, ``kernels/
decode_attn.py``) on the CPU: its plain version (what ``ops.decode_attn``
runs for CPU tensors, and what the kernel is held to on the card) against
the JAX package's Pallas kernel in interpret mode and against both
packages' naive oracles, on the JAX package's own sweep cases
(tests/test_kernels.py::test_decode_attn_sweep) plus the port's head
widths, at the splits over cache positions the kernel runs (each split's
online softmax, then the merge in split order); a row of length 0 and
lengths at the blocks' edges; and K9's budget table.  The kernel itself runs
on the card only (chip_smoke.py, phase A2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import factorization  # noqa: E402
from repro_torch.kernels import decode_attn as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: tests/test_kernels.py::test_decode_attn_sweep's tolerance
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(B, Hq, Hkv, S, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh))]


def _lengths(B, S):
    """The JAX sweep's ragged lengths, one per row."""
    return (np.arange(1, B + 1) * (S // (B + 1)) + 1).astype(np.int32)


@pytest.mark.parametrize("B,Hq,Hkv,S,dh,block", [
    # tests/test_kernels.py::test_decode_attn_sweep
    (2, 8, 2, 96, 32, 32), (1, 4, 4, 64, 64, 64), (3, 16, 2, 128, 16, 128),
    (2, 2, 1, 33, 8, 16),
    # the port's head widths and groups: Qwen2 (7 x 64), Yi (8 x 128),
    # StableLM (4 x 160), over caches no block divides
    (2, 14, 2, 75, 64, 32), (3, 32, 4, 70, 128, 64), (2, 8, 2, 41, 160, 16),
])
def test_plain_matches_jax_pallas_and_the_oracles(B, Hq, Hkv, S, dh, block):
    q, kc, vc = _inputs(B, Hq, Hkv, S, dh, seed=S + Hq)
    lens = _lengths(B, S)
    want = np.asarray(jax_ops.decode_attn(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        block_s=block))
    tq, tk, tv, tl = (convert.params_from_numpy(a) for a in (q, kc, vc, lens))
    got = ops.decode_attn(tq, tk, tv, tl, block_s=block)
    assert got.shape == (B, Hq, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    oracle = ref.decode_attn(tq, tk, tv, tl)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(jax_ref.decode_attn(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens))),
        **TOL)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)
    assert da.decode_attn.launches == 0        # CPU calls are not counted


def test_length_zero_gives_zero_as_the_pallas_kernel_does():
    """A row of length 0: the Pallas kernel returns 0 (its p is 1 on
    invalid positions whose v it zeroed), the naive oracles NaN; the port
    keeps the kernel's 0.  The other row is unaffected."""
    q, kc, vc = _inputs(2, 4, 2, 16, 32, seed=3)
    lens = np.array([0, 5], np.int32)
    want = np.asarray(jax_ops.decode_attn(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        block_s=8))
    tq, tk, tv, tl = (convert.params_from_numpy(a) for a in (q, kc, vc, lens))
    got = ops.decode_attn(tq, tk, tv, tl, block_s=8)
    assert np.all(want[0] == 0) and torch.all(got[0] == 0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.isnan(ref.decode_attn(tq, tk, tv, tl)[0]).all()
    assert np.isnan(np.asarray(jax_ref.decode_attn(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lens))[0])).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_dtypes_match_jax_pallas(dtype, tol):
    """The same values in both packages (bf16 carried bit for bit), the
    output in the input dtype, at tests/test_flash_prefill.py's tolerance
    for the dtype."""
    q, kc, vc = (jnp.asarray(a).astype(dtype)
                 for a in _inputs(2, 8, 2, 50, 64, seed=4))
    lens = _lengths(2, 50)
    want = np.asarray(jax_ops.decode_attn(q, kc, vc, jnp.asarray(lens),
                                          block_s=16), np.float32)
    got = ops.decode_attn(*(convert.params_from_numpy(np.asarray(t))
                            for t in (q, kc, vc, lens)), block_s=16)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_block_s_never_changes_results():
    q, kc, vc = (convert.params_from_numpy(a)
                 for a in _inputs(3, 8, 2, 77, 32, seed=5))
    lens = torch.tensor([1, 40, 77], dtype=torch.int32)
    outs = [da.decode_attn(q, kc, vc, lens, block_s=bs)
            for bs in (1, 16, 64, 77, 128)]
    for o in outs[1:]:
        torch.testing.assert_close(outs[0], o, **TOL)


def test_lse_is_the_log_sum_exp_of_the_scaled_scores():
    """``with_lse``: the output unchanged, and each head's log-sum-exp of
    its scaled scores over the row's valid positions (JAX's reference
    scores), NEG_INF for a row of length 0; on meta, the shapes alone."""
    B, Hq, Hkv, S, dh = 3, 8, 2, 40, 32
    q, kc, vc = _inputs(B, Hq, Hkv, S, dh, seed=6)
    lens = np.array([0, 17, 40], np.int32)
    tq, tk, tv, tl = (convert.params_from_numpy(a) for a in (q, kc, vc, lens))
    out, lse = ops.decode_attn(tq, tk, tv, tl, block_s=8, with_lse=True)
    torch.testing.assert_close(out, ops.decode_attn(tq, tk, tv, tl,
                                                    block_s=8), rtol=0, atol=0)
    assert lse.shape == (B, Hq) and lse.dtype == torch.float32
    g = Hq // Hkv
    kq = jnp.repeat(jnp.asarray(kc), g, axis=2)          # (B, S, Hq, dh)
    scores = np.asarray(jnp.einsum("bhd,bshd->bhs", jnp.asarray(q), kq)
                        * dh ** -0.5)
    for b in range(1, B):
        want = np.log(np.exp(scores[b, :, :lens[b]]).sum(-1))
        np.testing.assert_allclose(lse[b].numpy(), want, **TOL)
    assert torch.all(lse[0] == da.NEG_INF)
    mo, ml = da.decode_attn(*(t.to("meta") for t in (tq, tk, tv, tl)),
                            with_lse=True)
    assert (mo.shape, ml.shape, ml.dtype) == (tq.shape, (B, Hq), torch.float32)


def test_lse_combines_slices_of_a_cache_into_the_whole():
    """A cache cut into slices along its positions, K9 on each (its
    lengths cut to the slice) with the log-sum-exp, the outputs weighted
    by exp(lse - max): the whole cache's output, as the decode on a cache
    split over 'model' combines its ranks'."""
    B, Hq, Hkv, S, dh = 4, 8, 2, 48, 32
    q, kc, vc = (convert.params_from_numpy(a)
                 for a in _inputs(B, Hq, Hkv, S, dh, seed=7))
    lens = torch.tensor([1, 12, 30, 48], dtype=torch.int32)
    whole = da.decode_attn(q, kc, vc, lens)
    parts = []
    for lo in range(0, S, 12):
        cut = (lens - lo).clamp(0, 12).to(torch.int32)
        parts.append(da.decode_attn(q, kc[:, lo:lo + 12], vc[:, lo:lo + 12],
                                    cut, with_lse=True))
    mx = torch.stack([lse for _, lse in parts]).amax(0)
    wgt = [torch.exp(lse - mx) for _, lse in parts]
    got = (sum(o * w[..., None] for (o, _), w in zip(parts, wgt))
           / sum(wgt)[..., None])
    torch.testing.assert_close(got, whole, **TOL)


#: the served decode shapes: (model, B, group, dk, kv heads) at S = 517
SERVED = [("qwen2-0.5b", 4, 7, 64, 2), ("yi-9b", 4, 8, 128, 4),
          ("command-r-35b", 4, 8, 128, 8), ("stablelm-12b", 4, 4, 160, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("model,B,group,dk,n_kv", SERVED,
                         ids=[s[0] for s in SERVED])
def test_budget_table_at_the_served_head_widths(model, B, group, dk, n_kv,
                                                dtype):
    """Qwen2 (7 query heads a kv head, 64 wide), Yi and Command-R (8 x
    128), StableLM (4 x 160) at B = 4 over 517 slots: splits x Hkv x B
    reaches a block for each of the 132 SMs, the spans cover the cache
    and none lies wholly past it, the working set is priced exactly and
    fits a block, two blocks fit an SM in the served dtype (bf16: the
    blocks past 132 run beside others), every (head, dim) pair of the
    group held by the block's threads."""
    bl = da.choose_blocks(517, B, n_kv, group, dk, dtype)
    assert bl.grid == bl.splits * n_kv * B >= factorization.H100_SMS
    assert bl.span % bl.block_s == 0
    assert bl.span * (bl.splits - 1) < 517 <= bl.span * bl.splits
    io = 2 if dtype == torch.bfloat16 else 4
    ws = da.working_set_bytes(group, bl.block_s, dk, dtype)
    assert bl.smem == ws == 4 * bl.block_s * dk * io + 4 * (
        group * dk + group * bl.block_s + 3 * group)
    assert ws + da.STATIC_SMEM <= factorization.H100_SMEM_PER_BLOCK
    assert dtype != torch.bfloat16 or 2 * (
        ws + factorization.H100_SMEM_RESERVED_PER_BLOCK) \
        <= factorization.H100_SMEM_PER_SM
    assert group * dk <= da.THREADS * da.ACC_FLOATS
    assert da.workspace_floats(B, n_kv, group, dk, bl.splits) == \
        B * n_kv * bl.splits * group * (dk + 4)


@pytest.mark.parametrize("args,want", [
    # the cache block halves (to MIN_BLOCK_S) while S holds fewer blocks
    # than the splits asked for: a block an SM at Qwen2's and Yi's shapes
    ((517, 4, 2, 7, 64, torch.bfloat16), (32, 17, 32)),
    ((517, 4, 4, 8, 128, torch.bfloat16), (64, 9, 64)),
    # a short cache: blocks of 16, as many splits as blocks
    ((33, 2, 1, 2, 8), (16, 3, 16)),
    # StableLM's heads: fewer splits than blocks, spans of two
    ((517, 4, 8, 4, 160, torch.bfloat16), (64, 5, 128)),
    # one (row, kv head): as many splits as blocks of 16
    ((517, 1, 1, 16, 128), (16, 33, 16)),
    # a pinned block longer than the cache: one split
    ((77, 2, 2, 4, 32, torch.float32, 128), (128, 1, 128)),
    # one head of 2,048: the block halves until two stages fit
    ((517, 2, 1, 1, 2048), (4, 65, 8)),
    # no launch: 2,560 pairs; dk not whole 16-byte chunks (f32, bf16); a
    # pinned block past the shared memory
    ((517, 1, 1, 16, 160), None), ((517, 1, 8, 1, 30), None),
    ((517, 1, 8, 1, 36, torch.bfloat16), None),
    ((517, 1, 1, 1, 2048, torch.float32, 64), None)])
def test_budget_table_edges(args, want):
    bl = da.choose_blocks(*args[:6], block_s=args[6]) if len(args) > 6 \
        else da.choose_blocks(*args)
    assert (bl if bl is None else (bl.block_s, bl.splits, bl.span)) == want


def _split_counts(S, block_s):
    """Splits of 1, 2 and 9 and one per block of ``block_s`` positions."""
    return [1, 2, 9, -(-S // block_s)]


@pytest.mark.parametrize("B,Hq,Hkv,S,dh,block", [
    (2, 8, 2, 96, 32, 32), (1, 4, 4, 64, 64, 64), (3, 16, 2, 128, 16, 128),
    (2, 2, 1, 33, 8, 16),
    (2, 14, 2, 75, 64, 16), (2, 32, 4, 70, 128, 16), (2, 8, 2, 41, 160, 8),
])
def test_split_plain_matches_jax_pallas(B, Hq, Hkv, S, dh, block):
    """The plain version at every split (1, 2, 9, one per block) against
    the JAX package's Pallas kernel in interpret mode, which walks the
    whole cache in one order, at its tolerance."""
    q, kc, vc = _inputs(B, Hq, Hkv, S, dh, seed=S + dh)
    lens = _lengths(B, S)
    want = np.asarray(jax_ops.decode_attn(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        block_s=block))
    tq, tk, tv, tl = (convert.params_from_numpy(a) for a in (q, kc, vc, lens))
    for splits in _split_counts(S, block):
        got = da.decode_attn_plain(tq, tk, tv, tl, block_s=block,
                                   splits=splits)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"splits={splits}")


@pytest.mark.parametrize("S,dh,block", [(70, 64, 16), (129, 128, 32)])
def test_lengths_at_the_block_edges(S, dh, block):
    """Rows of length 0, 1, block_s, block_s + 1 and S, at each split,
    against the Pallas kernel (a row of length 0 gives 0 in both)."""
    lens = np.array([0, 1, block, block + 1, S], np.int32)
    q, kc, vc = _inputs(5, 8, 2, S, dh, seed=dh)
    want = np.asarray(jax_ops.decode_attn(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        block_s=block))
    tq, tk, tv, tl = (convert.params_from_numpy(a) for a in (q, kc, vc, lens))
    for splits in _split_counts(S, block):
        got = da.decode_attn_plain(tq, tk, tv, tl, block_s=block,
                                   splits=splits)
        assert torch.all(got[0] == 0)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"splits={splits}")


@pytest.mark.parametrize("block", [1, 16, 64])
def test_split_never_changes_results(block):
    """Every split count from 1 to one per block gives the unsplit result
    within 2e-4."""
    q, kc, vc = (convert.params_from_numpy(a)
                 for a in _inputs(3, 8, 2, 77, 32, seed=6))
    lens = torch.tensor([1, 40, 77], dtype=torch.int32)
    base = da.decode_attn_plain(q, kc, vc, lens, block_s=block)
    for splits in range(2, -(-77 // block) + 1, max(1, 77 // block // 9)):
        torch.testing.assert_close(da.decode_attn_plain(
            q, kc, vc, lens, block_s=block, splits=splits), base, **TOL)


def test_cpu_wrapper_takes_the_tables_split():
    """A CPU call runs the plain version at ``choose_blocks``'s block and
    split, bit for bit."""
    q, kc, vc = (convert.params_from_numpy(a)
                 for a in _inputs(4, 14, 2, 517, 64, seed=7))
    lens = torch.tensor([0, 63, 300, 508], dtype=torch.int32)
    bl = da.choose_blocks(517, 4, 2, 7, 64)
    assert bl.splits > 1
    assert torch.equal(da.decode_attn(q, kc, vc, lens), da.decode_attn_plain(
        q, kc, vc, lens, block_s=bl.block_s, splits=bl.splits))


def test_wrapper_rejects_mismatched_shapes():
    q, kc, vc = (convert.params_from_numpy(a)
                 for a in _inputs(2, 4, 2, 16, 32, seed=0))
    with pytest.raises(ValueError, match="lengths"):
        da.decode_attn(q, kc, vc, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        da.decode_attn(q[:, :3], kc, vc, torch.ones(2, dtype=torch.int32))
