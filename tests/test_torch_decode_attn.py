"""The port's single-token decode attention (K9, ``kernels/
decode_attn.py``) on the CPU: its plain version (what ``ops.decode_attn``
runs for CPU tensors, and what the kernel is held to on the card) against
the JAX package's Pallas kernel in interpret mode and against both
packages' naive oracles, on the JAX package's own sweep cases
(tests/test_kernels.py::test_decode_attn_sweep) plus the port's head
widths; a row of length 0; and K9's budget table.  The kernel itself runs
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


@pytest.mark.parametrize("group,dk", [(7, 64), (8, 128), (4, 160)])
def test_budget_table_at_the_served_head_widths(group, dk):
    """Qwen2 (7 query heads a kv head, 64 wide), Yi and Command-R (8 x
    128), StableLM (4 x 160): the cache block of ``BLOCK_S`` positions,
    priced exactly, within a block's shared memory; every (head, dim) pair
    of the group held by the block's threads."""
    bs = da.choose_block(517, group, dk)
    assert bs == da.BLOCK_S
    ws = da.working_set_bytes(group, bs, dk)
    assert ws == 4 * (2 * bs * (dk + da.PAD) + group * dk + group * bs
                      + 3 * group)
    assert ws <= factorization.H100_SMEM_PER_BLOCK
    assert group * dk <= da.THREADS * da.MAX_PAIRS


def test_budget_table_edges():
    assert da.choose_block(33, 2, 8) == 33            # clamped to the cache
    assert da.choose_block(517, 16, 160) is None      # 2,560 pairs
    assert da.choose_block(517, 8, 30) is None        # dk not a multiple of 4


def test_wrapper_rejects_mismatched_shapes():
    q, kc, vc = (convert.params_from_numpy(a)
                 for a in _inputs(2, 4, 2, 16, 32, seed=0))
    with pytest.raises(ValueError, match="lengths"):
        da.decode_attn(q, kc, vc, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        da.decode_attn(q[:, :3], kc, vc, torch.ones(2, dtype=torch.int32))
