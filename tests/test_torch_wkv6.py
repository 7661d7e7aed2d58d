"""The port's RWKV6 chunked scan (``repro_torch.kernels.wkv6``, K6, and its
oracles in ``kernels/ref.py``) against the JAX package on the CPU.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against that plain version on the card by ``chip_smoke.py``.  Here the
oracles and the wrapper meet the JAX oracles and the JAX Pallas kernel (in
interpret mode, as its own tests run it) on the same numpy inputs, over the
JAX family's cases, and the wrapper keeps the properties tests/test_wkv6.py
asserts of the Pallas kernel: finite under extreme decay, split-resume
equal to the unsplit run, rows independent of their tile, any T.  The
budget table is checked term by term.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import plans as jax_plans  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import wkv6 as jax_wkv6  # noqa: E402

from repro_torch.core import factorization, plans  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_k  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402

#: oracle against oracle: the same f32 math in the same order up to the
#: frameworks' matmul and cumsum kernels
ORACLE_TOL = dict(rtol=1e-5, atol=1e-5)
#: the split-resume tolerance of tests/test_wkv6.py
SPLIT_TOL = dict(rtol=2e-4, atol=2e-4)


def _np_inputs(BH, T, dk, dv, seed, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = f(BH, T, dk), f(BH, T, dk), f(BH, T, dv)
    logw = (-np.exp(f(BH, T, dk)) * decay_scale).astype(np.float32)
    return r, k, v, logw, f(BH, dk), (0.3 * f(BH, dk, dv)).astype(np.float32)


def _torch(arrays, dtype="float32"):
    """r, k, v in ``dtype``; logw, u, state f32."""
    t = [torch.from_numpy(a) for a in arrays]
    dt = getattr(torch, dtype)
    return [a.to(dt) for a in t[:3]] + t[3:]


def _jax(arrays, dtype="float32"):
    return [jnp.asarray(a, dtype if i < 3 else "float32")
            for i, a in enumerate(arrays)]


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------
def test_ref_wkv6_chunk_matches_jax():
    a = [x[0] for x in _np_inputs(1, 8, 6, 5, seed=0)]
    got = ref.wkv6_chunk(*_torch(a))
    want = jax_ref.wkv6_chunk(*_jax(a))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ORACLE_TOL)


def test_ref_wkv6_matches_jax():
    a = [x[0] for x in _np_inputs(1, 24, 6, 5, seed=1)]
    got = ref.wkv6(*_torch(a), chunk=8)
    want = jax_ref.wkv6(*_jax(a), 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ORACLE_TOL)


def test_ref_wkv6_stepwise_matches_jax():
    a = [x[0] for x in _np_inputs(1, 19, 6, 5, seed=2)]
    got = ref.wkv6_stepwise(*_torch(a))
    want = jax_ref.wkv6_stepwise(*_jax(a))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ORACLE_TOL)


def test_ref_wkv6_takes_a_batch_of_rows():
    a = _np_inputs(3, 16, 4, 4, seed=3)
    out, s = ref.wkv6(*_torch(a), chunk=4)
    for i in range(3):
        oi, si = ref.wkv6(*[t[i] for t in _torch(a)], chunk=4)
        torch.testing.assert_close(out[i], oi, rtol=0, atol=1e-6)
        torch.testing.assert_close(s[i], si, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the wrapper against the JAX kernel over the family's cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", jax_plans._RWKV_CASES,
                         ids=[c.label for c in jax_plans._RWKV_CASES])
def test_wkv6_matches_the_jax_kernel_on_the_family_cases(case, dtype):
    B, T, H, dk, dv, chunk = case.shape
    a = _np_inputs(B * H, T, dk, dv, seed=len(case.label))
    out, s = wkv6_k.wkv6(*_torch(a, dtype), chunk=chunk)
    j_out, j_s = jax_wkv6.wkv6(*_jax(a, dtype), chunk=chunk)
    assert out.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    tol = plans.RWKV_TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(j_out), **tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(j_s), **tol)


# ---------------------------------------------------------------------------
# the sub-chunk form the kernels compute (``sub_chunk``)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sub_chunk", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", jax_plans._RWKV_CASES,
                         ids=[c.label for c in jax_plans._RWKV_CASES])
def test_sub_chunk_plain_matches_the_pairwise_plain_and_the_jax_kernel(
        case, dtype, sub_chunk):
    """The intra-chunk decays factored through sub-chunk boundaries (the
    kernels' ``SUB_CHUNK`` = 8, and 4 to cut every case's chunks into
    several sub-chunks) against the pairwise plain version and JAX's
    Pallas ``_kernel`` (interpret mode) at RWKV_TOL."""
    B, T, H, dk, dv, chunk = case.shape
    a = _np_inputs(B * H, T, dk, dv, seed=len(case.label) + 40)
    out, s = wkv6_k.wkv6_plain(*_torch(a, dtype), chunk, sub_chunk=sub_chunk)
    p_out, p_s = wkv6_k.wkv6_plain(*_torch(a, dtype), chunk)
    j_out, j_s = jax_wkv6.wkv6(*_jax(a, dtype), chunk=chunk)
    assert out.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    tol = plans.RWKV_TOL[dtype]
    for want_out, want_s in ((p_out, p_s), (j_out, j_s)):
        np.testing.assert_allclose(_f32(out), _f32(want_out), **tol)
        np.testing.assert_allclose(s.numpy(), _f32(want_s),
                                   **plans.RWKV_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay_scale", [1e3, 1e6])
def test_sub_chunk_outputs_finite_under_extreme_decay(decay_scale, dtype):
    a = _np_inputs(2, 19, 8, 8, seed=12, decay_scale=decay_scale)
    for chunk in (8, 19):
        out, s, traj = wkv6_k.wkv6_traj_plain(*_torch(a, dtype), chunk,
                                              sub_chunk=wkv6_k.SUB_CHUNK)
        assert all(bool(torch.isfinite(t.float()).all())
                   for t in (out, s, traj))


@pytest.mark.parametrize("T", [19, 23])
def test_sub_chunk_at_T_not_a_multiple_of_the_sub_chunk(T):
    """C = 32 clamps to T: sub-chunks of 8, 8 and a last short one; the
    trajectory form gives the same out and states."""
    a = _torch(_np_inputs(3, T, 8, 10, seed=13))
    out, s = wkv6_k.wkv6_plain(*a, 32, sub_chunk=wkv6_k.SUB_CHUNK)
    t_out, t_s, traj = wkv6_k.wkv6_traj_plain(*a, 32,
                                              sub_chunk=wkv6_k.SUB_CHUNK)
    want_out, want_s = ref.wkv6_stepwise(*a)
    tol = plans.RWKV_TOL["float32"]
    torch.testing.assert_close(out, want_out, **tol)
    torch.testing.assert_close(s, want_s, **tol)
    assert torch.equal(t_out, out) and torch.equal(t_s, s)
    assert traj.shape == (3, 1, 8, 10) and torch.equal(traj[:, 0], a[5])


def test_ops_wkv6_is_the_wrapper():
    a = _torch(_np_inputs(2, 12, 4, 4, seed=4))
    got = ops.wkv6(*a, chunk=4)
    want = wkv6_k.wkv6(*a, chunk=4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the properties of tests/test_wkv6.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay_scale", [1.0, 1e3, 1e6])
def test_outputs_finite_under_extreme_decay(decay_scale, dtype):
    a = _np_inputs(2, 19, 8, 8, seed=5, decay_scale=decay_scale)
    out, s = wkv6_k.wkv6(*_torch(a, dtype), chunk=8)
    assert bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(s).all())


@pytest.mark.parametrize("split,chunk", [(1, 8), (7, 4), (11, 12), (22, 1)])
def test_split_resume_matches_unsplit(split, chunk):
    r, k, v, logw, u, s0 = _torch(_np_inputs(2, 23, 6, 6, seed=6))
    out, s_full = wkv6_k.wkv6(r, k, v, logw, u, s0, chunk=chunk)
    cut = lambda t, lo, hi: t[:, lo:hi]  # noqa: E731
    out_a, s_mid = wkv6_k.wkv6(*(cut(t, 0, split) for t in (r, k, v, logw)),
                               u, s0, chunk=chunk)
    out_b, s_end = wkv6_k.wkv6(*(cut(t, split, 23) for t in (r, k, v, logw)),
                               u, s_mid, chunk=chunk)
    torch.testing.assert_close(torch.cat([out_a, out_b], 1), out,
                               **SPLIT_TOL)
    torch.testing.assert_close(s_end, s_full, **SPLIT_TOL)


@pytest.mark.parametrize("bh_tile", [2, 3, 5])
def test_rows_are_independent_of_their_tile(bh_tile):
    """Each row equals its own single-row run and the bh_tile=1 run, bit
    for bit (non-dividing BH=5 and T=23)."""
    a = _torch(_np_inputs(5, 23, 6, 6, seed=7))
    out, s = wkv6_k.wkv6(*a, chunk=8, bh_tile=bh_tile)
    out1, s1 = wkv6_k.wkv6(*a, chunk=8, bh_tile=1)
    assert torch.equal(out, out1) and torch.equal(s, s1)
    for i in range(5):
        oi, si = wkv6_k.wkv6(*(t[i:i + 1] for t in a), chunk=8)
        assert torch.equal(oi[0], out[i]) and torch.equal(si[0], s[i])


@pytest.mark.parametrize("T,chunk", [(23, 8), (7, 32), (33, 16)])
def test_any_T_matches_the_stepwise_oracle(T, chunk):
    a = _torch(_np_inputs(3, T, 8, 10, seed=8))
    out, s = wkv6_k.wkv6(*a, chunk=chunk)
    want_out, want_s = ref.wkv6_stepwise(*a)
    assert out.shape == (3, T, 10)
    torch.testing.assert_close(out, want_out, **plans.RWKV_TOL["float32"])
    torch.testing.assert_close(s, want_s, **plans.RWKV_TOL["float32"])


def test_cpu_calls_differentiate_the_plain_version_and_count_no_launch():
    a = [t.requires_grad_() for t in _torch(_np_inputs(2, 9, 4, 4, seed=9))]
    before = wkv6_k.wkv6.launches
    out, s = wkv6_k.wkv6(*a, chunk=4)
    grads = torch.autograd.grad(out.sum() + s.sum(), a)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert wkv6_k.wkv6.launches == before


def test_wrapper_emits_its_dispatch_event():
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        wkv6_k.wkv6(*_torch(_np_inputs(3, 7, 4, 4, seed=10)), chunk=32,
                    bh_tile=8)
    finally:
        trace_lib.set_tracer(old)
    (event,) = sink.records
    assert event["name"] == "plan/dispatch"
    assert event["attrs"] == dict(family="rwkv6", plan="chunked_scan",
                                  chunk=7, bh_tile=3, n_bh=3, seq_len=7)


def test_wrapper_rejects_mismatched_shapes():
    r, k, v, logw, u, s = _torch(_np_inputs(2, 8, 4, 4, seed=11))
    with pytest.raises(ValueError):
        wkv6_k.wkv6(r, k, v, logw, u[:1], s)
    with pytest.raises(ValueError):
        wkv6_k.wkv6(r, k[:, :4], v, logw, u, s)


# ---------------------------------------------------------------------------
# the budget table
# ---------------------------------------------------------------------------
def test_working_set_is_the_launch_size_at_the_serving_heads():
    """64 x 64 heads at C=32: seven (32, 65) f32 tiles (r, k, L, r alpha,
    k beta, r e^{Lp}, k e^{Llast - L}), v (32 x 65), the scores (32 x 33),
    the state (64 x 65), gamma (6 pairs of 4 sub-chunks x 65), u and the
    bonus — 89,368 bytes, two thread blocks to an SM, whatever the IO
    dtype."""
    terms = {"tiles": 7 * 32 * 65 * 4, "v": 32 * 65 * 4,
             "scores": 32 * 33 * 4, "state": 64 * 65 * 4,
             "gamma": 6 * 65 * 4, "vectors": (64 + 32) * 4}
    assert wkv6_k.working_set_bytes(512, 64, 64, 32) == \
        sum(terms.values()) == 89_368
    assert 2 * (89_368 + 1024) <= 233_472         # an SM's shared memory
    # the chunk is clamped to T
    assert wkv6_k.working_set_bytes(7, 64, 64, 32) == \
        wkv6_k.working_set_bytes(7, 64, 64, 7)
    # the backward kernel's table is its own (tests/test_torch_wkv6_bwd.py)
    assert wkv6_k.working_set_bytes(512, 64, 64, 32, mode="bwd") == 115_224


def test_choose_blocks_keeps_the_chunk_coarse_and_one_row_a_block():
    assert wkv6_k.choose_blocks(512, 64, 64) == wkv6_k.WkvBlocks(32, 1)
    assert wkv6_k.choose_blocks(500, 64, 64, target=64) == \
        wkv6_k.WkvBlocks(64, 1)
    assert wkv6_k.choose_blocks(7, 64, 64) == wkv6_k.WkvBlocks(7, 1)
    blocks = wkv6_k.choose_blocks(512, 64, 64)
    assert blocks.batch_tile == 1 and blocks.time_chunk == 32


def test_choose_blocks_halves_the_chunk_then_gives_up():
    at16 = wkv6_k.working_set_bytes(512, 64, 64, 16)
    assert wkv6_k.choose_blocks(512, 64, 64, smem_budget=at16) == \
        wkv6_k.WkvBlocks(16, 1)
    assert wkv6_k.choose_blocks(512, 64, 64,
                                smem_budget=at16 - 1).chunk == 8
    # the (dk, dv) state alone is 16 KiB: nothing fits under it
    assert wkv6_k.choose_blocks(512, 64, 64,
                                smem_budget=64 * 64 * 4) is None
    # heads wider than a block has threads
    assert wkv6_k.choose_blocks(64, 8, 300) is None
