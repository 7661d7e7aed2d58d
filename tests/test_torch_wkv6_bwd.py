"""The port's RWKV6 training kernels' CPU half (``repro_torch.kernels.wkv6``:
``wkv6_traj`` and its plain version, the hand-derived backward
``wkv6_bwd_plain``, ``_Wkv6Fn``, the backward's budget table) against
torch autograd and the JAX package on the CPU.

The CUDA kernels K6t and K6b are held against these plain versions on the
card by ``chip_smoke.py``; here the plain backward meets torch autograd of
``wkv6_plain`` and the gradients of the JAX Pallas kernel (interpret mode,
its fused backward ``FUSED_BWD``) on the same numpy inputs, over the JAX
family's cases, at the family's gradient tolerance ``RWKV_GRAD_TOL``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plans as jax_plans  # noqa: E402
from repro.kernels import wkv6 as jax_wkv6  # noqa: E402

from repro_torch.core import factorization, plans  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_k  # noqa: E402

GRAD_TOL = plans.RWKV_GRAD_TOL["float32"]
CASES = jax_plans._RWKV_CASES
CASE_IDS = [c.label for c in CASES]


def _np_inputs(BH, T, dk, dv, seed, decay_scale=1.0):
    """r, k, v, logw (<= 0), u, state and the cotangents dout, ds_fin."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = f(BH, T, dk), f(BH, T, dk), f(BH, T, dv)
    logw = (-np.exp(f(BH, T, dk)) * decay_scale).astype(np.float32)
    return ([r, k, v, logw, f(BH, dk), (0.3 * f(BH, dk, dv)).astype(
        np.float32)], [f(BH, T, dv), f(BH, dk, dv)])


def _case(case, seed=0):
    B, T, H, dk, dv, chunk = case.shape
    return _np_inputs(B * H, T, dk, dv, seed), chunk


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _plain_bwd(args, cots, chunk):
    """The port's trajectory forward, then its hand-derived backward."""
    _, s_fin, s_traj = wkv6_k.wkv6_traj(*args, chunk=chunk)
    return wkv6_k.wkv6_bwd_plain(*args[:5], s_traj, s_fin, *cots, chunk)


def _autograd(args, cots, chunk):
    args = [a.clone().requires_grad_() for a in args]
    out = wkv6_k.wkv6_plain(*args, chunk)
    return torch.autograd.grad(out, args, cots)


# ---------------------------------------------------------------------------
# the hand-derived backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bwd_plain_matches_torch_autograd(case):
    (a, c), chunk = _case(case, seed=1)
    got = _plain_bwd(_torch(a), _torch(c), chunk)
    want = _autograd(_torch(a), _torch(c), chunk)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                          want):
        assert g.dtype == torch.float32, name
        torch.testing.assert_close(g, w, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bwd_plain_matches_the_jax_kernel(case):
    """Against ``jax.vjp`` of the JAX Pallas kernel with its fused
    backward (``_bwd_kernel``, interpret mode) on the same cotangents."""
    (a, c), chunk = _case(case, seed=2)
    _, vjp = jax.vjp(lambda *x: jax_wkv6.wkv6(
        *x, chunk=chunk, bwd=jax_wkv6.FUSED_BWD), *map(jnp.asarray, a))
    want = vjp(tuple(map(jnp.asarray, c)))
    got = _plain_bwd(_torch(a), _torch(c), chunk)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay_scale", [1e3, 1e6])
def test_grads_finite_under_extreme_decay(decay_scale, dtype):
    a, c = _np_inputs(2, 19, 8, 8, seed=3, decay_scale=decay_scale)
    a, c = _torch(a), _torch(c)
    dt = getattr(torch, dtype)
    a[:3] = [t.to(dt) for t in a[:3]]
    c[0] = c[0].to(dt)
    for g in _plain_bwd(a, c, 8):
        assert bool(torch.isfinite(g.float()).all())


def test_bwd_plain_output_dtypes_follow_the_io():
    a, c = _np_inputs(2, 9, 4, 6, seed=4)
    a, c = _torch(a), _torch(c)
    a[:3] = [t.to(torch.bfloat16) for t in a[:3]]
    c[0] = c[0].to(torch.bfloat16)
    got = _plain_bwd(a, c, 4)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    assert [tuple(g.shape) for g in got] == [(2, 9, 4), (2, 9, 4), (2, 9, 6),
                                              (2, 9, 4), (2, 4), (2, 4, 6)]


def test_bwd_rows_are_independent_and_runs_repeat():
    a, c = _torch(_np_inputs(5, 23, 6, 6, seed=5)[0]), \
        _torch(_np_inputs(5, 23, 6, 6, seed=5)[1])
    base = _plain_bwd(a, c, 8)
    again = _plain_bwd(a, c, 8)
    assert all(torch.equal(x, y) for x, y in zip(base, again))
    for i in (0, 3):
        alone = _plain_bwd([t[i:i + 1] for t in a], [t[i:i + 1] for t in c],
                           8)
        for x, y in zip(alone, base):
            torch.testing.assert_close(x[0], y[i], rtol=0, atol=1e-6)


def test_bwd_wrapper_checks_its_shapes():
    a, c = _torch(_np_inputs(2, 9, 4, 4, seed=6)[0]), \
        _torch(_np_inputs(2, 9, 4, 4, seed=6)[1])
    _, s_fin, s_traj = wkv6_k.wkv6_traj(*a, chunk=4)
    assert s_traj.shape == (2, 3, 4, 4)
    with pytest.raises(ValueError, match="s_traj"):
        wkv6_k.wkv6_bwd(*a[:5], s_traj[:, :2], s_fin, *c, chunk=4)
    with pytest.raises(ValueError, match="dout"):
        wkv6_k.wkv6_bwd(*a[:5], s_traj, s_fin, c[0][:, :4], c[1], chunk=4)
    before = wkv6_k.wkv6_bwd.launches
    got = wkv6_k.wkv6_bwd(*a[:5], s_traj, s_fin, *c, chunk=4)
    want = wkv6_k.wkv6_bwd_plain(*a[:5], s_traj, s_fin, *c, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert wkv6_k.wkv6_bwd.launches == before


# ---------------------------------------------------------------------------
# the sub-chunk form the kernel computes (``sub_chunk``)
# ---------------------------------------------------------------------------
def _sub_bwd(args, cots, chunk, sub_chunk):
    _, s_fin, s_traj = wkv6_k.wkv6_traj_plain(*args, chunk,
                                              sub_chunk=sub_chunk)
    return wkv6_k.wkv6_bwd_plain(*args[:5], s_traj, s_fin, *cots, chunk,
                                 sub_chunk=sub_chunk)


@pytest.mark.parametrize("sub_chunk", [8, 4])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sub_chunk_bwd_matches_the_pairwise_plain_and_the_jax_kernel(
        case, sub_chunk):
    """The backward with its intra-chunk decays factored through sub-chunk
    boundaries against the pairwise plain backward and ``jax.vjp`` of the
    JAX Pallas kernel with its fused backward (``_bwd_kernel``, interpret
    mode), at RWKV_GRAD_TOL."""
    (a, c), chunk = _case(case, seed=12)
    got = _sub_bwd(_torch(a), _torch(c), chunk, sub_chunk)
    plain = _plain_bwd(_torch(a), _torch(c), chunk)
    _, vjp = jax.vjp(lambda *x: jax_wkv6.wkv6(
        *x, chunk=chunk, bwd=jax_wkv6.FUSED_BWD), *map(jnp.asarray, a))
    want = vjp(tuple(map(jnp.asarray, c)))
    for name, g, p, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                             plain, want):
        torch.testing.assert_close(g, p, **GRAD_TOL, msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay_scale", [1e3, 1e6])
def test_sub_chunk_grads_finite_under_extreme_decay(decay_scale, dtype):
    a, c = _np_inputs(2, 19, 8, 8, seed=13, decay_scale=decay_scale)
    a, c = _torch(a), _torch(c)
    dt = getattr(torch, dtype)
    a[:3] = [t.to(dt) for t in a[:3]]
    c[0] = c[0].to(dt)
    for chunk in (8, 19):
        for g in _sub_bwd(a, c, chunk, wkv6_k.SUB_CHUNK):
            assert bool(torch.isfinite(g.float()).all())


@pytest.mark.parametrize("T", [19, 23])
def test_sub_chunk_bwd_at_T_not_a_multiple_of_the_sub_chunk(T):
    """C = 32 clamps to T (sub-chunks 8, 8 and a short one), and C = 16
    leaves a short last chunk: against autograd of the pairwise plain
    forward."""
    a, c = _np_inputs(3, T, 6, 5, seed=14)
    for chunk in (32, 16):
        got = _sub_bwd(_torch(a), _torch(c), chunk, wkv6_k.SUB_CHUNK)
        want = _autograd(_torch(a), _torch(c), chunk)
        for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                              want):
            torch.testing.assert_close(g, w, **GRAD_TOL, msg=name)


# ---------------------------------------------------------------------------
# the trajectory forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [c for c in CASES
                                  if c.shape[1] % c.shape[5] == 0],
                         ids=[c.label for c in CASES
                              if c.shape[1] % c.shape[5] == 0])
def test_wkv6_traj_matches_the_jax_trajectory_kernel(case):
    """Against JAX's ``_fwd_call(traj=True)`` (``_traj_kernel``, interpret
    mode), which takes T a multiple of the chunk."""
    (a, _), chunk = _case(case, seed=7)
    jout, js, jtraj = jax_wkv6._fwd_call(*map(jnp.asarray, a), chunk, 1,
                                         True, traj=True)
    out, s, traj = wkv6_k.wkv6_traj(*_torch(a), chunk=chunk)
    assert traj.dtype == torch.float32
    tol = plans.RWKV_TOL["float32"]
    for g, w in ((out, jout), (s, js), (traj, jtraj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_wkv6_traj_equals_wkv6_and_its_states_start_each_chunk():
    a = _torch(_np_inputs(3, 23, 6, 5, seed=8)[0])
    out, s, traj = wkv6_k.wkv6_traj(*a, chunk=8)
    want_out, want_s = wkv6_k.wkv6(*a, chunk=8)
    assert torch.equal(out, want_out) and torch.equal(s, want_s)
    assert traj.shape == (3, 3, 6, 5) and torch.equal(traj[:, 0], a[5])
    for ch in (1, 2):       # the state after ch * 8 steps
        _, mid = wkv6_k.wkv6(*(t[:, :ch * 8] for t in a[:4]), a[4], a[5],
                             chunk=8)
        torch.testing.assert_close(traj[:, ch], mid, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_under_autograd_equals_autograd_of_the_plain_version(dtype):
    """``wkv6`` under autograd runs ``_Wkv6Fn`` (on the CPU the trajectory
    forward's and the backward's plain versions); its gradients equal
    autograd of ``wkv6_plain``, in the inputs' dtypes."""
    a, c = _np_inputs(2, 13, 6, 5, seed=9)
    dt = getattr(torch, dtype)
    a, c = _torch(a), _torch(c)
    a[:3] = [t.to(dt) for t in a[:3]]
    c[0] = c[0].to(dt)
    mine = [t.clone().requires_grad_() for t in a]
    out = wkv6_k.wkv6(*mine, chunk=4)
    assert out[1].grad_fn.name().startswith("_Wkv6Fn")
    got = torch.autograd.grad(out, mine, c)
    want = _autograd(a, c, 4)
    tol = GRAD_TOL if dtype == "float32" else plans.RWKV_TOL[dtype]
    for g, w, x in zip(got, want, a):
        assert g.dtype == x.dtype
        torch.testing.assert_close(g.float(), w.float(), **tol)


def test_chunked_scan_sums_u_over_the_batch():
    """The model-layout plan broadcasts u (H, dk) to every batch-head row;
    its gradient through ``_Wkv6Fn`` sums over B as autograd of the plain
    chunked scan does (B=3, the last state unused: a zero cotangent)."""
    rng = np.random.default_rng(10)
    B, S, H, dk, dv = 3, 11, 2, 4, 6
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    args = [f(B, S, H, dk), f(B, S, H, dk), f(B, S, H, dv),
            -torch.exp(f(B, S, H, dk)), f(H, dk), 0.3 * f(B, H, dk, dv)]
    dout = f(B, S, H, dv)
    grads = {}
    for plan in ("chunked_scan", "chunked_xla"):
        x = [t.clone().requires_grad_() for t in args]
        out, _ = plans.RWKV_PLANS[plan](*x, chunk=4)
        grads[plan] = torch.autograd.grad(out, x, dout)
    for g, w in zip(grads["chunked_scan"], grads["chunked_xla"]):
        torch.testing.assert_close(g, w, **GRAD_TOL)
    assert grads["chunked_scan"][4].shape == (H, dk)


def test_no_gradient_means_no_function():
    a = [t.requires_grad_() for t in _torch(_np_inputs(2, 8, 4, 4,
                                                       seed=11)[0])]
    with torch.no_grad():
        out, s = wkv6_k.wkv6(*a, chunk=4)
    assert out.grad_fn is None and s.grad_fn is None


# ---------------------------------------------------------------------------
# the backward's budget table
# ---------------------------------------------------------------------------
def test_bwd_working_set_term_by_term():
    """64 x 64 heads at C=32: seven (32, 65) f32 tiles (r, k, L, r alpha
    and k beta, which later hold r e^{Lp} and k e^{Llast - L}, the dr and
    dk partials), v and dO (32, 65), A with dA transposed above its
    diagonal (32, 33), S and dS (64, 65), gamma (6 x 65), u, Llast's term
    (two), du, the bonus and db — 115,224 bytes, two blocks to an SM."""
    terms = {"tiles": 7 * 32 * 65 * 4, "v_dout": 2 * 32 * 65 * 4,
             "scores": 32 * 33 * 4, "states": 2 * 64 * 65 * 4,
             "gamma": 6 * 65 * 4, "vectors": (4 * 64 + 2 * 32) * 4}
    assert wkv6_k.working_set_bytes(512, 64, 64, 32, mode="bwd") == \
        sum(terms.values()) == 115_224
    assert 2 * (115_224 + 1024) <= 233_472        # two blocks to an SM
    assert wkv6_k.working_set_bytes(7, 64, 64, 32, mode="bwd") == \
        wkv6_k.working_set_bytes(7, 64, 64, 7, mode="bwd")
    assert wkv6_k.working_set_bytes(512, 64, 64, 32, mode="bwd") > \
        wkv6_k.working_set_bytes(512, 64, 64, 32)
    with pytest.raises(ValueError):
        wkv6_k.working_set_bytes(512, 64, 64, 32, mode="train")


def test_bwd_choose_blocks_halves_the_chunk_then_gives_up():
    assert wkv6_k.choose_blocks(512, 64, 64, mode="bwd") == \
        wkv6_k.WkvBlocks(32, 1)
    at16 = wkv6_k.working_set_bytes(512, 64, 64, 16, mode="bwd")
    assert wkv6_k.choose_blocks(512, 64, 64, smem_budget=at16 - 1,
                                mode="bwd") == wkv6_k.WkvBlocks(8, 1)
    # the forward fits where the backward does not
    at32 = wkv6_k.working_set_bytes(512, 64, 64, 32, mode="bwd")
    assert wkv6_k.choose_blocks(512, 64, 64, smem_budget=at32 - 1) == \
        wkv6_k.WkvBlocks(32, 1)
    assert wkv6_k.choose_blocks(512, 64, 64, smem_budget=at32 - 1,
                                mode="bwd").chunk == 16
    # the state and its cotangent alone are 33 KiB at 64 x 64
    assert wkv6_k.choose_blocks(512, 64, 64, smem_budget=2 * 64 * 65 * 4,
                                mode="bwd") is None
    assert wkv6_k.choose_blocks(64, 8, 300, mode="bwd") is None


def test_rwkv_viability_for_training():
    assert plans.rwkv_viability(512, 64, 64, train=True)("chunked_scan")
    # heads of 128: the backward fits from C=16 (210,180 bytes), not C=32
    assert plans.rwkv_viability(512, 128, 128, train=True)("chunked_scan")
    assert wkv6_k.choose_blocks(512, 128, 128, mode="bwd").chunk == 16
    assert wkv6_k.working_set_bytes(512, 128, 128, 16, mode="bwd") == \
        210_180
    assert 210_180 <= factorization.H100_SMEM_PER_BLOCK
    past = plans.rwkv_viability(512, 192, 192, train=True)
    assert not past("chunked_scan") and past("chunked_xla") \
        and past("stepwise")
    # 192 x 192 heads: the forward fits a chunk (C=8), the backward none
    # (its state and state cotangent alone are 296,448 bytes)
    assert plans.rwkv_viability(512, 192, 192)("chunked_scan")
    assert wkv6_k.choose_blocks(512, 192, 192) == wkv6_k.WkvBlocks(8, 1)


def test_training_on_the_card_raises_past_the_budget():
    """Past the backward's budget a CUDA training call raises naming the
    working set (no plain version stands in for K6b there); the CPU routes
    to ``chunked_xla``."""
    with pytest.raises(ValueError, match="working set of the bwd kernel"):
        plans._rwkv_scan_blocks(512, 192, 192, 32, torch.device("cuda"),
                                train=True)
    assert plans._rwkv_scan_blocks(512, 192, 192, 32, torch.device("cpu"),
                                   train=True) is None
    assert plans._rwkv_scan_blocks(512, 192, 192, 32,
                                   torch.device("cuda")) is not None
