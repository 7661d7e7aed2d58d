"""Attention training's kernels (K8t and K8b, ``kernels/flash_prefill.py``)
on the CPU: their plain versions (what ``flash_prefill_traj`` and
``flash_prefill_bwd`` run for CPU tensors, and what the kernels are held
to on the card) against the JAX package, and the autograd Function that
pairs them.

K8t's plain version gives ``flash_prefill_plain``'s output bit for bit and
each row's log-sum-exp, held against JAX's ``logsumexp`` of the scores of
``ref.prefill_attn``.  K8b's plain version is held against ``jax.vjp`` of
the JAX model's ``flash_attention`` (what the JAX trainer differentiates)
and of the oracle ``ref.prefill_attn``, on tests/test_flash_prefill.py's
sweep cases plus ragged S, GQA groups 1, 2 and 4, head widths 16, 32 and
64, windows 0 and 16, f32 and bf16, at the default tiles and at small
ones; with ``round_p=True`` (the tensor-core instance's rounding of p and
ds, and its head-order sum of the GQA partials) in bf16 too, while the
default keeps its bits.  ``torch.autograd.gradcheck`` runs the Function in
float64.  Beside them: K8b's budget tables and the wrappers' raises.  The kernels run on
the card only (chip_smoke.py, A6), and under the g++ mock
(tests/test_torch_kernels_mock.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402

from repro_torch.core import factorization  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

#: the same f32 sums in two frameworks
F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: tests/test_flash_prefill.py's bf16 tolerance (3e-2), the atol scaled by
#: max|grad| (a gradient's scale is the inputs'): both sides sum in f32
#: and round each gradient once, but K8b's D = rowsum(dO o) reads the
#: forward's bf16 output, where JAX differentiates through its f32 sums
#: before the cast
BF16_TOL = 3e-2

CASES = [
    # tests/test_flash_prefill.py::test_flash_prefill_sweep
    (2, 64, 4, 2, 32, 0), (1, 128, 8, 8, 16, 0), (2, 96, 4, 1, 32, 24),
    (1, 60, 2, 2, 16, 0), (1, 60, 2, 2, 16, 20),
    # ragged S, groups 1/2/4, dh 16/32/64, windows 0 and 16
    (1, 37, 4, 1, 64, 16), (2, 50, 8, 2, 16, 0), (1, 45, 2, 2, 32, 16),
    (1, 29, 4, 4, 64, 0)]


def _arrays(B, S, Hq, Hkv, dh, seed):
    """q, k, v and an output cotangent, f32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh), (B, S, Hq, dh))]


def _hold(got, want, dtype):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        m = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=BF16_TOL,
                                   atol=BF16_TOL * m)


# ---------------------------------------------------------------------------
# K8t: the output and the rows' log-sum-exp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,Hq,Hkv,dh,w", CASES)
def test_traj_plain_is_plain_and_its_lse_is_jax_logsumexp(B, S, Hq, Hkv, dh,
                                                          w):
    q, k, v, _ = _arrays(B, S, Hq, Hkv, dh, seed=S + Hq + w)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want_lse = want_o = None
    for qb, kb in ((fp.MAX_Q_BLOCK, fp.MAX_K_BLOCK), (16, 8)):
        o, lse = fp.flash_prefill_traj_plain(tq, tk, tv, window=w,
                                             q_block=qb, k_block=kb)
        assert torch.equal(o, fp.flash_prefill_plain(
            tq, tk, tv, window=w, q_block=qb, k_block=kb))
        assert lse.dtype == torch.float32 and lse.shape == (B, Hq, S)
        if want_lse is None:
            want_lse, want_o = _jax_lse_and_out(q, k, v, w)
        np.testing.assert_allclose(lse.numpy(), want_lse, **F32_TOL)
        np.testing.assert_allclose(o.numpy(), want_o, rtol=2e-4, atol=2e-4)


def _jax_lse_and_out(q, k, v, w):
    """JAX's logsumexp of ``ref.prefill_attn``'s scores (scaled q.k,
    masked to -inf) and that oracle's output."""
    Hq, dh = q.shape[2], q.shape[3]

    @jax.jit
    def f(q, k, v):
        kr = jnp.repeat(k, Hq // k.shape[2], axis=2)
        s = jnp.einsum("bqhd,bkhd->bhqk", q, kr) * dh ** -0.5
        pos = jnp.arange(q.shape[1])
        mask = pos[:, None] >= pos[None, :]
        if w:
            mask &= (pos[:, None] - pos[None, :]) < w
        return (jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1),
                jax_ref.prefill_attn(q, k, v, window=w))
    return [np.asarray(a) for a in f(*(jnp.asarray(a) for a in (q, k, v)))]


def test_traj_plain_round_p_keeps_the_round_p_output():
    q, k, v, _ = _arrays(2, 70, 4, 2, 64, seed=3)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    o, lse = fp.flash_prefill_traj_plain(*t, q_block=64, k_block=32,
                                         round_p=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(o, fp.flash_prefill_plain(*t, q_block=64, k_block=32,
                                                 round_p=True))


# ---------------------------------------------------------------------------
# K8b: the backward against JAX's autodiff
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,dh,w", CASES)
def test_bwd_plain_matches_jax_vjp(B, S, Hq, Hkv, dh, w, dtype):
    """dq, dk, dv of ``flash_prefill_bwd_plain`` (on K8t's plain o and
    lse) against ``jax.vjp`` of JAX's ``flash_attention`` and of
    ``ref.prefill_attn``, at the table's tiles and at small ones (dQ rows
    8, dK/dV rows 8, tiles of 4: many tiles, ragged ends)."""
    arrays = _arrays(B, S, Hq, Hkv, dh, seed=S + Hq + w + 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in arrays)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in arrays)
    o, lse = fp.flash_prefill_traj_plain(tq, tk, tv, window=w)
    wants = []
    for fn in (lambda q, k, v: jax_attention.flash_attention(q, k, v,
                                                             window=w),
               lambda q, k, v: jax_ref.prefill_attn(q, k, v, window=w)):
        vjp = jax.jit(lambda q, k, v, do, fn=fn: jax.vjp(fn, q, k, v)[1](do))
        wants.append(vjp(jq, jk, jv, jdo))
    for blocks in (None, fp.BwdBlocks(8, 8, 4)):
        got = fp.flash_prefill_bwd_plain(tq, tk, tv, o, lse, tdo, window=w,
                                         blocks=blocks)
        for g, t in zip(got, (tq, tk, tv)):
            assert g.dtype == tdt and g.shape == t.shape
        for want in wants:
            for g, jw in zip(got, want):
                _hold(g, jw, dtype)


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,w", CASES)
def test_bwd_plain_round_p_matches_jax_vjp_in_bf16(B, S, Hq, Hkv, dh, w):
    """The tensor-core instance's rounding (``round_p=True``: p and ds in
    bf16 before the products that take them, the GQA partials summed in
    head order) against ``jax.vjp`` of JAX's ``flash_attention`` in bf16,
    at the table's tiles, within ``_hold``'s bf16 tolerance."""
    arrays = _arrays(B, S, Hq, Hkv, dh, seed=S + Hq + w + 2)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in arrays)
    o, lse = fp.flash_prefill_traj_plain(tq, tk, tv, window=w, q_block=64,
                                         k_block=64, round_p=True)
    want = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda q_, k_, v_: jax_attention.flash_attention(q_, k_, v_,
                                                         window=w),
        q, k, v)[1](do))(jq, jk, jv, jdo)
    got = fp.flash_prefill_bwd_plain(tq, tk, tv, o, lse, tdo, window=w,
                                     round_p=True)
    for g, t, jw in zip(got, (tq, tk, tv), want):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        _hold(g, jw, "bfloat16")


def _bwd_plain_unrounded(q, k, v, o, lse, dout, window, scale, bl):
    """The plain backward with no rounding flag: the default
    (``round_p=False``, the SIMT instance's yardstick) must keep its
    bits."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    ct = torch.float32
    q5 = q.to(ct).reshape(B, S, Hkv, g, dh)
    do5 = dout.to(ct).reshape(B, S, Hkv, g, dh)
    k32, v32 = k.to(ct), v.to(ct)
    lse4 = lse.to(ct).reshape(B, Hkv, g, S)
    d4 = (do5 * o.to(ct).reshape(B, S, Hkv, g, dh)).sum(-1) \
        .permute(0, 2, 3, 1)
    pos = torch.arange(S)

    def probs(q0, n, k0, m):
        qs, ks = slice(q0, q0 + n), slice(k0, k0 + m)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q5[:, qs], k32[:, ks])
        mask = fp._mask(pos[qs], pos[ks], window)
        p = torch.where(mask, torch.exp(s * scale - lse4[..., qs, None]),
                        0.0)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", do5[:, qs], v32[:, ks])
        return p, p * (dp - d4[..., qs, None])

    dq = torch.empty(B, S, Hkv, g, dh, dtype=ct)
    for q0 in range(0, S, bl.dq_rows):
        n = min(bl.dq_rows, S - q0)
        acc = torch.zeros(B, Hkv, g, n, dh, dtype=ct)
        for kt in fp.live_tiles(q0, bl.dq_rows, bl.tile, S, window):
            k0 = kt * bl.tile
            _, ds = probs(q0, n, k0, min(bl.tile, S - k0))
            acc += torch.einsum("bhgqk,bkhd->bhgqd", ds,
                                k32[:, k0:k0 + bl.tile])
        dq[:, q0:q0 + n] = (acc * scale).permute(0, 3, 1, 2, 4)
    dk = torch.empty(B, S, Hkv, dh, dtype=ct)
    dv = torch.empty_like(dk)
    for k0 in range(0, S, bl.dkv_rows):
        m = min(bl.dkv_rows, S - k0)
        acc_k = torch.zeros(B, Hkv, m, dh, dtype=ct)
        acc_v = torch.zeros_like(acc_k)
        for qt in fp.live_q_tiles(k0, bl.dkv_rows, bl.tile, S, window):
            q0 = qt * bl.tile
            n = min(bl.tile, S - q0)
            p, ds = probs(q0, n, k0, m)
            qs = slice(q0, q0 + n)
            acc_v += torch.einsum("bhgqk,bqhgd->bhkd", p, do5[:, qs])
            acc_k += torch.einsum("bhgqk,bqhgd->bhkd", ds, q5[:, qs])
        dk[:, k0:k0 + m] = (acc_k * scale).transpose(1, 2)
        dv[:, k0:k0 + m] = acc_v.transpose(1, 2)
    return (dq.reshape(B, S, Hq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,dh,w", CASES[:5])
def test_bwd_plain_default_keeps_its_bits(B, S, Hq, Hkv, dh, w, dtype):
    """``round_p=False`` (the default, the SIMT instance's yardstick)
    gives the bits of the plain backward written without the flag."""
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in _arrays(
        B, S, Hq, Hkv, dh, seed=S + w + 3))
    o, lse = fp.flash_prefill_traj_plain(tq, tk, tv, window=w)
    bl = fp.BwdBlocks(16, 8, 8)
    got = fp.flash_prefill_bwd_plain(tq, tk, tv, o, lse, tdo, window=w,
                                     blocks=bl, round_p=False)
    want = _bwd_plain_unrounded(tq, tk, tv, o, lse, tdo, w, dh ** -0.5, bl)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("Hq,Hkv", [(7, 1), (3, 3)])
def test_round_p_sums_the_heads_partials_in_head_order(Hq, Hkv,
                                                       monkeypatch):
    """With ``round_p`` each dK/dV tile's dk and dv are per-query-head
    partials added in head order 0 ... g - 1 (``head_order_sum``, what
    the kernel's reduction does): a group of 7 (Qwen2's) and of 1.  Each
    partial is that head's own backward (the head alone over the same k
    and v), and dk and dv are the recorded sums, bit for bit."""
    B, S, dh, w = 1, 40, 16, 0
    bl = fp.BwdBlocks(8, 16, 8)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in _arrays(
        B, S, Hq, Hkv, dh, seed=Hq))
    o, lse = fp.flash_prefill_traj_plain(tq, tk, tv, window=w)
    sums = []
    real = fp.head_order_sum

    def recording(parts):
        out = real(parts)
        want = parts[:, :, 0]
        for i in range(1, parts.shape[2]):
            want = want + parts[:, :, i]
        assert torch.equal(out, want)
        sums.append((parts, out))
        return out
    monkeypatch.setattr(fp, "head_order_sum", recording)
    _, dk, dv = fp.flash_prefill_bwd_plain(tq, tk, tv, o, lse, tdo,
                                           window=w, blocks=bl, round_p=True)
    monkeypatch.undo()
    g = Hq // Hkv
    assert len(sums) == 2 * -(-S // bl.dkv_rows)   # dk's and dv's a tile
    assert all(parts.shape[2] == g for parts, _ in sums)
    # (dk, dv) sums of each key tile, in order: the outputs are them
    got_k = torch.cat([out for _, out in sums[0::2]], dim=2)
    got_v = torch.cat([out for _, out in sums[1::2]], dim=2)
    assert torch.equal(dk, (got_k * dh ** -0.5).transpose(1, 2))
    assert torch.equal(dv, got_v.transpose(1, 2))
    # with one kv head, each partial is its query head's backward alone
    for i in range(g if Hkv == 1 else 0):
        h = slice(i, i + 1)
        _, dk_i, dv_i = fp.flash_prefill_bwd_plain(
            tq[:, :, h], tk, tv, o[:, :, h], lse[:, h], tdo[:, :, h],
            window=w, blocks=bl, round_p=True)
        for sel, want, mul in ((sums[0::2], dk_i, dh ** -0.5),
                               (sums[1::2], dv_i, 1.0)):
            part = torch.cat([parts[:, :, i] for parts, _ in sel], dim=2)
            torch.testing.assert_close(want, part.transpose(1, 2) * mul,
                                       **F32_TOL)


@pytest.mark.parametrize("w", [0, 5])
def test_function_passes_gradcheck_in_float64(w):
    """``flash_prefill`` under autograd (``_FlashPrefillFn``: the plain K8t
    forward and the plain K8b backward on the CPU) against finite
    differences, in float64, at a ragged S: three kv tiles of the
    forward, two dK/dV blocks of the backward."""
    g = torch.Generator().manual_seed(w)
    q = torch.randn(1, 18, 2, 16, generator=g, dtype=torch.float64)
    k = torch.randn(1, 18, 1, 16, generator=g, dtype=torch.float64)
    v = torch.randn(1, 18, 1, 16, generator=g, dtype=torch.float64)
    for t in (q, k, v):
        t.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: ops.flash_prefill(q_, k_, v_, window=w,
                                             q_block=16, k_block=8),
        (q, k, v), eps=1e-6, atol=1e-7, rtol=1e-5)


def test_function_saves_the_forward_and_runs_the_backward_once(monkeypatch):
    """Under autograd ``flash_prefill`` runs K8t once forward and K8b once
    backward (the plain versions on the CPU), K8 never; its gradients are
    autograd's of the plain version."""
    calls = []
    for name in ("flash_prefill_traj", "flash_prefill_bwd",
                 "flash_prefill_plain"):
        fn = getattr(fp, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(fp, name, counted)
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(2, 40, 4, 2, 32, 9))
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fp.flash_prefill(*x, window=16), x, do)
    assert calls == ["flash_prefill_traj", "flash_prefill_bwd"]
    y = [t.clone().requires_grad_() for t in (q, k, v)]
    monkeypatch.undo()
    want = torch.autograd.grad(fp.flash_prefill_plain(*y, window=16), y, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **F32_TOL)
    with torch.no_grad():
        out = fp.flash_prefill(*x, window=16)
    assert torch.equal(out, fp.flash_prefill_plain(q, k, v, window=16))


# ---------------------------------------------------------------------------
# K8b's budget table and tiles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", fp.HEAD_DIMS)
def test_bwd_budget_table_at_every_head_width(dh, dtype):
    """Each kernel's working set priced term by term.  f32 (SIMT): two
    owned and two streamed rows of dh floats plus 16 bytes, and for dK/dV
    the streamed rows' lse and D; the chosen tile the coarsest that leaves
    two blocks of both kernels on an SM.  bf16 (tensor cores): the
    swizzle's 1,024-byte alignment slack, the owned tiles (q and dO of 64
    rows; k and v of the block's keys), two stages of two streamed (64,
    padded dh) tiles and, for dK/dV, their rows' lse and D, and five
    barriers; 64-row tiles whatever the sequence."""
    if dtype == torch.bfloat16:
        dhp = fp.padded_head_dim(dh)
        assert fp.bwd_working_set_bytes(64, 64, dh, dtype, True) == (
            1024 + 2 * 64 * dhp * 2 + 2 * (2 * 64 * dhp * 2) + 5 * 8)
        assert fp.bwd_working_set_bytes(64, 64, dh, dtype, False) == (
            1024 + 2 * 64 * dhp * 2 + 2 * (2 * 64 * dhp * 2 + 2 * 4 * 64)
            + 5 * 8)
        bl = fp.choose_bwd_blocks(512, dh, dtype)
        assert bl == (64, 64, 64)
        assert fp.choose_bwd_blocks(37, dh, dtype) == bl
        for rows, dq in ((64, True), (64, False)):
            smem = fp.bwd_working_set_bytes(rows, 64, dh, dtype, dq)
            assert smem <= factorization.H100_SMEM_PER_BLOCK
            assert smem % 8 == 0
        return
    row = dh * 4 + 16
    assert fp.bwd_working_set_bytes(32, 64, dh, dtype, True) == (
        (2 * 32 + 2 * 64) * row)
    assert fp.bwd_working_set_bytes(16, 64, dh, dtype, False) == (
        (2 * 16 + 2 * 64) * row + 8 * 64)
    bl = fp.choose_bwd_blocks(512, dh, dtype)
    assert (bl.dq_rows, bl.dkv_rows) == (fp.BWD_DQ_ROWS, fp.BWD_DKV_ROWS)

    def fits(tile):
        return all(factorization.blocks_per_sm(fp.bwd_working_set_bytes(
            r, tile, dh, dtype, dq)) >= fp.BWD_MIN_BLOCKS_PER_SM
            for r, dq in ((32, True), (16, False)))
    assert fits(bl.tile)
    assert all(not fits(t) for t in fp.BWD_TILES if t > bl.tile)
    for smem in (fp.bwd_working_set_bytes(32, bl.tile, dh, dtype, True),
                 fp.bwd_working_set_bytes(16, bl.tile, dh, dtype, False)):
        assert smem <= factorization.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("S,dh,dtype,want", [
    (512, 64, torch.bfloat16, (64, 64, 64)),   # Qwen2's training shape
    (512, 128, torch.bfloat16, (64, 64, 64)),  # OLMoE's, Yi's
    (512, 160, torch.float32, (32, 16, 32)),   # f32 at 160: 64 fits once
    (20, 64, torch.float32, (32, 16, 32)),     # no tile past S's need
    (1, 16, torch.bfloat16, (64, 64, 64)),     # bf16 tiles whatever S
    (512, 48, torch.float32, None),            # no instance
    (512, 64, torch.float16, None)])
def test_choose_bwd_blocks_at_the_edges(S, dh, dtype, want):
    got = fp.choose_bwd_blocks(S, dh, dtype)
    assert (tuple(got) if got else None) == want


def test_live_q_tiles_cover_every_query_that_sees_the_keys():
    """A dK/dV block reads exactly the q tiles holding a query that sees
    one of its keys (causal, and within the window)."""
    for S, rows, tile, w in ((50, 16, 8, 0), (64, 8, 16, 5), (37, 16, 4, 16),
                             (100, 16, 64, 30)):
        for k0 in range(0, S, rows):
            keys = range(k0, min(k0 + rows, S))
            need = {qp // tile for qp in range(S) for kp in keys
                    if kp <= qp and (w == 0 or qp - kp < w)}
            got = set(fp.live_q_tiles(k0, rows, tile, S, w))
            assert need <= got
            assert all(t * tile < S for t in got)
            # no tile before the keys, none past the window
            assert min(got) == k0 // tile
            if w:
                assert max(got) == min(S - 1, k0 + rows - 2 + w) // tile


# ---------------------------------------------------------------------------
# the wrappers' raises
# ---------------------------------------------------------------------------
def test_bwd_wrapper_rejects_mismatched_shapes():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(1, 20, 4, 2, 16, 1))
    o, lse = fp.flash_prefill_traj(q, k, v)
    with pytest.raises(ValueError, match="shaped as q"):
        fp.flash_prefill_bwd(q, k, v, o[:, :10], lse, do)
    with pytest.raises(ValueError, match="shaped as q"):
        fp.flash_prefill_bwd(q, k, v, o, lse[:, :, :10], do)
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        fp.flash_prefill_bwd(q, k[:, :, :1].expand(1, 20, 3, 16), v, o, lse,
                             do)


@pytest.mark.parametrize("name", ["flash_prefill_traj", "flash_prefill_bwd"])
def test_wrappers_raise_off_the_cpu_and_the_card(name, monkeypatch):
    """A tensor off the CPU reaches no plain version: on ``meta`` (an
    abstract trace, the dry run) the wrappers count the call and give
    their outputs' shapes and dtypes, computing nothing; on the card they
    launch or raise."""
    from repro_torch import kernels

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on meta tensors")
    for plain in ("flash_prefill_traj_plain", "flash_prefill_bwd_plain"):
        monkeypatch.setattr(fp, plain, refuse)
    q = torch.empty(1, 8, 2, 16, device="meta")
    k = torch.empty(1, 8, 1, 16, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    args = (q, k, k) if name == "flash_prefill_traj" else (
        q, k, k, q, lse, q)
    calls = kernels.CALLS[name]
    out = getattr(fp, name)(*args)
    want = [q, lse] if name == "flash_prefill_traj" else [q, k, k]
    assert [(t.device.type, t.shape, t.dtype) for t in out] == \
        [("meta", w.shape, w.dtype) for w in want]
    assert kernels.CALLS[name] == calls + 1
