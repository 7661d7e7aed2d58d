"""The LSTM main path in bf16 on the CPU, against the JAX package.

The plain versions of K1 (``lstm_cell``), K2 and K2t (``lstm_seq``, its
trajectory launch), K3 (``lstm_seq_bwd``) and the int8 stack over bf16 x
against the JAX package's Pallas kernels in interpret mode, forward and
``jax.vjp``, on the same numpy-seeded bf16 inputs: each bf16 result within
one bf16 step (2^-7 of its largest entry), the f32 trajectories at 2e-5.
The five plans in bf16 against JAX's ``sequential`` at ``LSTM_TOL`` (the
int8 plan at ``Q8_BAND``) and their gradients against the same JAX plan's
at ``LSTM_GRAD_TOL``, on JAX's three lstm cases.  The bf16 budget table
term by term (2 x 64 serves in one block, trains in none), the scheduler's
``ProcLoadSensor`` and bounded decision history, and the entry points and
the quickstart in bf16 on the CPU."""
import dataclasses
import os
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import lstm as jax_lstm  # noqa: E402
from repro.core import plans as jax_plans  # noqa: E402
from repro.core import scheduler as jax_scheduler  # noqa: E402
from repro.kernels import lstm_cell as jax_cell  # noqa: E402
from repro.kernels import lstm_seq as jax_seq  # noqa: E402
from repro.kernels import lstm_seq_bwd as jax_bwd  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.mobirnn_lstm import LSTMConfig  # noqa: E402
from repro_torch.core import (factorization, lstm, plans,  # noqa: E402
                              scheduler)
from repro_torch.kernels import lstm_cell as cell_k  # noqa: E402
from repro_torch.kernels import lstm_seq as seq_k  # noqa: E402
from repro_torch.kernels import lstm_seq_bwd as bwd_k  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import classify, train_har  # noqa: E402

BF16 = torch.bfloat16
#: K2t's f32 trajectories against JAX's
TRAJ_TOL = dict(rtol=2e-5, atol=2e-5)
REPO = Path(__file__).resolve().parents[1]


def _bf16(*arrays):
    """numpy f32 arrays rounded to bf16, as (port tensors, JAX arrays):
    the same bits on both sides."""
    nps = [np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)
           for a in arrays]
    return ([convert.params_from_numpy(a) for a in nps],
            [jnp.asarray(a) for a in nps])


def _np(t) -> np.ndarray:
    """A port tensor or a JAX array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _one_step(got, want, what: str) -> None:
    """Each bf16 output within one bf16 step of the JAX one's largest
    entry, in the same dtype."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype).endswith("bfloat16"), (what, i, g.dtype)
        assert str(w.dtype).endswith("bfloat16"), (what, i, w.dtype)
        e = float(np.abs(_np(g) - _np(w)).max())
        m = float(np.abs(_np(w)).max())
        assert e <= 2.0 ** -7 * m, (what, i, e, m)


def _operands(seed, L, H, D, B, T):
    """numpy stacked weights (L, P+H, 4H), bias, padded input and final
    state cotangents, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    P = max(D, H)
    w = rng.standard_normal((L, P + H, 4 * H)) * (P + H) ** -0.5
    w[0, D:P] = 0.0
    if P > H:
        w[1:, H:P] = 0.0
    b = rng.standard_normal((L, 4 * H)) * 0.1
    x = np.zeros((B, T, P))
    x[..., :D] = rng.standard_normal((B, T, D))
    return w, b, x, rng.standard_normal((L, B, H)), \
        rng.standard_normal((L, B, H))


#: (L, H, D, B, T): two layers, H 16 to 48, T <= 16, a batch that tile 2
#: leaves a tail of
SHAPES = {"h16d9": (2, 16, 9, 5, 11), "h48": (2, 48, 48, 3, 16),
          "h33d40": (2, 33, 40, 5, 7)}


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,D,H", [(5, 9, 16), (3, 48, 48)])
def test_k1_plain_bf16_matches_pallas_forward_and_vjp(B, D, H):
    rng = np.random.default_rng(B + D + H)
    ops, jops = _bf16(rng.standard_normal((D + H, 4 * H)) * (D + H) ** -0.5,
                      rng.standard_normal(4 * H) * 0.1,
                      rng.standard_normal((B, D)), rng.standard_normal((B, H)),
                      rng.standard_normal((B, H)))
    (dc, dh), (jdc, jdh) = _bf16(rng.standard_normal((B, H)),
                                 rng.standard_normal((B, H)))
    want, vjp = jax.vjp(lambda *a: jax_cell.lstm_cell(
        *a, block_b=2, block_h=16, interpret=True), *jops)
    ins = [t.clone().requires_grad_() for t in ops]
    got = cell_k.lstm_cell(*ins)
    _one_step(got, want, "K1 forward")
    # the CPU path is the plain version, bit for bit
    plain = cell_k.lstm_cell_plain(*ops)
    assert all(torch.equal(g.detach(), p) for g, p in zip(got, plain))
    grads = torch.autograd.grad(got, ins, (dc, dh))
    _one_step(grads, vjp((jdc, jdh)), "K1 vjp")


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_k2_and_k2t_plain_bf16_match_pallas(shape):
    w, b, x, _, _ = _operands(1, *shape)
    (wt, bt, xt), (jw, jb, jx) = _bf16(w, b, x)
    got = seq_k.lstm_seq(wt, bt, xt)
    _one_step(got, jax_seq.lstm_seq(jw, jb, jx, block_b=2, interpret=True),
              "K2")
    traj = seq_k.lstm_seq_traj(wt, bt, xt)
    want = jax_seq._lstm_seq_traj_call(jw, jb, jx, 2, True)
    _one_step(traj[:2], want[:2], "K2t (c, h)")
    for g, r in zip(traj[2:], want[2:]):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32
        np.testing.assert_allclose(_np(g), _np(r), **TRAJ_TOL)
    assert torch.equal(traj[0], got[0]) and torch.equal(traj[1], got[1])


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_k3_plain_bf16_matches_pallas(shape):
    """The backward's plain version on K2t's f32 trajectories: dw, db and
    dx come back in bf16, within one bf16 step of JAX's Pallas backward on
    the same trajectories."""
    w, b, x, dc, dh = _operands(2, *shape)
    (wt, bt, xt, dct, dht), jops = _bf16(w, b, x, dc, dh)
    _, _, ct, ht = ref.lstm_seq_traj(wt, bt, xt)
    got = bwd_k.lstm_seq_bwd(wt, bt, xt, ct, ht, dct, dht, block_b=2)
    jw, jb, jx, jdc, jdh = jops
    want = jax_bwd.lstm_seq_bwd(jw, jb, jx, jnp.asarray(ct.numpy()),
                                jnp.asarray(ht.numpy()), jdc, jdh,
                                block_b=2, interpret=True)
    _one_step(got, want, "K3")


@pytest.mark.parametrize("shape", [SHAPES["h16d9"], SHAPES["h33d40"]],
                         ids=["h16d9", "h33d40"])
def test_lstm_seq_bf16_vjp_matches_jax(shape):
    """torch autograd through the port's ``lstm_seq`` in bf16 (the
    trajectory forward and the backward's plain version) against
    ``jax.vjp`` of JAX's (its Pallas forward and backward): gradients in
    bf16, within one bf16 step."""
    w, b, x, dc, dh = _operands(3, *shape)
    (wt, bt, xt, dct, dht), (jw, jb, jx, jdc, jdh) = _bf16(w, b, x, dc, dh)
    ins = [t.clone().requires_grad_() for t in (wt, bt, xt)]
    got = torch.autograd.grad(seq_k.lstm_seq(*ins), ins, (dct, dht))
    _, vjp = jax.vjp(lambda *a: jax_seq.lstm_seq(
        *a, bwd_block_b=2, interpret=True), jw, jb, jx)
    _one_step(got, vjp((jdc, jdh)), "lstm_seq vjp")


@pytest.mark.parametrize("shape", [SHAPES["h16d9"], SHAPES["h48"]],
                         ids=["h16d9", "h48"])
def test_int8_stack_over_bf16_x_matches_pallas(shape):
    """The int8 instances over bf16 x (the q8 plan of a bf16 model; JAX
    feeds bf16 x to its q8 kernel): the forward's (c, h) in bf16 within one
    step, its f32 trajectories at 2e-5, and the q8 backward's bf16 dx
    within one step and f32 dw, db at LSTM_GRAD_TOL, against JAX's q8
    kernels and custom VJP in interpret mode."""
    w, b, x, dc, dh = _operands(4, *shape)
    (xt, dct, dht), (jx, jdc, jdh) = _bf16(x, dc, dh)
    wt, bt = (torch.tensor(a, dtype=torch.float32) for a in (w, b))
    jw, jb = jnp.asarray(wt.numpy()), jnp.asarray(bt.numpy())
    _one_step(seq_k.lstm_seq_q8(wt, bt, xt),
              jax_seq.lstm_seq_q8(jw, jb, jx, block_b=2, interpret=True),
              "K5 bf16 x")
    wq, s = ref.quantize_q8(wt)
    traj = seq_k.lstm_seq_q8_traj(wq, s, bt, xt)
    want = jax_seq._lstm_seq_traj_call(jnp.asarray(wq.numpy()), jb, jx, 2,
                                       True, scales=jnp.asarray(s.numpy()))
    _one_step(traj[:2], want[:2], "K2t-q8 bf16 x (c, h)")
    for g, r in zip(traj[2:], want[2:]):
        np.testing.assert_allclose(_np(g), _np(r), **TRAJ_TOL)
    got = bwd_k.lstm_seq_bwd_q8(wq, s, bt, xt, *traj[2:], dct, dht,
                                block_b=2)
    want = jax_bwd.lstm_seq_bwd(
        jnp.asarray(wq.numpy()), jb, jx, jnp.asarray(traj[2].numpy()),
        jnp.asarray(traj[3].numpy()), jdc, jdh, block_b=2, interpret=True,
        scales=jnp.asarray(s.numpy()))
    assert got[0].dtype == got[1].dtype == torch.float32
    for g, r in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), _np(r),
                                   **plans.LSTM_GRAD_TOL["float32"])
    _one_step(got[2:], want[2:], "K3-q8 bf16 x dx")
    # and under autograd: the f32 master's dw and db, a bf16 dx
    ins = [wt.clone().requires_grad_(), bt.clone().requires_grad_(),
           xt.clone().requires_grad_()]
    grads = torch.autograd.grad(seq_k.lstm_seq_q8(*ins), ins, (dct, dht))
    _, vjp = jax.vjp(lambda *a: jax_seq.lstm_seq_q8(
        *a, bwd_block_b=2, interpret=True), jw, jb, jx)
    jg = vjp((jdc, jdh))
    for g, r in zip(grads[:2], jg[:2]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(r),
                                   **plans.LSTM_GRAD_TOL["float32"])
    _one_step(grads[2:], jg[2:], "lstm_seq_q8 vjp dx")


# ---------------------------------------------------------------------------
# the five plans in bf16 against the JAX package on its cases
# ---------------------------------------------------------------------------
JAX_FAMILY = jax_plans.get_family("lstm")


def _bf16_inputs(case):
    """JAX's bf16 inputs for ``case`` and the port's copy, bit for bit."""
    jcfg, jparams, x, labels = JAX_FAMILY.make_inputs(case, "bfloat16")
    b, t, h, d, n_layers = case.shape
    cfg = dataclasses.replace(LSTMConfig(), hidden=h, input_dim=d,
                              n_layers=n_layers, seq_len=t, dtype="bfloat16")
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, split(jparams)[0]))
    return (jcfg, jparams, x, labels), (
        cfg, params, convert.params_from_numpy(np.asarray(x)),
        torch.from_numpy(np.array(labels)).long())


def _plan_tol(plan: str, grad: bool = False) -> dict:
    if plan == "fused_seq_q8" and not grad:
        return plans.Q8_BAND
    return (plans.LSTM_GRAD_TOL if grad else plans.LSTM_TOL)["bfloat16"]


@pytest.mark.parametrize("case", JAX_FAMILY.cases,
                         ids=[c.label for c in JAX_FAMILY.cases])
@pytest.mark.parametrize("plan", list(lstm.FORWARD_PLANS))
def test_port_plans_in_bf16_match_jax_sequential(plan, case):
    (jcfg, jparams, x, _), (cfg, params, xt, _) = _bf16_inputs(case)
    want = jax_lstm.forward_sequential(jparams, x, jcfg)
    got = lstm.FORWARD_PLANS[plan](params, xt, cfg)
    assert got.dtype == BF16 and got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **_plan_tol(plan))


@pytest.mark.parametrize("case", JAX_FAMILY.cases,
                         ids=[c.label for c in JAX_FAMILY.cases])
@pytest.mark.parametrize("plan", list(lstm.FORWARD_PLANS))
def test_port_plan_grads_in_bf16_match_the_jax_plan(plan, case):
    """``loss_fn``'s gradients through each port plan in bf16 against
    ``jax.grad`` through the same JAX plan (its Pallas kernels in
    interpret mode; the int8 plan's straight-through gradients too), leaf
    by leaf in the parameters' dtype, at LSTM_GRAD_TOL bf16."""
    (jcfg, jparams, x, labels), (cfg, params, xt, yt) = _bf16_inputs(case)
    want = jax.grad(jax_lstm.loss_fn)(
        jparams, x, labels, jcfg, forward=jax_lstm.FORWARD_PLANS[plan])
    got = plans.get_family("lstm").grads(plan, (cfg, params, xt, yt))
    for g, r in zip(jax.tree.leaves(convert.params_to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 split(want)[0]))):
        assert g.dtype == r.dtype == ml_dtypes.bfloat16
        np.testing.assert_allclose(g.astype(np.float32),
                                   r.astype(np.float32),
                                   **_plan_tol(plan, grad=True))


# ---------------------------------------------------------------------------
# the bf16 budget table
# ---------------------------------------------------------------------------
def test_bf16_budget_table_term_by_term_at_2x64():
    """The forward of a 2 x 64 bf16 stack at T=128, B=1: the shared-home
    stack at 2 bytes a weight, rows of ``row_stride(64, 2)`` = 256 + 16,
    the f32 h slots and the bf16 x ring -- 156,672 bytes, one block.  Its
    backward adds the f32 dW accumulators (264 KiB alone) and fits no one
    block, and the f32 stack's forward fits none either: both are split
    over two co-resident blocks."""
    T, L, P, H = 128, 2, 64, 64
    assert seq_k.row_stride(H, 2) == 272
    weights = L * (P + H) * 272 * 2
    h_slots = 2 * L * 1 * H * 4
    x_ring = T * P * 2
    assert seq_k.working_set_bytes(T, L, P, H, 1, dtype_bytes=2,
                                   w_dtype_bytes=2) == \
        weights + h_slots + x_ring == 156_672
    assert 156_672 <= factorization.H100_SMEM_PER_BLOCK
    assert seq_k.choose_batch_block(
        1, T, L, P, H, dtype_bytes=2, w_dtype_bytes=2) == \
        seq_k.SeqBlocks(1, None)
    assert seq_k.choose_batch_block(1, T, L, P, H, dtype_bytes=2,
                                    w_dtype_bytes=2, mode="bwd") == \
        seq_k.SeqBlocks(1, None, 2)
    assert seq_k.choose_batch_block(1, T, L, P, H) == \
        seq_k.SeqBlocks(1, None, 2)
    # 3 x 64 serves in one block too; 2 x 64 bf16 trains in one block at
    # no batch, split at every one
    assert seq_k.choose_batch_block(1, T, 3, P, H, dtype_bytes=2,
                                    w_dtype_bytes=2).n_blocks == 1
    assert seq_k.choose_batch_block(64, T, L, P, H, dtype_bytes=2,
                                    w_dtype_bytes=2, mode="bwd") == \
        seq_k.SeqBlocks(1, None, 2)


def test_bf16_register_home_prices_its_widened_chunk():
    """The paper's 2 x 32 at one row keeps its weights in registers; with
    bf16 x its layer 0 reads an f32 copy of the chunk in use, widened when
    the chunk arrives, beside the bf16 ring: h slots 512 + widened chunk
    128 x 32 x 4 + ring 128 x 32 x 2 bytes at T=128, whole; a 16-step
    chunk widens 16 rows beside a two-slot ring of 16."""
    assert seq_k.weight_home(2, 32, 32, 1) == "registers"
    assert seq_k.working_set_bytes(128, 2, 32, 32, 1, dtype_bytes=2,
                                   w_dtype_bytes=2) == \
        512 + 128 * 32 * 4 + 128 * 32 * 2 == 25_088
    assert seq_k.working_set_bytes(128, 2, 32, 32, 1, dtype_bytes=2,
                                   w_dtype_bytes=2, time_chunk=16) == \
        512 + 16 * 32 * 4 + 2 * 16 * 32 * 2
    # f32 x reads the ring itself; the shared home reads bf16 x in place
    assert seq_k.working_set_bytes(128, 2, 32, 32, 1) == \
        512 + 128 * 32 * 4
    assert seq_k.working_set_bytes(128, 2, 32, 32, 2, dtype_bytes=2,
                                   w_dtype_bytes=2) == \
        2 * 64 * 144 * 2 + 2 * 2 * 2 * 32 * 4 + 2 * 128 * 32 * 2


def test_bf16_backward_table_prices_what_the_kernel_widens():
    """The backward's shared home holds the bf16 stack at 2 bytes, and the
    bias and the x ring widened to f32 (4 bytes an element, whatever the
    input's dtype); every other term is f32 too."""
    args = (50, 2, 32, 32, 4)
    f32 = seq_k.working_set_bytes(*args, mode="bwd", time_chunk=5)
    b16 = seq_k.working_set_bytes(*args, dtype_bytes=2, w_dtype_bytes=2,
                                  mode="bwd", time_chunk=5)
    stack32 = 2 * 64 * seq_k.row_stride(32) * 4
    stack16 = 2 * 64 * seq_k.row_stride(32, 2) * 2
    assert seq_k.row_stride(32, 2) == 144
    assert f32 - b16 == stack32 - stack16
    # the register home (2 x 32, one row) is all f32 at either width
    assert seq_k.working_set_bytes(128, 2, 32, 32, 1, mode="bwd") == \
        seq_k.working_set_bytes(128, 2, 32, 32, 1, dtype_bytes=2,
                                w_dtype_bytes=2, mode="bwd")


@pytest.mark.parametrize("train", [False, True])
def test_plan_viability_prices_the_dtype(train):
    """``plan_viability(dtype_bytes=2, w_dtype_bytes=2)`` at 2 x 64: on
    the H100's budget both dtypes serve and train (bf16 serves in one
    block, the rest split over co-resident blocks); under a budget between
    the smallest bf16 block and the smallest f32 one (a split of 64 blocks
    of one unit each) the bf16 ``fused_seq`` is viable and the f32 one is
    not; ``seq_plan_names`` binds another scheduler name, as the JAX
    package's does."""
    cfg = LSTMConfig().with_complexity(64, 2)
    for budget in (None, "between"):
        if budget == "between":
            modes = ("fwd", "bwd") if train else ("fwd",)
            least = [min(max(seq_k.working_set_bytes(
                128, 2, 64, 64, 1, mode=m, n_blocks=g, **kw) for m in modes)
                for g in (2, 4, 8, 16, 32, 64))
                for kw in (dict(dtype_bytes=2, w_dtype_bytes=2), {})]
            assert least[0] < least[1]
            budget = sum(least) // 2
        bf16 = lstm.plan_viability(cfg, 1, 128, dtype_bytes=2,
                                   w_dtype_bytes=2, train=train,
                                   smem_budget=budget)
        f32 = lstm.plan_viability(cfg, 1, 128, train=train,
                                  smem_budget=budget)
        assert bf16("fused_seq")
        assert f32("fused_seq") is (budget is None)
        assert all(p("sequential") and p("fused_cell") for p in (bf16, f32))
    alias = lstm.plan_viability(cfg, 1, 128, seq_plan_names=("accel_seq",),
                                train=train, smem_budget=budget)
    assert not alias("accel_seq") and alias("fused_seq")


def test_bf16_wrappers_raise_on_what_no_instance_takes():
    w, b, x = (torch.zeros(2, 64, 128), torch.zeros(2, 128),
               torch.zeros(1, 4, 32))
    with pytest.raises(TypeError):
        seq_k.lstm_seq(w, b, x.to(BF16))          # f32 stack, bf16 x
    with pytest.raises(TypeError):
        seq_k.lstm_seq(w.to(BF16), b, x.to(BF16))  # f32 bias
    with pytest.raises(TypeError):
        cell_k.lstm_cell(torch.zeros(64, 128).to(BF16), torch.zeros(128),
                         torch.zeros(1, 32), torch.zeros(1, 32),
                         torch.zeros(1, 32))
    with pytest.raises(TypeError):
        seq_k.lstm_seq_q8(w.to(BF16), b, x.to(BF16))  # bf16 master


# ---------------------------------------------------------------------------
# the scheduler's remainder
# ---------------------------------------------------------------------------
def test_proc_load_sensor_reads_the_normalised_loadavg(monkeypatch):
    assert 0.0 <= scheduler.ProcLoadSensor().load() <= 1.0
    monkeypatch.setattr(os, "getloadavg", lambda: (6.0, 0.0, 0.0))
    assert scheduler.ProcLoadSensor(n_cpus=8).load() == 0.75
    assert scheduler.ProcLoadSensor(n_cpus=2).load() == 1.0

    def gone():
        raise OSError("no load average")
    monkeypatch.setattr(os, "getloadavg", gone)
    assert scheduler.ProcLoadSensor().load() == 0.0


def test_decisions_are_bounded_at_max_decisions():
    assert scheduler.Scheduler.MAX_DECISIONS == \
        jax_scheduler.Scheduler.MAX_DECISIONS == 4096
    sched = scheduler.Scheduler(scheduler.SyntheticLoadSensor(0.5))
    sched.register(scheduler.Plan("a", lambda: None, base_latency_s=1.0))
    sched.register(scheduler.Plan("b", lambda: None, base_latency_s=2.0,
                                  shared=False))
    for i in range(scheduler.Scheduler.MAX_DECISIONS + 7):
        last = sched.choose(load=(i % 10) / 10)
    assert len(sched.decisions) == scheduler.Scheduler.MAX_DECISIONS
    assert sched.decisions[-1] is last
    assert sched.decisions[0].load == (7 % 10) / 10


# ---------------------------------------------------------------------------
# the entry points and the quickstart in bf16, on the CPU
# ---------------------------------------------------------------------------
def test_classify_serves_a_bf16_config_in_its_dtype(capsys):
    cfg = dataclasses.replace(LSTMConfig(), dtype="bfloat16")
    out = classify.serve(cfg, torch.device("cpu"), requests=2,
                         plan="fused_seq")
    assert out["logits"].dtype == BF16 and out["logits"].shape == (2, 6)
    assert "bfloat16" in capsys.readouterr().out


def test_train_har_trains_a_bf16_config(capsys):
    cfg = dataclasses.replace(LSTMConfig(), dtype="bfloat16")
    out = train_har.train(cfg, torch.device("cpu"), plan="fused_seq",
                          steps=2, batch=8, n_train=32, n_test=8,
                          latency_cases=0)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert all(p.dtype == BF16 for p in out["params"]["head"].values())
    assert "bfloat16" in capsys.readouterr().out


def test_quickstart_torch_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["quickstart_torch.py", "--device",
                                     "cpu", "--steps", "2"])
    runpy.run_path(str(REPO / "examples" / "quickstart_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    for line in ("wavefront == sequential: True",
                 "fused_seq == sequential: True",
                 "fused_seq_q8 within int8 band: True",
                 "load=90%: dispatched to"):
        assert line in out, out
