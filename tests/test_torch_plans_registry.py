"""The port's plan registry (``repro_torch.core.plans``) against the JAX
package's (``repro.core.plans``): the LSTM, RWKV6 and Mamba families' plan
names, policies, tolerance tables, launch counts and cases, their sweeps,
and the port's plans swept over the JAX families' cases against the JAX
package's oracles (``sequential``, ``stepwise``, ``scan``) on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import lstm as jax_lstm  # noqa: E402
from repro.core import plans as jax_plans  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.mobirnn_lstm import LSTMConfig  # noqa: E402
from repro_torch.core import lstm, plans  # noqa: E402
from repro_torch.kernels import mamba_scan as ms_k  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_k  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

FAMILY = plans.get_family("lstm")
JAX_FAMILY = jax_plans.get_family("lstm")


def test_the_lstm_family_has_the_jax_plans_in_order():
    assert list(FAMILY.plans) == list(JAX_FAMILY.plans) == \
        list(lstm.FORWARD_PLANS)
    assert FAMILY.oracle == JAX_FAMILY.oracle == "sequential"
    assert FAMILY.dtypes == JAX_FAMILY.dtypes == ("float32", "bfloat16")
    for name, spec in FAMILY.plans.items():
        assert spec.name == name and spec.fn is lstm.FORWARD_PLANS[name]


def test_tolerance_tables_are_the_jax_ones():
    assert plans.LSTM_TOL == jax_plans.LSTM_TOL
    assert plans.LSTM_GRAD_TOL == jax_plans.LSTM_GRAD_TOL
    assert plans.Q8_BAND == jax_plans.Q8_BAND


@pytest.mark.parametrize("plan", list(lstm.FORWARD_PLANS))
def test_each_plan_has_the_jax_policy_and_launch_counts(plan):
    mine, theirs = FAMILY.plans[plan], JAX_FAMILY.plans[plan]
    assert mine.policy.kind == theirs.policy.kind
    assert mine.policy.tol["float32"] == theirs.policy.tol["float32"]
    assert mine.policy.tol == theirs.policy.tol
    assert mine.policy.grad_tol == theirs.policy.grad_tol
    assert (mine.fwd_launches, mine.train_launches) == \
        (theirs.fwd_dispatches, theirs.train_dispatches)
    assert FAMILY.grad_tol(plan, "float32") == \
        JAX_FAMILY.grad_tol(plan, "float32")


def test_cases_are_the_jax_cases():
    assert [tuple(c) for c in FAMILY.cases] == \
        [tuple(c) for c in JAX_FAMILY.cases]


def test_sweeps_are_the_jax_float32_sweeps():
    """The lstm sweeps' ids and ``heavy`` flags are JAX's, both dtypes
    (the bf16 rows included; the int8 plan's float32 only)."""
    def ids(sweep, family):
        return [(sc.id, sc.heavy) for sc in sweep if sc.family == family]
    assert ids(plans.value_sweep(), "lstm") == \
        ids(jax_plans.value_sweep(), "lstm")
    assert ids(plans.grad_sweep(), "lstm") == \
        ids(jax_plans.grad_sweep(), "lstm")
    assert {sc.dtype for sc in plans.value_sweep()
            if sc.family == "lstm"} == {"float32", "bfloat16"}
    assert all(sc.dtype == "float32" for sc in plans.value_sweep()
               if sc.plan == "fused_seq_q8")


def test_register_family_needs_its_oracle():
    bad = dataclasses.replace(FAMILY, name="bad", oracle="nope")
    with pytest.raises(ValueError):
        plans.register_family(bad)
    assert "bad" not in plans.FAMILIES


def test_scheduler_viability_binds_scheduler_names():
    wide = LSTMConfig().with_complexity(64, 2)
    pred = FAMILY.viability(wide, 1, 128)
    viable = plans.scheduler_viability({
        "accel_seq": ("fused_seq", pred),
        "accel_seq_q8": ("fused_seq_q8", pred)})
    assert not viable("accel_seq") and viable("accel_seq_q8")
    assert viable("cpu_fallback")


def _jax_inputs(case, dtype: str = "float32"):
    """The JAX family's inputs for ``case`` in ``dtype`` and the port's
    copy (bf16 leaves carried bit for bit)."""
    jcfg, jparams, x, labels = JAX_FAMILY.make_inputs(case, dtype)
    b, t, h, d, n_layers = case.shape
    cfg = dataclasses.replace(LSTMConfig(), hidden=h, input_dim=d,
                              n_layers=n_layers, seq_len=t, dtype=dtype)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, split(jparams)[0]))
    return (jcfg, jparams, x, labels), (
        cfg, params, convert.params_from_numpy(np.asarray(x)),
        torch.from_numpy(np.array(labels)).long())


@pytest.mark.parametrize("case", JAX_FAMILY.cases,
                         ids=[c.label for c in JAX_FAMILY.cases])
@pytest.mark.parametrize("plan", list(lstm.FORWARD_PLANS))
def test_port_plan_matches_jax_sequential_on_jax_cases(plan, case):
    (jcfg, jparams, x, _), (cfg, params, xt, _) = _jax_inputs(case)
    want = jax_lstm.forward_sequential(jparams, x, jcfg)
    got = lstm.FORWARD_PLANS[plan](params, xt, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **FAMILY.tol(plan, "float32")
                               if plan != FAMILY.oracle
                               else plans.LSTM_TOL["float32"])


LSTM_GRAD_SWEEP = [sc for sc in plans.grad_sweep() if sc.family == "lstm"]


@pytest.mark.parametrize("sc", LSTM_GRAD_SWEEP,
                         ids=[sc.id for sc in LSTM_GRAD_SWEEP])
def test_port_plan_grads_match_jax_sequential_on_jax_cases(sc):
    (jcfg, jparams, x, labels), (cfg, params, xt, yt) = _jax_inputs(
        sc.case, sc.dtype)
    want = jax.grad(jax_lstm.loss_fn)(jparams, x, labels, jcfg)
    got = FAMILY.grads(sc.plan, (cfg, params, xt, yt))
    tol = FAMILY.grad_tol(sc.plan, sc.dtype)
    for g, r in zip(jax.tree.leaves(convert.params_to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 split(want)[0]))):
        assert g.dtype == r.dtype
        np.testing.assert_allclose(g.astype(np.float32),
                                   r.astype(np.float32), **tol)


@pytest.mark.parametrize("sc", plans.value_sweep(),
                         ids=[sc.id for sc in plans.value_sweep()])
def test_value_sweep_against_the_port_oracle(sc):
    fam = plans.get_family(sc.family)
    inputs = fam.make_inputs(sc.case, sc.dtype)
    torch.testing.assert_close(fam.apply(sc.plan, inputs),
                               fam.apply(fam.oracle, inputs),
                               **fam.tol(sc.plan, sc.dtype))


def test_grads_hook_leaves_the_inputs_untouched():
    inputs = FAMILY.make_inputs(FAMILY.cases[0], "float32")
    before = [t.clone() for t in tree_leaves(inputs[1])]
    grads = FAMILY.grads("fused_seq", inputs)
    assert all(not t.requires_grad for t in tree_leaves(inputs[1]))
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(inputs[1])))
    shapes = tree_map(lambda t: tuple(t.shape), inputs[1])
    assert tree_map(lambda t: tuple(t.shape), grads) == shapes


# ---------------------------------------------------------------------------
# the rwkv6 family
# ---------------------------------------------------------------------------
RWKV = plans.get_family("rwkv6")
JAX_RWKV = jax_plans.get_family("rwkv6")


def test_the_rwkv6_family_has_the_jax_plans_in_order():
    assert list(RWKV.plans) == list(JAX_RWKV.plans) == \
        list(plans.RWKV_PLANS)
    assert RWKV.oracle == JAX_RWKV.oracle == "stepwise"
    assert RWKV.dtypes == JAX_RWKV.dtypes == ("float32", "bfloat16")
    assert RWKV.profile_hook is plans._rwkv_profile_candidates
    assert JAX_RWKV.profile_hook is not None   # both profile
    for name, spec in RWKV.plans.items():
        assert spec.name == name and spec.fn is plans.RWKV_PLANS[name]


def test_rwkv6_tolerance_tables_are_the_jax_ones():
    assert plans.RWKV_TOL == jax_plans.RWKV_TOL
    assert plans.RWKV_GRAD_TOL == jax_plans.RWKV_GRAD_TOL


@pytest.mark.parametrize("plan", list(plans.RWKV_PLANS))
def test_each_rwkv6_plan_has_the_jax_policy_and_launch_counts(plan):
    """The same policies and launches: ``chunked_scan`` is one launch
    forward and two per training step (K6t and K6b), as JAX's."""
    mine, theirs = RWKV.plans[plan], JAX_RWKV.plans[plan]
    assert mine.policy == theirs.policy
    assert mine.fwd_launches == theirs.fwd_dispatches
    assert mine.train_launches == theirs.train_dispatches
    if plan == "chunked_scan":
        assert (mine.fwd_launches, mine.train_launches) == (1, 2)


def test_rwkv6_cases_and_sweeps_are_the_jax_ones():
    assert [tuple(c) for c in RWKV.cases] == \
        [tuple(c) for c in JAX_RWKV.cases]

    def ids(sweep):
        return [(sc.id, sc.heavy) for sc in sweep if sc.family == "rwkv6"]
    assert ids(plans.value_sweep()) == ids(jax_plans.value_sweep())
    assert ids(plans.grad_sweep()) == ids(jax_plans.grad_sweep())


def test_rwkv6_viability_gates_only_the_kernel_plan():
    serving = RWKV.viability(512, 64, 64, chunk=32)
    assert all(serving(n) for n in plans.RWKV_PLANS)
    tiny = RWKV.viability(512, 64, 64, smem_budget=1024)
    assert not tiny("chunked_scan") and tiny("chunked_xla") \
        and tiny("stepwise")
    # training asks the backward's table (K6b): 64 x 64 heads fit it
    train = RWKV.viability(512, 64, 64, train=True)
    assert train("chunked_scan") and train("stepwise")
    at = wkv6_k.working_set_bytes(512, 64, 64, 1, mode="bwd")
    tight = RWKV.viability(512, 64, 64, smem_budget=at - 1, train=True)
    assert not tight("chunked_scan") and tight("chunked_xla")
    assert RWKV.viability(512, 64, 64, smem_budget=at - 1)("chunked_scan")


def _jax_rwkv_inputs(case, dtype):
    """The JAX family's inputs for ``case`` and the port's copy of them
    (bf16 values carried through f32 exactly)."""
    args, chunk = JAX_RWKV.make_inputs(case, dtype)
    dt = getattr(torch, dtype)
    mine = [torch.from_numpy(np.array(a, np.float32)).to(
        dt if i < 3 else torch.float32) for i, a in enumerate(args)]
    return (args, chunk), (mine, chunk)


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.mark.parametrize("dtype", list(RWKV.dtypes))
@pytest.mark.parametrize("case", JAX_RWKV.cases,
                         ids=[c.label for c in JAX_RWKV.cases])
@pytest.mark.parametrize("plan", list(plans.RWKV_PLANS))
def test_port_rwkv6_plan_matches_jax_stepwise_on_jax_cases(plan, case,
                                                           dtype):
    (jargs, chunk), (args, _) = _jax_rwkv_inputs(case, dtype)
    want = jax_plans.RWKV_PLANS["stepwise"](*jargs, chunk=chunk)
    got = plans.RWKV_PLANS[plan](*args, chunk=chunk)
    assert got[0].dtype == args[2].dtype and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **RWKV.tol(plan, dtype))


RWKV_GRAD_SWEEP = [sc for sc in plans.grad_sweep() if sc.family == "rwkv6"
                   and not sc.heavy]


@pytest.mark.parametrize("sc", RWKV_GRAD_SWEEP,
                         ids=[sc.id for sc in RWKV_GRAD_SWEEP])
def test_port_rwkv6_plan_grads_match_jax_stepwise_on_jax_cases(sc):
    """CPU gradients (autograd of the plain versions) against JAX's
    gradients of its stepwise oracle, at the family's gradient tolerance."""
    (jargs, chunk), (args, _) = _jax_rwkv_inputs(sc.case, sc.dtype)
    want = JAX_RWKV.grads("stepwise", (jargs, chunk))
    got = RWKV.grads(sc.plan, (args, chunk))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **RWKV.grad_tol(sc.plan, sc.dtype))


RWKV_HEAVY_GRADS = [sc for sc in plans.grad_sweep() if sc.family == "rwkv6"
                    and sc.plan == "chunked_scan" and sc.heavy]


@pytest.mark.parametrize("sc", RWKV_HEAVY_GRADS,
                         ids=[sc.id for sc in RWKV_HEAVY_GRADS])
def test_chunked_scan_grads_match_jax_stepwise_on_the_heavy_cases(sc):
    """The rest of the family's gradient sweep for the kernel plan — the
    cases the sweep marks heavy (C | T, C = T, dk != dv with chunk > T,
    T = 96) — through ``_Wkv6Fn`` (the trajectory forward and the
    hand-derived backward, plain on the CPU), against JAX's gradients of
    its stepwise oracle at the family's gradient tolerance."""
    (jargs, chunk), (args, _) = _jax_rwkv_inputs(sc.case, sc.dtype)
    want = JAX_RWKV.grads("stepwise", (jargs, chunk))
    got = RWKV.grads(sc.plan, (args, chunk))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **RWKV.grad_tol(sc.plan, sc.dtype))


def test_chunked_scan_routes_to_chunked_xla_where_no_chunk_fits():
    """Heads wider than a thread block has threads fit no tile: on the CPU
    the plan runs ``chunked_xla`` and says so; on the card it raises, as
    the kernel's wrapper does (no plain version stands in for the kernel
    there)."""
    rng = np.random.default_rng(0)
    B, S, H, dk, dv = 1, 6, 1, 4, wkv6_k.THREADS + 8
    r, k = (torch.from_numpy(rng.standard_normal((B, S, H, dk)
                                                 ).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, S, H, dv)
                                             ).astype(np.float32))
    logw = -torch.exp(torch.from_numpy(rng.standard_normal((B, S, H, dk)
                                                           ).astype(np.float32)))
    u = torch.zeros(H, dk)
    s = torch.zeros(B, H, dk, dv)
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        got = plans.RWKV_PLANS["chunked_scan"](r, k, v, logw, u, s, chunk=4)
    finally:
        trace_lib.set_tracer(old)
    want = plans.RWKV_PLANS["chunked_xla"](r, k, v, logw, u, s, chunk=4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    (event,) = sink.records
    assert event["attrs"]["fallback"] == "chunked_xla"
    with pytest.raises(ValueError, match="fit no chunk; the working set"):
        plans._rwkv_scan_blocks(S, dk, dv, 4, torch.device("cuda"))
    with pytest.raises(ValueError, match="fit no chunk"):
        plans.RWKV_PLANS["chunked_scan"](
            *(t.to("meta") for t in (r, k, v, logw, u, s)), chunk=4)
    assert plans._rwkv_scan_blocks(S, 64, 64, 4, torch.device("cuda")) \
        == wkv6_k.WkvBlocks(4, 1)


# ---------------------------------------------------------------------------
# the mamba family
# ---------------------------------------------------------------------------
MAMBA = plans.get_family("mamba")
JAX_MAMBA = jax_plans.get_family("mamba")


def test_the_mamba_family_has_the_jax_plans_in_order():
    assert list(MAMBA.plans) == list(JAX_MAMBA.plans) == \
        list(plans.MAMBA_PLANS) == ["scan", "fused_scan"]
    assert MAMBA.oracle == JAX_MAMBA.oracle == "scan"
    assert MAMBA.dtypes == JAX_MAMBA.dtypes == ("float32", "bfloat16")
    assert MAMBA.profile_hook is plans._mamba_profile_candidates
    assert JAX_MAMBA.profile_hook is not None   # both profile
    for name, spec in MAMBA.plans.items():
        assert spec.name == name and spec.fn is plans.MAMBA_PLANS[name]


def test_mamba_tolerance_tables_are_the_jax_ones():
    assert plans.MAMBA_TOL == jax_plans.MAMBA_TOL
    assert plans.MAMBA_GRAD_TOL == jax_plans.MAMBA_GRAD_TOL


@pytest.mark.parametrize("plan", list(plans.MAMBA_PLANS))
def test_each_mamba_plan_has_the_jax_policy_and_launch_counts(plan):
    """The same policies and launches: ``fused_scan`` is one launch
    forward and two per training step (K7t and K7b), as JAX's."""
    mine, theirs = MAMBA.plans[plan], JAX_MAMBA.plans[plan]
    assert mine.policy == theirs.policy
    assert mine.fwd_launches == theirs.fwd_dispatches
    assert mine.train_launches == theirs.train_dispatches
    if plan == "fused_scan":
        assert (mine.fwd_launches, mine.train_launches) == (1, 2)


def test_mamba_cases_and_sweeps_are_the_jax_ones():
    assert [tuple(c) for c in MAMBA.cases] == \
        [tuple(c) for c in JAX_MAMBA.cases]

    def ids(sweep):
        return [(sc.id, sc.heavy) for sc in sweep if sc.family == "mamba"]
    assert ids(plans.value_sweep()) == ids(jax_plans.value_sweep())
    assert ids(plans.grad_sweep()) == ids(jax_plans.grad_sweep())


def test_mamba_viability_gates_only_the_kernel_plan():
    serving = MAMBA.viability(512, 16384, 16, chunk=64)
    assert all(serving(n) for n in plans.MAMBA_PLANS)
    tiny = MAMBA.viability(512, 16384, 16, smem_budget=256)
    assert not tiny("fused_scan") and tiny("scan")
    assert not MAMBA.viability(512, 16384, 32)("fused_scan")


def _jax_mamba_inputs(case, dtype):
    """The JAX family's inputs for ``case`` and the port's copy of them
    (bf16 values carried through f32 exactly)."""
    args, chunk, block_b = JAX_MAMBA.make_inputs(case, dtype)
    mine = [torch.from_numpy(np.array(a, np.float32)) for a in args]
    mine[0] = mine[0].to(getattr(torch, dtype))
    return (args, chunk, block_b), (mine, chunk, block_b)


@pytest.mark.parametrize("dtype", list(MAMBA.dtypes))
@pytest.mark.parametrize("case", JAX_MAMBA.cases,
                         ids=[c.label for c in JAX_MAMBA.cases])
@pytest.mark.parametrize("plan", list(plans.MAMBA_PLANS))
def test_port_mamba_plan_matches_jax_scan_on_jax_cases(plan, case, dtype):
    jinputs, inputs = _jax_mamba_inputs(case, dtype)
    want = JAX_MAMBA.apply("scan", jinputs)
    got = MAMBA.apply(plan, inputs)
    assert got[0].dtype == inputs[0][0].dtype
    assert got[1].dtype == torch.float32
    tol = MAMBA.tol(plan, dtype) if plan != "scan" else plans.MAMBA_TOL[dtype]
    np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), **tol)
    np.testing.assert_allclose(_f32(got[1]), _f32(want[1]),
                               **plans.MAMBA_TOL["float32"])


MAMBA_GRAD_SWEEP = [sc for sc in plans.grad_sweep() if sc.family == "mamba"]


@pytest.mark.parametrize("sc", MAMBA_GRAD_SWEEP,
                         ids=[sc.id for sc in MAMBA_GRAD_SWEEP])
def test_fused_scan_grads_match_jax_scan_on_jax_cases(sc):
    """Through ``_MambaFn`` (the trajectory forward and the hand-derived
    backward, plain on the CPU) against JAX's gradients of its scan
    oracle, every case of the family's gradient sweep, at its gradient
    tolerance."""
    jinputs, inputs = _jax_mamba_inputs(sc.case, sc.dtype)
    want = JAX_MAMBA.grads("scan", jinputs)
    got = MAMBA.grads(sc.plan, inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w),
                                   **MAMBA.grad_tol(sc.plan, sc.dtype))


def test_fused_scan_calls_each_kernel_as_jax_dispatches(monkeypatch):
    """On the CPU the wrappers run their plain versions and count no
    launch; counting their calls shows what a card launch count rests on:
    a forward is one K7, a gradient one K7t and one K7b (JAX's 1 and 2)."""
    calls = dict.fromkeys(("mamba_scan", "mamba_scan_traj",
                           "mamba_scan_bwd", "_launch_fwd"), 0)
    for name in ("mamba_scan_traj", "mamba_scan_bwd"):
        fn = getattr(ms_k, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ms_k, name, counted)
    plain = ms_k.mamba_scan_plain

    def counted_plain(*a, **kw):
        calls["mamba_scan"] += 1
        return plain(*a, **kw)
    monkeypatch.setattr(ms_k, "mamba_scan_plain", counted_plain)
    inputs = MAMBA.make_inputs(MAMBA.cases[0], "float32")
    MAMBA.apply("fused_scan", inputs)
    assert calls["mamba_scan"] == MAMBA.plans["fused_scan"].fwd_launches
    calls["mamba_scan"] = 0
    MAMBA.grads("fused_scan", inputs)
    assert calls["mamba_scan"] == 0
    assert calls["mamba_scan_traj"] + calls["mamba_scan_bwd"] == \
        MAMBA.plans["fused_scan"].train_launches
    assert calls["mamba_scan_traj"] == calls["mamba_scan_bwd"] == 1
