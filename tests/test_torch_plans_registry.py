"""The port's plan registry (``repro_torch.core.plans``) against the JAX
package's (``repro.core.plans``): the LSTM family's plan names, policies,
tolerance tables, launch counts and cases, its sweeps, and the port's five
plans swept over the JAX family's cases against the JAX package's
``sequential`` on the CPU."""
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
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

FAMILY = plans.get_family("lstm")
JAX_FAMILY = jax_plans.get_family("lstm")


def test_the_lstm_family_has_the_jax_plans_in_order():
    assert list(FAMILY.plans) == list(JAX_FAMILY.plans) == \
        list(lstm.FORWARD_PLANS)
    assert FAMILY.oracle == JAX_FAMILY.oracle == "sequential"
    assert FAMILY.dtypes == ("float32",)
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
    def ids(sweep, family):
        return [sc.id for sc in sweep if sc.family == family
                and sc.dtype == "float32"]
    assert ids(plans.value_sweep(), "lstm") == \
        ids(jax_plans.value_sweep(), "lstm")
    assert ids(plans.grad_sweep(), "lstm") == \
        ids(jax_plans.grad_sweep(), "lstm")
    assert all(sc.dtype == "float32" for sc in plans.value_sweep())


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


def _jax_inputs(case):
    """The JAX family's inputs for ``case`` (f32) and the port's copy."""
    jcfg, jparams, x, labels = JAX_FAMILY.make_inputs(case, "float32")
    b, t, h, d, n_layers = case.shape
    cfg = dataclasses.replace(LSTMConfig(), hidden=h, input_dim=d,
                              n_layers=n_layers, seq_len=t)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, split(jparams)[0]))
    return (jcfg, jparams, x, labels), (
        cfg, params, torch.from_numpy(np.array(x)),
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


@pytest.mark.parametrize("sc", plans.grad_sweep(),
                         ids=[sc.id for sc in plans.grad_sweep()])
def test_port_plan_grads_match_jax_sequential_on_jax_cases(sc):
    (jcfg, jparams, x, labels), (cfg, params, xt, yt) = _jax_inputs(sc.case)
    want = jax.grad(jax_lstm.loss_fn)(jparams, x, labels, jcfg)
    got = FAMILY.grads(sc.plan, (cfg, params, xt, yt))
    tol = FAMILY.grad_tol(sc.plan, sc.dtype)
    for g, r in zip(jax.tree.leaves(convert.params_to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 split(want)[0]))):
        np.testing.assert_allclose(g, r, **tol)


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
