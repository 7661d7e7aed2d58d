"""The port's training slice against the JAX package on the CPU: the grads
of every plan, the HAR minibatches, AdamW steps from carried-over params,
the launch counts of a training step, and the ``launch.train_har`` entry
point."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mobirnn_lstm import LSTMConfig as JaxConfig  # noqa: E402
from repro.core import lstm as jax_lstm  # noqa: E402
from repro.data import har as jax_har  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.mobirnn_lstm import LSTMConfig  # noqa: E402
from repro_torch.core import lstm  # noqa: E402
from repro_torch.data import har  # noqa: E402
from repro_torch.launch import train_har  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

#: the JAX package's f32 gradient tolerance (core/plans.LSTM_GRAD_TOL)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
NARROW = dict(hidden=8, n_layers=2, seq_len=16)


def _both(seed, **shape):
    """The JAX params of ``shape`` (annotated, as its plans take them) and
    the port's trainable copy of their plain tree."""
    jcfg = JaxConfig(**shape)
    jparams = jax_lstm.init_params(jax.random.PRNGKey(seed), jcfg)
    plain, _ = split(jparams)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_()
    return jcfg, jparams, LSTMConfig(**shape), tparams


def _batch(seed, B, T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 9)).astype(np.float32),
            rng.integers(0, 6, B).astype(np.int32))


def _assert_trees_close(got, want, **tol):
    got, want = convert.params_to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("plan", list(lstm.FORWARD_PLANS))
def test_plan_grads_match_jax(plan):
    """jax.grad of the JAX package's loss through each plan (Pallas in
    interpret mode) against torch.autograd of the port's, from the same
    params and batch."""
    jcfg, jparams, cfg, params = _both(0, **NARROW)
    x, y = _batch(1, 3, NARROW["seq_len"])
    jloss, jgrads = jax.value_and_grad(jax_lstm.loss_fn)(
        jparams, jnp.asarray(x), jnp.asarray(y), jcfg,
        forward=jax_lstm.FORWARD_PLANS[plan])
    loss = lstm.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y),
                        cfg, forward=lstm.FORWARD_PLANS[plan])
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-5)
    flat = iter(grads)
    _assert_trees_close(tree_map(lambda _: next(flat), params),
                        split(jgrads)[0], **GRAD_TOL)


def test_har_batches_equal_jax():
    train, _ = har.make_har(n_train=23, n_test=1, seed=3)
    jtrain, _ = jax_har.make_har(n_train=23, n_test=1, seed=3)
    mine = har.batches(train, 5, seed=4)
    theirs = jax_har.batches(jtrain, 5, seed=4)
    for _ in range(9):                        # crosses two epochs
        (mx, my), (tx, ty) = next(mine), next(theirs)
        assert np.array_equal(mx, tx) and np.array_equal(my, ty)


@pytest.mark.parametrize("plan", ["sequential", "fused_seq"])
def test_adamw_steps_match_the_jax_training_step(plan):
    """Three steps of examples/train_har.py's jitted step (value_and_grad +
    AdamW with warmup_cosine, no decay) against the port's train_step from
    carried-over params: losses, grad norms and the params after."""
    jcfg, jparams, cfg, params = _both(2, **NARROW)
    steps, lr = 3, 3e-3
    jopt = JaxAdamW(lr=jax_warmup_cosine(lr, steps // 10, steps),
                    weight_decay=0.0)
    opt = AdamW(lr=warmup_cosine(lr, steps // 10, steps), weight_decay=0.0)
    jforward, forward = jax_lstm.FORWARD_PLANS[plan], lstm.FORWARD_PLANS[plan]

    @jax.jit
    def jstep(params, state, x, y):
        loss, grads = jax.value_and_grad(jax_lstm.loss_fn)(
            params, x, y, jcfg, forward=jforward)
        params, state, m = jopt.update(grads, state, params)
        return params, state, loss, m["grad_norm"]

    jstate, state = jopt.init(jparams), opt.init(params)
    for i in range(steps):
        x, y = _batch(10 + i, 4, NARROW["seq_len"])
        jparams, jstate, jloss, jgn = jstep(jparams, jstate, jnp.asarray(x),
                                            jnp.asarray(y))
        state, loss, gn = train_har.train_step(
            params, state, torch.from_numpy(x), torch.from_numpy(y), cfg,
            forward, opt)
        np.testing.assert_allclose(float(loss), float(jloss), **GRAD_TOL)
        np.testing.assert_allclose(float(gn), float(jgn), **GRAD_TOL)
    assert state["step"] == int(jstate["step"]) == steps
    _assert_trees_close(params, split(jparams)[0], **GRAD_TOL)


def _adamw_out_of_place(opt, grads, state, params):
    """``AdamW.update_``'s arithmetic written out of place: new tensors for
    every product and sum, in the order of the JAX package's formula."""
    step = torch.tensor(state["step"] + 1, dtype=torch.float32)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads))
    scale = torch.clamp(opt.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - torch.pow(torch.tensor(opt.b1, dtype=torch.float32), step)
    bc2 = 1 - torch.pow(torch.tensor(opt.b2, dtype=torch.float32), step)
    lr = opt._lr(step)
    out = []
    for p, g, m, n in zip(params, grads, state["mu"], state["nu"]):
        g32 = g.float() * scale
        m = opt.b1 * m + (1 - opt.b1) * g32
        n = opt.b2 * n + (1 - opt.b2) * g32 * g32
        u = (m / bc1) / (torch.sqrt(n / bc2) + opt.eps)
        u = u + opt.weight_decay * p.float()
        out.append(((p.float() - lr * u).to(p.dtype), m, n))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_scale", [1e-3, 1e3])
def test_adamw_update_in_place_is_the_formula_bit_for_bit(dtype, grad_scale):
    """``update_`` writes each leaf in place, holding at most two f32
    temporaries of it: three steps give the bits of the out-of-place
    formula, f32 and bf16 leaves, gradients under and over the clip."""
    gen = torch.Generator().manual_seed(3)
    params = [torch.randn(s, generator=gen).to(dtype) for s in
              ((7, 5), (11,), (3, 4, 2))]
    opt = AdamW(lr=warmup_cosine(3e-3, 1, 3))
    state = opt.init(params)
    mine = [p.clone() for p in params]
    theirs = [p.clone() for p in params]
    ref = {"mu": [m.clone() for m in state["mu"]],
           "nu": [n.clone() for n in state["nu"]], "step": 0}
    for _ in range(3):
        grads = [(grad_scale * torch.randn(p.shape, generator=gen)).to(dtype)
                 for p in params]
        kept = [g.clone() for g in grads]
        opt.update_(grads, state, mine)
        new = _adamw_out_of_place(opt, grads, ref, theirs)
        theirs = [p for p, _, _ in new]
        ref = {"mu": [m for _, m, _ in new], "nu": [n for _, _, n in new],
               "step": ref["step"] + 1}
        assert all(torch.equal(a, b) for a, b in zip(grads, kept))
        for a, b in zip(mine + state["mu"] + state["nu"],
                        theirs + ref["mu"] + ref["nu"]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert state["step"] == 3


def test_warmup_cosine_matches_jax():
    mine, theirs = warmup_cosine(1e-3, 5, 40), jax_warmup_cosine(1e-3, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        got = float(mine(torch.tensor(step, dtype=torch.float32)))
        assert got == pytest.approx(float(theirs(jnp.asarray(step))),
                                    rel=1e-6)


def test_fused_cell_step_runs_no_backward_kernel():
    """The fused_cell plan trains through the cell's autograd Function
    (its backward is the VJP of the plain cell), with grads equal to the
    sequential plan's."""
    _, _, cfg, params = _both(4, **NARROW)
    x, y = _batch(5, 2, NARROW["seq_len"])
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    leaves = tree_leaves(params)
    assert lstm.forward_fused_kernel(params, xt, cfg).grad_fn is not None
    g_cell = torch.autograd.grad(lstm.loss_fn(
        params, xt, yt, cfg, forward=lstm.forward_fused_kernel), leaves)
    g_seq = torch.autograd.grad(lstm.loss_fn(params, xt, yt, cfg), leaves)
    for a, b in zip(g_cell, g_seq):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_plan_viability_train_sizes_the_backward():
    cfg = LSTMConfig()
    assert lstm.plan_viability(cfg, 64, 128, train=True)("fused_seq")
    # 2 x 64 trains on the split home; no split of 2 x 1024's fits the card
    assert lstm.plan_viability(cfg.with_complexity(64, 2), 1, 128,
                               train=True)("fused_seq")
    wide = LSTMConfig().with_complexity(1024, 2)
    assert not lstm.plan_viability(wide, 1, 128, train=True)("fused_seq")
    assert lstm.plan_viability(wide, 1, 128, train=True)("fused_cell")


def test_params_round_trip_through_numpy():
    jcfg, jparams, cfg, params = _both(6, **NARROW)
    back = convert.params_to_numpy(params)
    _assert_trees_close(params, split(jparams)[0], rtol=0, atol=0)
    assert isinstance(back["layers"][0]["w"], np.ndarray)


def test_train_har_trains_on_the_cpu(capsys):
    out = train_har.main(["--device", "cpu", "--steps", "2", "--plan",
                          "fused_seq", "--latency-cases", "0", "--n-train",
                          "64", "--n-test", "32"])
    assert len(out["losses"]) == len(out["grad_norms"]) == 2
    assert all(np.isfinite(out["losses"])) and all(np.isfinite(
        out["grad_norms"]))
    assert 0.0 <= out["accuracy"] <= 1.0 and out["latency"] == {}
    assert all(p.requires_grad for p in tree_leaves(out["params"]))
    printed = capsys.readouterr().out
    assert "plan=fused_seq" in printed and "final test accuracy" in printed


def test_train_har_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_har.main(["--steps", "1"])
