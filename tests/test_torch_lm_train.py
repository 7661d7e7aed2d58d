"""The port's RWKV6 training path (``repro_torch.steps.loss_fn``,
``train_step``, ``eval_step``, ``models/transformer.forward(remat=)``,
``data/lm.py``, ``launch/train.py``) against the JAX package on the CPU,
at the reduced config ``rwkv6-3b-reduced`` in f32 (2 layers x 256, heads
of 32, chunk 8, vocab 512).

Parameters come from the JAX ``init_params`` through ``split`` and
``convert``, with the zero-initialised mixes, bonus and norm affines
perturbed (the same numbers on both sides).  The port's time-mix runs its
default plan ``chunked_scan``: under autograd its ``_Wkv6Fn``, which on the
CPU runs the plain versions of the trajectory forward and of the
hand-derived backward (on the card: the kernels K6t and K6b).  The JAX
Pallas plan runs in interpret mode."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import analysis as jax_analysis  # noqa: E402
from repro import steps as jax_steps  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data.lm import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import steps  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import plans  # noqa: E402
from repro_torch.data.lm import SyntheticLM  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_k  # noqa: E402
from repro_torch.launch import train as train_lm  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim.adamw import (AdamW, tree_leaves,  # noqa: E402
                                     warmup_cosine)

NAME = "rwkv6-3b-reduced"
CFG = get_arch(NAME)
JCFG = jax_get_arch(NAME)
PERTURB = {"maa_x", "maa", "u", "mu_k", "mu_r"}
#: the rwkv6 family's f32 gradient tolerance (RWKV_GRAD_TOL)
GRAD_TOL = plans.RWKV_GRAD_TOL["float32"]


def _perturb(tree, rng, key=""):
    """Give the zero- and one-initialised leaves random values (as
    tests/test_torch_rwkv.py does)."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng, key) for v in tree)
    a = np.asarray(tree)
    if key in PERTURB or key == "bias":
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    if key == "scale":
        return (a * (1 + 0.1 * rng.standard_normal(a.shape))).astype(a.dtype)
    return a


@pytest.fixture(scope="module")
def trees():
    """(the perturbed JAX params as numpy, the token batch as numpy)."""
    plain, _ = split(jax_registry.build(JCFG).init(jax.random.PRNGKey(0)))
    np_tree = _perturb(jax.tree.map(np.asarray, plain),
                       np.random.default_rng(0))
    toks = np.random.default_rng(1).integers(0, CFG.vocab, (2, 40)).astype(
        np.int32)
    return np_tree, toks


def _port(np_tree):
    params = convert.params_from_numpy(np_tree)
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


def _port_grads(np_tree, toks, remat=True):
    params = _port(np_tree)
    loss, _ = steps.loss_fn(params, CFG, {"tokens": torch.from_numpy(toks)},
                            remat=remat)
    return loss, torch.autograd.grad(loss, tree_leaves(params))


def _jax_leaves(tree):
    """The JAX tree's leaves as numpy, in the port's order (dict keys
    sorted, the blocks tuple as a list)."""
    return [t.numpy() for t in tree_leaves(
        convert.params_from_numpy(jax.tree.map(np.asarray, tree)))]


# ---------------------------------------------------------------------------
# the forward repair
# ---------------------------------------------------------------------------
def test_forward_differentiates_the_reduced_model():
    """The full-sequence forward carries each layer's states as values:
    writing them into a scratch cache modified the wkv states autograd had
    saved, and ``logits.sum().backward()`` raised (one of the variables
    needed for gradient computation has been modified by an inplace
    operation: a [16, 32, 32] tensor)."""
    model = registry.build(CFG)
    params = model.init(torch.Generator().manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG.vocab, (2, 40)).astype(np.int32))
    logits, _ = model.forward(params, {"tokens": toks})
    logits.sum().backward()
    for p in tree_leaves(params):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())


# ---------------------------------------------------------------------------
# gradients against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jax_plan", ["chunked_xla", "chunked_scan"])
def test_loss_fn_grads_match_jax(trees, jax_plan, monkeypatch):
    """The port's ``loss_fn`` (its plan ``chunked_scan``: the trajectory
    forward and the hand-derived backward) against ``jax.grad`` of JAX's
    ``loss_fn`` with its plan at ``chunked_xla`` (autodiff of its jnp
    scan) and at ``chunked_scan`` (its Pallas kernels, interpret mode), at
    RWKV_GRAD_TOL f32."""
    np_tree, toks = trees
    monkeypatch.setattr(jax_rwkv, "WKV_PLAN", jax_plan)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_steps.loss_fn(p, JCFG, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    loss, grads = _port_grads(np_tree, toks)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _jax_leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_remat_on_and_off_give_equal_grads(trees):
    np_tree, toks = trees
    loss_on, on = _port_grads(np_tree, toks, remat=True)
    loss_off, off = _port_grads(np_tree, toks, remat=False)
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


#: three AdamW steps against JAX's: the losses agree to f32 rounding of
#: the same sums in two frameworks (the first to 1e-5, as the gradient test
#: holds it); the later ones and the gradient norms move with the
#: parameters the earlier updates wrote, whose differences are at the
#: gradient tolerance's scale, so they are held to 1e-4 and 1e-3 relative
STEP_LOSS_TOL = dict(rtol=1e-4, atol=0)
STEP_GNORM_TOL = dict(rtol=1e-3, atol=0)


def test_three_train_steps_match_jax(trees):
    np_tree, _ = trees
    data = SyntheticLM(CFG.vocab, seed=0).batches(2, 24)
    batches = [next(data)["tokens"] for _ in range(3)]

    jopt = JaxAdamW(lr=jax_warmup_cosine(3e-3, 1, 3))
    jparams = jax.tree.map(jnp.asarray, np_tree)
    jstate = jopt.init(jparams)
    jsteps = []
    for toks in batches:
        jparams, jstate, m = jax_steps.train_step(
            jopt, JCFG, jparams, jstate, {"tokens": jnp.asarray(toks)})
        jsteps.append((float(m["loss"]), float(m["grad_norm"])))

    opt = AdamW(lr=warmup_cosine(3e-3, 1, 3))
    params = _port(np_tree)
    state = opt.init(params)
    for i, toks in enumerate(batches):
        params, state, m = steps.train_step(
            opt, CFG, params, state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), jsteps[i][0],
                                   **STEP_LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jsteps[i][1],
                                   **STEP_GNORM_TOL)
    assert state["step"] == 3


def test_eval_step_is_the_loss_without_gradients(trees):
    np_tree, toks = trees
    params = _port(np_tree)
    batch = {"tokens": torch.from_numpy(toks)}
    metrics = steps.eval_step(CFG, params, batch)
    loss, _ = steps.loss_fn(params, CFG, batch)
    assert not metrics["loss"].requires_grad
    torch.testing.assert_close(metrics["loss"], loss.detach(), rtol=0,
                               atol=1e-6)


def test_loss_fn_raises_for_what_the_port_cannot_train():
    cfg = dataclasses.replace(CFG, n_codebooks=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        steps.loss_fn({}, cfg, {"tokens": torch.zeros(1, 2, 4)})


# ---------------------------------------------------------------------------
# launches per step: the port's calls of each kernel wrapper against what
# JAX's dispatch counter counts for its loss_fn
# ---------------------------------------------------------------------------
def _jax_train_dispatches(n_layers, remat):
    cfg = dataclasses.replace(JCFG, n_layers=n_layers)
    plain, _ = split(jax_registry.build(cfg).init(jax.random.PRNGKey(0)))
    batch = {"tokens": jnp.zeros((2, 24), jnp.int32)}
    old = jax_rwkv.WKV_PLAN
    jax_rwkv.WKV_PLAN = "chunked_scan"
    try:
        return jax_analysis.count_train_dispatches(
            lambda p: jax_steps.loss_fn(p, cfg, batch, remat=remat)[0], plain)
    finally:
        jax_rwkv.WKV_PLAN = old


#: JAX's Pallas dispatches of one value_and_grad of its loss_fn through
#: chunked_scan, at L layers: with remat the trajectory forward, its
#: recompute and the backward (3 a layer); without, 2 a layer.  The chip
#: run holds the port's K6t/K6b launch counts to these.
JAX_TRAIN_DISPATCHES = {(2, True): 6, (2, False): 4, (4, True): 12,
                        (4, False): 8}


@pytest.mark.parametrize("n_layers,remat", sorted(JAX_TRAIN_DISPATCHES))
def test_jax_train_dispatch_counts_are_pinned(n_layers, remat):
    assert _jax_train_dispatches(n_layers, remat) == \
        JAX_TRAIN_DISPATCHES[(n_layers, remat)]


@pytest.mark.parametrize("remat", [True, False])
def test_port_calls_each_kernel_as_jax_dispatches(remat, monkeypatch):
    """On the CPU the wrappers run their plain versions and count no
    launch; counting their calls shows the plumbing a card launch count
    rests on: K6t once a layer (twice with remat), K6b once, K6 never."""
    calls = {"wkv6": 0, "wkv6_traj": 0, "wkv6_bwd": 0}
    for name in calls:
        fn = getattr(wkv6_k, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(wkv6_k, name, counted)
    cfg = dataclasses.replace(CFG, n_layers=4)
    params = registry.build(cfg).init(torch.Generator().manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_()
    calls["wkv6"] = 0          # a K6 call under autograd runs _Wkv6Fn
    loss, _ = steps.loss_fn(params, cfg, {"tokens": torch.zeros(
        2, 24, dtype=torch.int32)}, remat=remat)
    torch.autograd.grad(loss, tree_leaves(params))
    L = cfg.n_layers
    assert calls["wkv6_traj"] + calls["wkv6_bwd"] == \
        JAX_TRAIN_DISPATCHES[(L, remat)]
    assert calls["wkv6_traj"] == (2 * L if remat else L)
    assert calls["wkv6_bwd"] == L


def test_eval_step_calls_only_the_forward_kernel(trees, monkeypatch):
    np_tree, toks = trees
    called = []
    for name in ("wkv6_traj", "wkv6_bwd"):
        monkeypatch.setattr(wkv6_k, name,
                            lambda *a, _n=name, **kw: called.append(_n))
    steps.eval_step(CFG, _port(np_tree), {"tokens": torch.from_numpy(toks)})
    assert called == []


# ---------------------------------------------------------------------------
# data and the entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seed", [(512, 0), (65536, 3)])
def test_synthetic_lm_tokens_equal_jax(vocab, seed):
    mine = SyntheticLM(vocab, seed=seed)
    theirs = JaxSyntheticLM(vocab, seed=seed)
    a, b = mine.batches(3, 17), theirs.batches(3, 17)
    for _ in range(2):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_train_main_runs_on_the_cpu(capsys):
    report = train_lm.main(["--device", "cpu", "--reduced", "--steps", "2",
                            "--batch", "2", "--seq", "24", "--log-every",
                            "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("arch=rwkv6-3b-reduced params=")
    assert out[-1].startswith("loss ") and " -> " in out[-1]
    assert len(report["losses"]) == 2 and len(report["step_ms"]) == 2
    assert all(np.isfinite(report["losses"] + report["grad_norms"]))
    assert [h["step"] for h in report["history"]] == [1, 2]


def test_train_main_raises_where_it_cannot_run():
    with pytest.raises(NotImplementedError,
                       match="Distributed, launch and checkpoint"):
        train_lm.main(["--device", "cpu", "--reduced", "--ckpt-dir", "x"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_lm.main(["--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# bf16 gradients: the dtype the full-width model trains in
# ---------------------------------------------------------------------------
CFG16 = dataclasses.replace(CFG, dtype="bfloat16")
JCFG16 = dataclasses.replace(JCFG, dtype="bfloat16")
#: the port's bf16 gradient error, relative to each leaf's max|f32 grad|,
#: may be this many times JAX's own bf16 error on the same leaf, plus one
#: bf16 step at that max (2^-8) for the leaves where JAX's error is near 0
#: (tests/test_torch_mamba.py's rule)
BF16_GRAD_MULTIPLE = 2.0
BF16_STEP = 2.0 ** -8


def _bf16_errors(key, tok_seed, seq):
    """Per leaf, the bf16 gradient's max abs error against JAX's f32
    gradient of the same bf16 weights (as the JAX init draws them from
    ``PRNGKey(key)``), over max|f32 grad|: (the port's, JAX's)."""
    plain, _ = split(jax_registry.build(JCFG16).init(
        jax.random.PRNGKey(key)))
    tree16 = jax.tree.map(np.asarray, plain)
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree16)
    toks = np.random.default_rng(tok_seed).integers(
        0, CFG.vocab, (2, seq)).astype(np.int32)

    def grads(cfg, tree):
        return [t.float().numpy() for t in tree_leaves(
            convert.params_from_numpy(jax.tree.map(np.asarray, jax.grad(
                lambda p: jax_steps.loss_fn(
                    p, cfg, {"tokens": jnp.asarray(toks)})[0])(
                        jax.tree.map(jnp.asarray, tree)))))]

    want, jax16 = grads(JCFG, tree32), grads(JCFG16, tree16)
    params = _port(tree16)
    loss, _ = steps.loss_fn(params, CFG16,
                            {"tokens": torch.from_numpy(toks)})
    mine = [g.float().numpy() for g in torch.autograd.grad(
        loss, tree_leaves(params))]

    def rel(got):
        return [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                for g, w in zip(got, want)]
    return rel(mine), rel(jax16)


@pytest.mark.parametrize("key,tok_seed,seq", [
    (0, 100, 24), (1, 101, 24), (2, 102, 24),
    pytest.param(0, 1, 40, marks=pytest.mark.xfail(strict=True, reason=(
        "the port's mix/gn/bias gradient is 3.07x JAX's bf16 error here; "
        "with XLA's excess precision off the rule holds (ROADMAP Queue 3, "
        "'RWKV6 bf16 gradients at one input')")))])
def test_bf16_grads_are_as_close_to_f32_as_jax_bf16(key, tok_seed, seq):
    """The bf16 model's ``loss_fn`` gradients against JAX's f32 gradients
    of the same bf16 weights: per leaf, the port's error is at most
    BF16_GRAD_MULTIPLE times JAX's bf16 error plus one bf16 step (both
    relative to the leaf's max|f32 grad|).  Seeds 0 to 2 as in
    tests/test_torch_mamba.py, and the input ROADMAP Queue 3 logs."""
    mine, theirs = _bf16_errors(key, tok_seed, seq)
    for i, (m, t) in enumerate(zip(mine, theirs)):
        assert m <= BF16_GRAD_MULTIPLE * t + BF16_STEP, (i, m, t)
