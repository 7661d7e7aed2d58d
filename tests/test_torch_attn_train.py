"""The port's attention training path (``steps.loss_fn``, ``train_step``,
``eval_step``, ``models/transformer.forward(remat=)`` through the attention
layers, ``launch/train.py``) against the JAX package on the CPU, in f32,
at ``qwen2-0.5b-reduced`` (QKV biases, tied embeddings) and
``yi-9b-reduced`` (no biases): d_model 256, 4 query heads over 2 kv heads
of 64, 2 layers, vocab 512; then the models with attention and MoE,
``olmoe-1b-7b-reduced`` at capacity factors 1.25 and 0.5, and the whole
Jamba hybrid ``jamba-1.5-large-398b-reduced`` (attention, Mamba and MoE).

Parameters come from the JAX ``init_params`` through ``split`` and
``convert``, with the zero-initialised QKV biases and the norm scales
perturbed (the same numbers on both sides).  The port's attention runs its
plan ``flash_prefill``: under autograd ``_FlashPrefillFn``, which on the
CPU runs the plain versions of K8t and of the hand-written backward K8b
(on the card: the kernels).  The JAX model differentiates its jnp
``flash_attention``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import steps as jax_steps  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert, steps  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.launch import train as train_lm  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim.adamw import (AdamW, tree_leaves,  # noqa: E402
                                     warmup_cosine)

ARCHS = ("qwen2-0.5b-reduced", "yi-9b-reduced")
#: the f32 gradients of a small stack in two frameworks
#: (tests/test_torch_moe_models.py's GRAD_TOL)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
#: three AdamW steps: tests/test_torch_lm_train.py's STEP_LOSS_TOL and
#: STEP_GNORM_TOL (the later steps move with the parameters the earlier
#: updates wrote, at the gradient tolerance's scale)
STEP_LOSS_TOL = dict(rtol=1e-4, atol=0)
STEP_GNORM_TOL = dict(rtol=1e-3, atol=0)
#: tests/test_torch_lm_train.py's bf16 rule: the port's bf16 gradient
#: error, relative to each leaf's max|f32 grad|, at most this many times
#: JAX's own bf16 error plus one bf16 step at that max
BF16_GRAD_MULTIPLE = 2.0
BF16_STEP = 2.0 ** -8
PERTURB = {"bq", "bk", "bv", "scale", "conv_b", "d_skip"}


def _perturb(tree, rng, key=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng, key) for v in tree)
    a = np.asarray(tree)
    if key in PERTURB:
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


def _np_tree(jcfg, seed=0):
    plain, _ = split(jax_registry.build(jcfg).init(jax.random.PRNGKey(seed)))
    return _perturb(jax.tree.map(np.asarray, plain),
                    np.random.default_rng(seed))


def _port(np_tree):
    params = convert.params_from_numpy(np_tree)
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


def _toks(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _jax_leaves(tree):
    """The JAX tree's leaves as numpy, in the port's order."""
    return [t.float().numpy() for t in tree_leaves(
        convert.params_from_numpy(jax.tree.map(np.asarray, tree)))]


def _grads_match_jax(cfg, jcfg, toks, tree):
    """The port's ``loss_fn`` loss, metrics and every leaf's gradient
    against ``jax.value_and_grad`` of JAX's ``loss_fn`` (remat on)."""
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    params = _port(tree)
    loss, metrics = steps.loss_fn(params, cfg,
                                  {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), rtol=1e-5, atol=1e-5)
    want = _jax_leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)
    return metrics


@pytest.fixture(scope="module", params=ARCHS)
def dense(request):
    """(config, JAX config, perturbed numpy params, tokens (2, 40))."""
    cfg, jcfg = get_arch(request.param), jax_get_arch(request.param)
    return cfg, jcfg, _np_tree(jcfg), _toks(cfg.vocab, 2, 40, seed=1)


# ---------------------------------------------------------------------------
# the dense models: gradients, remat, AdamW steps against JAX's
# ---------------------------------------------------------------------------
def test_loss_fn_grads_match_jax(dense):
    cfg, jcfg, tree, toks = dense
    _grads_match_jax(cfg, jcfg, toks, tree)


def test_remat_on_and_off_give_equal_grads(dense):
    cfg, _, tree, toks = dense
    out = []
    for remat in (True, False):
        params = _port(tree)
        loss, _ = steps.loss_fn(params, cfg,
                                {"tokens": torch.from_numpy(toks)},
                                remat=remat)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(params))))
    (loss_on, on), (loss_off, off) = out
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_three_train_steps_match_jax(dense):
    cfg, jcfg, tree, _ = dense
    data = SyntheticLM(cfg.vocab, seed=0).batches(2, 24)
    batches = [next(data)["tokens"] for _ in range(3)]
    jopt = JaxAdamW(lr=jax_warmup_cosine(3e-3, 1, 3))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jax.jit(lambda p, st, b: jax_steps.train_step(jopt, jcfg, p, st,
                                                           b))
    jsteps = []
    for toks in batches:
        jparams, jstate, m = jstep(jparams, jstate,
                                   {"tokens": jnp.asarray(toks)})
        jsteps.append((float(m["loss"]), float(m["grad_norm"])))
    opt = AdamW(lr=warmup_cosine(3e-3, 1, 3))
    params = _port(tree)
    state = opt.init(params)
    for i, toks in enumerate(batches):
        params, state, m = steps.train_step(
            opt, cfg, params, state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), jsteps[i][0],
                                   **STEP_LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jsteps[i][1],
                                   **STEP_GNORM_TOL)
    assert state["step"] == 3


@pytest.mark.parametrize("name,key", [("qwen2-0.5b-reduced", 0),
                                      ("yi-9b-reduced", 1)])
def test_bf16_grads_are_as_close_to_f32_as_jax_bf16(name, key):
    """The bf16 model's ``loss_fn`` gradients against JAX's f32 gradients
    of the same bf16 weights: per leaf, the port's error is at most
    BF16_GRAD_MULTIPLE times JAX's bf16 error plus one bf16 step (both
    relative to the leaf's max|f32 grad|)."""
    cfg = dataclasses.replace(get_arch(name), dtype="bfloat16")
    jcfg32 = jax_get_arch(name)
    jcfg16 = dataclasses.replace(jcfg32, dtype="bfloat16")
    plain, _ = split(jax_registry.build(jcfg16).init(
        jax.random.PRNGKey(key)))
    tree16 = jax.tree.map(np.asarray, plain)
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree16)
    toks = _toks(cfg.vocab, 2, 24, seed=100 + key)

    def jax_grads(jcfg, tree):
        return _jax_leaves(jax.jit(jax.grad(lambda p: jax_steps.loss_fn(
            p, jcfg, {"tokens": jnp.asarray(toks)})[0]))(
                jax.tree.map(jnp.asarray, tree)))

    want, theirs = jax_grads(jcfg32, tree32), jax_grads(jcfg16, tree16)
    params = _port(tree16)
    loss, _ = steps.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks)})
    mine = [g.float().numpy() for g in torch.autograd.grad(
        loss, tree_leaves(params))]
    for i, (m, t, w) in enumerate(zip(mine, theirs, want)):
        scale = max(float(np.abs(w).max()), 1e-30)
        e_m = float(np.abs(m - w).max()) / scale
        e_t = float(np.abs(t - w).max()) / scale
        assert e_m <= BF16_GRAD_MULTIPLE * e_t + BF16_STEP, (i, e_m, e_t)


# ---------------------------------------------------------------------------
# the kernels a training step calls
# ---------------------------------------------------------------------------
def _count_calls(monkeypatch):
    calls = {"flash_prefill_traj": 0, "flash_prefill_bwd": 0,
             "flash_prefill_plain": 0}
    for name in calls:
        fn = getattr(fp, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(fp, name, counted)
    return calls


@pytest.mark.parametrize("remat", [True, False])
def test_a_training_step_calls_k8t_and_k8b(remat, monkeypatch):
    """On the CPU the wrappers run their plain versions and count no
    launch; counting their calls shows the plumbing the card's launch
    counts rest on: each attention layer runs K8t once (twice with remat:
    the recompute) and K8b once, K8 never."""
    cfg = get_arch("qwen2-0.5b-reduced")
    params = registry.build(cfg).init(torch.Generator().manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_()
    calls = _count_calls(monkeypatch)
    loss, _ = steps.loss_fn(params, cfg, {"tokens": torch.zeros(
        2, 24, dtype=torch.int32)}, remat=remat)
    torch.autograd.grad(loss, tree_leaves(params))
    L = cfg.n_layers
    assert calls == {"flash_prefill_traj": (2 if remat else 1) * L,
                     "flash_prefill_bwd": L, "flash_prefill_plain": 0}


def test_eval_step_calls_only_k8(dense, monkeypatch):
    cfg, _, tree, toks = dense
    params = _port(tree)
    calls = _count_calls(monkeypatch)
    steps.eval_step(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert calls == {"flash_prefill_traj": 0, "flash_prefill_bwd": 0,
                     "flash_prefill_plain": cfg.n_layers}


# ---------------------------------------------------------------------------
# what trains, and the entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen2-0.5b", "yi-9b", "olmoe-1b-7b",
                                  "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_forward_and_loss_fn_differentiate_every_attention_family(name):
    cfg = get_arch(name + "-reduced")
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_()
    toks = torch.from_numpy(_toks(cfg.vocab, 2, 16, seed=3))
    logits, _ = model.forward(params, {"tokens": toks})
    assert logits.requires_grad
    loss, _ = steps.loss_fn(params, cfg, {"tokens": toks})
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(bool(g.abs().sum() > 0) for g in grads)


@pytest.mark.parametrize("front", [dict(n_codebooks=2),
                                   dict(n_vis_tokens=4)])
def test_audio_and_vision_fronts_still_raise(front):
    """The fronts train now (ROADMAP Queue 1, "The vision and audio
    fronts"; tests/test_torch_fronts.py holds them to JAX): on Qwen2's
    reduced decoder ``loss_fn`` differentiates each, every gradient
    finite.  What still raises is a front over a mix the port has no path
    for (an ``ssm.kind`` other than rwkv6 and mamba)."""
    cfg = dataclasses.replace(get_arch("qwen2-0.5b-reduced"), **front)
    rng = np.random.default_rng(5)
    if cfg.n_codebooks:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, 2, 12)).astype(np.int32))}
    else:
        cfg = dataclasses.replace(cfg, vis_dim=8)
        batch = {"tokens": torch.from_numpy(_toks(cfg.vocab, 2, 12, seed=5)),
                 "vis_embeds": torch.from_numpy(rng.standard_normal(
                     (2, 4, 8)).astype(np.float32))}
    params = registry.build(cfg).init(torch.Generator().manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_()
    loss, _ = steps.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    jamba = get_arch("jamba-1.5-large-398b-reduced")
    other = dataclasses.replace(jamba, **front, ssm=dataclasses.replace(
        jamba.ssm, kind="s4"))
    with pytest.raises(NotImplementedError, match="rwkv6 and mamba"):
        steps.loss_fn({}, other, batch)


def test_train_main_trains_qwen2_on_the_cpu(capsys):
    report = train_lm.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                            "cpu", "--steps", "2", "--batch", "2", "--seq",
                            "24", "--log-every", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("arch=qwen2-0.5b-reduced params=")
    assert out[-1].startswith("loss ") and " -> " in out[-1]
    assert len(report["losses"]) == 2
    assert all(np.isfinite(report["losses"] + report["grad_norms"]))


# ---------------------------------------------------------------------------
# attention with MoE, and the whole Jamba hybrid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_olmoe_grads_match_jax(cf):
    """OLMoE (attention + MoE, 2 layers): ``loss_fn`` at capacity factor
    ``cf`` (1.25, the config's; 0.5, where slots drop) against JAX's, the
    router metrics included."""
    def at(get):
        cfg = get("olmoe-1b-7b-reduced")
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    cfg, jcfg = at(get_arch), at(jax_get_arch)
    metrics = _grads_match_jax(cfg, jcfg, _toks(cfg.vocab, 2, 24, seed=17),
                               _np_tree(jcfg))
    if cf < 1:
        assert float(metrics["moe_drop_frac"]) > 0.0


def test_jamba_hybrid_grads_match_jax():
    """The whole Jamba hybrid (one period: Mamba in seven slots, attention
    at slot 4, MoE on the odd slots) against JAX's ``loss_fn``."""
    name = "jamba-1.5-large-398b-reduced"
    cfg, jcfg = get_arch(name), jax_get_arch(name)
    assert {cfg.layer_kind(i) for i in range(cfg.n_layers)} >= {"attn"}
    _grads_match_jax(cfg, jcfg, _toks(cfg.vocab, 2, 16, seed=18),
                     _np_tree(jcfg))
