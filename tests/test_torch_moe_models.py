"""The port's MoE models (the MoE slots of ``repro_torch.models.transformer``,
``steps.loss_fn``'s router terms, ``init_params``) against the JAX package
on the CPU, in f32: ``olmoe-1b-7b-reduced`` and ``qwen3-moe-30b-a3b-reduced``
(2 layers of attention + MoE, d_model 256, 4 experts of 128, top-2) and
``jamba-1.5-large-398b-reduced``, the whole hybrid (period 8: Mamba in
seven slots, attention at slot 4, MoE on the odd slots, 4 experts).

Parameters come from the JAX ``init_params`` through ``split`` and
``convert``, with the one- and zero-initialised norm scales, conv biases
and skips perturbed (the same numbers on both sides).  The training case
is the attention-free MoE hybrid both packages build as
``dataclasses.replace(CONFIG, n_heads=0, n_kv_heads=0,
attn_every=0).reduced()`` of Jamba (Mamba + MLP, then Mamba + MoE),
which the port can differentiate and which runs MoE at capacity.  Beside
them: one chaos seed of the slot engine on the MoE families against
JAX's engine (the per-family token sweeps are in
tests/test_torch_serving_slots.py), and ``init_params``'s group-by-group
fill against the stack of whole groups it replaced."""
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
from repro.partitioning import split  # noqa: E402

from repro_torch import convert, steps  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

import test_torch_serving_faults as faults_tests  # noqa: E402
import torch_trainer  # noqa: E402

ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b")
#: tests/test_consistency.py's model-level tolerance
TOL = dict(rtol=3e-4, atol=3e-4)
#: the aux losses, summed over the MoE layers of two f32 stacks
AUX_TOL = dict(rtol=1e-5, atol=1e-5)
#: the f32 gradients of a 2-layer stack in two frameworks (MoE at 1e-4,
#: tests/test_torch_moe.py; Mamba's MAMBA_GRAD_TOL is tighter)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
PERTURB = {"conv_b", "d_skip", "scale"}


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


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """(config, JAX config, JAX params, the port's params), f32."""
    cfg, jcfg = (get(request.param).reduced()
                 for get in (get_arch, jax_get_arch))
    tree = _np_tree(jcfg)
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), \
        convert.params_from_numpy(tree)


def _toks(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("inference", [True, False])
def test_forward_logits_and_aux_match_jax(both, inference):
    """Drop-free (``inference``) and at capacity, the logits at 3e-4 and
    the aux losses summed over the MoE layers as JAX sums them."""
    cfg, jcfg, jparams, params = both
    toks = _toks(cfg.vocab, 2, 24, seed=10)
    want, jaux = jax_registry.build(jcfg).forward(
        jparams, {"tokens": jnp.asarray(toks)}, inference=inference)
    got, aux = registry.build(cfg).forward(
        params, {"tokens": torch.from_numpy(toks)}, inference=inference)
    assert got.dtype == torch.float32
    _close(got, want, TOL)
    assert sorted(aux) == sorted(jaux) == sorted(transformer.MOE_AUX)
    for k in aux:
        _close(aux[k], jaux[k], AUX_TOL)
    if inference:
        assert float(aux["moe_drop_frac"]) == 0.0


def test_prefill_and_decode_match_jax_and_forward(both):
    """Prefill 16 tokens and decode 4 more: each position's logits match
    JAX's prefill and decode and the port's drop-free forward at 3e-4,
    and every cache leaf holds JAX's (k, v; conv, h)."""
    cfg, jcfg, jparams, params = both
    S, K = 16, 4
    toks = _toks(cfg.vocab, 2, S + K, seed=11)
    jmodel, model = jax_registry.build(jcfg), registry.build(cfg)
    full, _ = model.forward(params, {"tokens": torch.from_numpy(toks)},
                            inference=True)
    jcache, _ = split(jmodel.init_cache(2, 32))
    jlogits, jcache = jmodel.prefill(jparams, jcache,
                                     {"tokens": jnp.asarray(toks[:, :S])})
    cache = model.init_cache(2, 32)
    logits, cache = model.prefill(params, cache,
                                  {"tokens": torch.from_numpy(toks[:, :S])})
    _close(logits[:, 0], jlogits[:, 0], TOL)
    _close(logits[:, 0], full[:, S - 1].numpy(), TOL)
    for t in range(S, S + K):
        jlogits, jcache = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, t])})
        logits, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, t])})
        _close(logits, jlogits, TOL)
        _close(logits, full[:, t].numpy(), TOL)
    assert int(cache["pos"]) == S + K
    kinds = set()
    for slot, jslot in zip(cache["slots"], jcache["slots"]):
        assert sorted(slot) == sorted(jslot)
        for name, buf in slot.items():
            _close(buf, jslot[name], TOL)
        kinds |= set(slot)
    assert {"k", "v"} <= kinds
    assert ({"conv", "h"} <= kinds) == (cfg.ssm is not None)


# ---------------------------------------------------------------------------
# training: the attention-free MoE hybrid
# ---------------------------------------------------------------------------
def _free_moe(get, cf):
    cfg = dataclasses.replace(get("jamba-1.5-large-398b"), n_heads=0,
                              n_kv_heads=0, attn_every=0).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_loss_fn_loss_metrics_and_grads_match_jax(cf):
    """``loss_fn`` (remat on, MoE at capacity: the config's factor 1.25,
    and 0.5, where slots drop) on Mamba + MLP, then Mamba + MoE: the loss
    and the averaged router metrics against JAX's, and every leaf's
    gradient against ``jax.grad`` of JAX's loss."""
    cfg, jcfg = _free_moe(get_arch, cf), _free_moe(jax_get_arch, cf)
    assert [cfg.layer_is_moe(i) for i in range(cfg.n_layers)] == [False,
                                                                  True]
    tree = _np_tree(jcfg)
    toks = _toks(cfg.vocab, 2, 24, seed=17)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jax_steps.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    params = convert.params_from_numpy(tree)
    for p in tree_leaves(params):
        p.requires_grad_()
    loss, metrics = steps.loss_fn(params, cfg,
                                  {"tokens": torch.from_numpy(toks)})
    got = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        _close(metrics[k], jmetrics[k], AUX_TOL)
    assert (float(metrics["moe_drop_frac"]) > 0.0) == (cf < 1)
    want = [t.numpy() for t in tree_leaves(convert.params_from_numpy(
        jax.tree.map(np.asarray, jgrads)))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


#: every step's loss and grad norm against JAX's trainer
#: (tests/test_torch_lm_train.py's bands)
STEP_LOSS_TOL = dict(rtol=1e-4, atol=0)
STEP_GNORM_TOL = dict(rtol=1e-3, atol=0)
#: the router's drop share is a count over a count, averaged over the MoE
#: layers: equal in both packages to f32 rounding (a few ulps: the
#: layers are summed in another order)
DROP_TOL = dict(rtol=1e-6, atol=0)


def test_eight_trainer_steps_match_jax(monkeypatch):
    """The trainer's own schedule at ``--steps 8`` (warmup 8 // 10 = 0,
    lr 3e-3, AdamW), which the card's training phases run: the port's
    ``launch.train.train`` on reduced OLMoE from the JAX package's
    ``init_params`` against JAX's trainer loop, every step's loss, grad norm
    and router drop share (ROADMAP Queue 3, gap 2; the card's X5 share
    rose from 0.358 to 0.750 over 8 steps)."""
    cfg, jcfg = (get("olmoe-1b-7b").reduced() for get in (get_arch,
                                                          jax_get_arch))
    theirs, mine = torch_trainer.run_both(jcfg, cfg, monkeypatch)
    assert len(theirs) == len(mine) == 8
    for t, m in zip(theirs, mine):
        np.testing.assert_allclose(m["loss"], t["loss"], **STEP_LOSS_TOL)
        np.testing.assert_allclose(m["grad_norm"], t["grad_norm"],
                                   **STEP_GNORM_TOL)
        np.testing.assert_allclose(m["moe_drop_frac"], t["moe_drop_frac"],
                                   **DROP_TOL)
    assert any(t["moe_drop_frac"] > 0 for t in theirs)


# ---------------------------------------------------------------------------
# the slot engine under faults
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-1.5-large-398b"])
def test_chaos_seed_on_moe_families(arch):
    """Chaos seed 0 (poisoned lanes, a prefill fault, a slow burst, a
    flood) on the reduced MoE families: healthy lanes equal the fault-free
    run token for token, the pools never reallocate, and JAX's engine
    under the same plan retires the same requests with the same tokens."""
    pair = faults_tests._pair(lambda get: get(arch).reduced())
    jmodel, plain, model, params = pair
    from repro_torch.serving import EngineConfig, SlotEngine
    results = SlotEngine(model, params, config=EngineConfig(
        n_slots=2, max_seq=64, queue_capacity=8)).serve(
            faults_tests._requests())
    want = faults_tests.JaxSlotEngine(jmodel, plain, config=faults_tests
                                      .JaxEngineConfig(
                                          n_slots=2, max_seq=64,
                                          queue_capacity=8)).serve(
        faults_tests._jax_requests())
    faults_tests._same_results(results, want)
    baseline = {r.uid: r.tokens for r in results}
    faults_tests._chaos_property(pair, baseline, 0, against_jax=True)


# ---------------------------------------------------------------------------
# init_params: each stacked leaf filled group by group
# ---------------------------------------------------------------------------
def _stacked_build(cfg, gen):
    """The build ``init_params`` replaced: every group of a slot drawn,
    then stacked (twice the slot's size at its peak)."""
    dtype = getattr(torch, cfg.dtype)
    p = {"embed": transformer.common.init_embedding(gen, cfg.vocab,
                                                    cfg.d_model, dtype,
                                                    "cpu"), "blocks": []}
    for slot in range(cfg.period):
        groups = [transformer._init_slot(gen, cfg, slot, dtype, "cpu")
                  for _ in range(cfg.n_layers // cfg.period)]
        p["blocks"].append(tree_map(lambda *ts: torch.stack(ts), *groups))
    p["final_norm"] = transformer.common.init_norm(cfg.d_model, cfg.norm,
                                                   torch.float32, "cpu")
    if not cfg.tie_embeddings:
        p["lm_head"] = transformer.common.init_linear(gen, cfg.d_model,
                                                      cfg.vocab, dtype, "cpu")
    return p


@pytest.mark.parametrize("name", ["qwen2-0.5b", "olmoe-1b-7b",
                                  "jamba-1.5-large-398b"])
def test_init_params_fills_groups_as_the_stack_did(name):
    """The same seed gives the same parameters bit for bit, in the same
    tree, as drawing every group and stacking them (2 groups of 1 slot
    for Qwen2 and OLMoE; Jamba's 8 slots of 1 group, MoE among them)."""
    cfg = get_arch(name).reduced()
    got = transformer.init_params(cfg, torch.Generator().manual_seed(5))
    want = _stacked_build(cfg, torch.Generator().manual_seed(5))
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)
