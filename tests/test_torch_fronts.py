"""The port's vision and audio fronts (``repro_torch.models.transformer``'s
``vis_proj``, ``audio_embed`` and ``audio_heads``, ``steps.loss_fn``'s two
targets, the registry's ``config_for_shape``, ``input_specs`` and
``make_batch``, the configs and ``INPUT_SHAPES``) against the JAX package on
the CPU, in f32: ``internvl2-1b-reduced`` (a Qwen2 decoder, d_model 256, 4
query heads over 2 kv heads of 64, 2 layers, 8 vision tokens of 64
projected in front of the text) and ``musicgen-large-reduced`` (4 heads of
64 over 4 kv heads, layer norm, GELU MLP, 4 codebooks of 512 ids, summed
in, 4 heads out).

Parameters come from the JAX ``init_params`` through ``split`` and
``convert``, with the zero- and one-initialised biases and norm scales
perturbed (the same numbers on both sides).  Inputs are drawn with numpy
from a seed.  The forward, prefill and decode are held at
tests/test_consistency.py's 3e-4, gradients at 1e-4 (the attention
family's GRAD_TOL), three AdamW steps at tests/test_torch_lm_train.py's
step tolerances."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro import steps as jax_steps  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import configs, convert, steps  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import common, registry, transformer  # noqa: E402
from repro_torch.optim.adamw import (AdamW, tree_leaves,  # noqa: E402
                                     warmup_cosine)

FRONTS = ("internvl2-1b", "musicgen-large")
#: tests/test_consistency.py's model-level tolerance (test_torch_attention.TOL)
TOL = dict(rtol=3e-4, atol=3e-4)
#: the f32 gradients of a small stack in two frameworks
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
#: three AdamW steps (tests/test_torch_lm_train.py's STEP_LOSS_TOL and
#: STEP_GNORM_TOL)
STEP_LOSS_TOL = dict(rtol=1e-4, atol=0)
STEP_GNORM_TOL = dict(rtol=1e-3, atol=0)
#: the consistency test's split: a prefix, then decode steps
PREFIX, EXTRA = 16, 2
PERTURB = {"bq", "bk", "bv", "b", "scale", "bias"}
SHAPE_KINDS = ("train", "prefill", "decode")


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


def _batch(cfg, B, S, seed):
    """A numpy batch of S text positions: (B, K, S) codebook ids, or (B,
    S) text ids with (B, n_vis, vis_dim) patch embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.n_codebooks:
        return {"tokens": rng.integers(0, cfg.vocab, (B, cfg.n_codebooks, S)
                                       ).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "vis_embeds": rng.standard_normal(
                (B, cfg.n_vis_tokens, cfg.vis_dim)).astype(np.float32)}


def _sliced(batch, stop):
    """The batch's first ``stop`` text positions (every codebook)."""
    return dict(batch, tokens=batch["tokens"][..., :stop])


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port(np_tree, grad=False):
    params = convert.params_from_numpy(np_tree)
    for p in tree_leaves(params):
        p.requires_grad_(grad)
    return params


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module", params=FRONTS)
def front(request):
    """(config, JAX config, perturbed numpy params, a batch of 2 x 24
    text positions)."""
    cfg = get_arch(request.param + "-reduced")
    jcfg = jax_configs.get_arch(request.param + "-reduced")
    return cfg, jcfg, _np_tree(jcfg), _batch(cfg, 2, 24, seed=1)


# ---------------------------------------------------------------------------
# configs, shapes and input specs: the JAX package's, for every arch
# ---------------------------------------------------------------------------
def test_the_port_builds_every_jax_arch():
    assert sorted(configs.ARCHS) == sorted(jax_configs.ARCHS)


@pytest.mark.parametrize("name", sorted(jax_configs.ARCHS))
def test_configs_and_reduced_match_jax(name):
    for variant in ("", "-reduced"):
        got = dataclasses.asdict(get_arch(name + variant))
        want = dataclasses.asdict(jax_configs.get_arch(name + variant))
        assert got == want, name + variant


def test_input_shapes_match_jax():
    assert sorted(configs.INPUT_SHAPES) == sorted(jax_configs.INPUT_SHAPES)
    for name, shape in configs.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jax_configs.get_shape(name))
        assert configs.get_shape(name) is shape


@pytest.mark.parametrize("shape", sorted(jax_configs.INPUT_SHAPES))
@pytest.mark.parametrize("name", sorted(jax_configs.ARCHS))
def test_config_for_shape_and_input_specs_match_jax(name, shape):
    """``build(arch, shape)``'s config (the 500k decode's sliding window)
    and every input spec's name, shape and dtype equal the JAX package's,
    at the full config and its reduced variant."""
    for variant in ("", "-reduced"):
        jcfg = jax_configs.get_arch(name + variant)
        cfg = get_arch(name + variant)
        jshape, shp = (jax_configs.get_shape(shape),
                       configs.get_shape(shape))
        jcfg_s = jax_registry.config_for_shape(jcfg, jshape)
        cfg_s = registry.config_for_shape(cfg, shp)
        assert dataclasses.asdict(cfg_s) == dataclasses.asdict(jcfg_s)
        assert registry.build(name + variant, shp).cfg == cfg_s
        want = jax_registry.input_specs(jcfg_s, jshape)
        got = registry.input_specs(cfg_s, shp)
        assert list(got) == list(want)
        for k, spec in got.items():
            assert spec.shape == tuple(want[k].shape), (k, spec)
            assert str(spec.dtype).split(".")[-1] == str(want[k].dtype), k


@pytest.mark.parametrize("kind", SHAPE_KINDS)
@pytest.mark.parametrize("name", sorted(jax_configs.ARCHS))
def test_make_batch_draws_what_input_specs_describe(name, kind):
    """At a small shape of each kind: the JAX package's keys, shapes and
    dtypes; ids in [0, vocab); the same batch again from the same seed."""
    cfg = get_arch(name + "-reduced")
    shape = ShapeConfig("smoke", 33, 2, kind)
    specs = registry.input_specs(cfg, shape)
    batch = registry.make_batch(cfg, shape,
                                torch.Generator().manual_seed(1))
    want = jax_registry.make_batch(jax_configs.get_arch(name + "-reduced"),
                                   shape, jax.random.PRNGKey(1))
    assert list(batch) == list(specs) == list(want)
    for k, t in batch.items():
        assert tuple(t.shape) == specs[k].shape == tuple(want[k].shape)
        assert t.dtype == specs[k].dtype
        if not t.dtype.is_floating_point:
            assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab
    again = registry.make_batch(cfg, shape, torch.Generator().manual_seed(1))
    assert all(torch.equal(batch[k], again[k]) for k in batch)


# ---------------------------------------------------------------------------
# parameters: the JAX tree, carried across; the port's own draw
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FRONTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_jax_tree_and_convert_carries_it(name, dtype):
    """The port's ``init_params`` gives the JAX tree's leaves (names,
    shapes, dtypes; ``audio_embed``/``audio_heads`` in place of
    ``embed``/``lm_head``, ``vis_proj``'s in and out with biases), drawn
    in the JAX scales (|w| <= 2 d_in^-1/2, zero biases); ``convert``
    carries the JAX leaves across bit for bit both ways."""
    cfg = dataclasses.replace(get_arch(name + "-reduced"), dtype=dtype)
    jcfg = dataclasses.replace(jax_configs.get_arch(name + "-reduced"),
                               dtype=dtype)
    plain, _ = split(jax_registry.build(jcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, plain)
    carried = convert.params_from_numpy(tree)
    drawn = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    front_keys = ({"audio_embed", "audio_heads"} if cfg.n_codebooks
                  else {"embed", "vis_proj"})
    assert front_keys <= set(drawn) == set(carried) == set(tree)
    for a, b in zip(tree_leaves(drawn), tree_leaves(carried)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = jax.tree.map(np.asarray, convert.params_to_numpy(carried))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8), b.view(np.uint8))
    d = cfg.d_model
    if cfg.n_codebooks:
        K, V = cfg.n_codebooks, cfg.vocab
        assert tuple(drawn["audio_embed"].shape) == (K, V, d)
        assert tuple(drawn["audio_heads"].shape) == (K, d, V)
        for w in (drawn["audio_embed"], drawn["audio_heads"]):
            assert float(w.float().abs().max()) <= 2 * d ** -0.5 + 1e-6
    else:
        vp = drawn["vis_proj"]
        assert tuple(vp["in"]["w"].shape) == (cfg.vis_dim, d)
        assert tuple(vp["out"]["w"].shape) == (d, d)
        assert not vp["in"]["b"].any() and not vp["out"]["b"].any()
        assert float(vp["in"]["w"].float().abs().max()) <= \
            2 * cfg.vis_dim ** -0.5 + 1e-6


# ---------------------------------------------------------------------------
# forward, prefill and decode against the JAX package's
# ---------------------------------------------------------------------------
def test_forward_logits_match_jax(front):
    """The full forward's logits: (B, S_text + n_vis, V) for vision,
    (B, K, S, V) for audio, f32, at 3e-4."""
    cfg, jcfg, tree, batch = front
    want, _ = jax_registry.build(jcfg).forward(jax.tree.map(jnp.asarray,
                                                            tree),
                                               _jax(batch))
    got, aux = registry.build(cfg).forward(_port(tree), _torch(batch))
    assert got.dtype == torch.float32 and aux == {}
    assert tuple(got.shape) == tuple(want.shape) == (
        (2, cfg.n_codebooks, 24, cfg.vocab) if cfg.n_codebooks
        else (2, cfg.n_vis_tokens + 24, cfg.vocab))
    _close(got, want, TOL)


def test_prefill_and_decode_match_jax_and_forward(front):
    """Prefill PREFIX text positions (behind the vision prefix, which
    takes the first n_vis cache slots) and decode EXTRA more, tokens (B,)
    or (B, K): each step's logits against JAX's prefill and decode and the
    port's forward(inference=True) over the same positions at 3e-4, and
    every cache leaf against JAX's."""
    cfg, jcfg, tree, batch = front
    jmodel, model = jax_registry.build(jcfg), registry.build(cfg)
    jparams, params = jax.tree.map(jnp.asarray, tree), _port(tree)
    full, _ = model.forward(params, _torch(_sliced(batch, PREFIX + EXTRA)),
                            inference=True)
    jcache, _ = split(jmodel.init_cache(2, 64))
    cache = model.init_cache(2, 64)
    pre = _sliced(batch, PREFIX)
    jlogits, jcache = jmodel.prefill(jparams, jcache, _jax(pre))
    logits, cache = model.prefill(params, cache, _torch(pre))
    off = cfg.n_vis_tokens
    if cfg.n_codebooks:
        assert tuple(logits.shape) == (2, cfg.n_codebooks, 1, cfg.vocab)
        _close(logits, jlogits, TOL)
        _close(logits[:, :, 0], full[:, :, PREFIX - 1].numpy(), TOL)
    else:
        assert tuple(logits.shape) == (2, 1, cfg.vocab)
        _close(logits, jlogits, TOL)
        _close(logits[:, 0], full[:, off + PREFIX - 1].numpy(), TOL)
    assert int(cache["pos"]) == off + PREFIX
    for t in range(PREFIX, PREFIX + EXTRA):
        toks = batch["tokens"][..., t]
        jlogits, jcache = jmodel.decode_step(jparams, jcache,
                                             {"tokens": jnp.asarray(toks)})
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": torch.from_numpy(toks)})
        assert tuple(logits.shape) == tuple(jlogits.shape)
        _close(logits, jlogits, TOL)
        want = (full[:, :, t] if cfg.n_codebooks else full[:, off + t])
        _close(logits, want.numpy(), TOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == off + PREFIX + EXTRA
    for slot, jslot in zip(cache["slots"], jcache["slots"]):
        assert sorted(slot) == sorted(jslot) == ["k", "v"]
        for name, buf in slot.items():
            _close(buf, jslot[name], TOL)


# ---------------------------------------------------------------------------
# training: loss_fn's two targets, remat, AdamW steps
# ---------------------------------------------------------------------------
def test_loss_fn_loss_metrics_and_grads_match_jax(front):
    """``loss_fn`` (remat on): the audio target (every codebook's next
    token) and the vision target (position n_vis - 1 + i predicts text
    token i) give JAX's loss and metrics, and every leaf's gradient
    matches ``jax.grad`` of JAX's loss at 1e-4."""
    cfg, jcfg, tree, batch = front
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.loss_fn(p, jcfg, _jax(batch)), has_aux=True))(
            jax.tree.map(jnp.asarray, tree))
    params = _port(tree, grad=True)
    loss, metrics = steps.loss_fn(params, cfg, _torch(batch))
    got = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics) == ["loss", "xent"]
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), rtol=1e-5)
    want = [t.numpy() for t in tree_leaves(convert.params_from_numpy(
        jax.tree.map(np.asarray, jgrads)))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_loss_fn_targets_are_the_jax_layouts(front):
    """The loss is the mean cross-entropy of the JAX package's target
    slices, computed here by hand from the forward's logits."""
    cfg, _, tree, batch = front
    params = _port(tree)
    logits, _ = transformer.forward(params, cfg, _torch(batch))
    toks = torch.from_numpy(batch["tokens"]).long()
    if cfg.n_codebooks:
        pred, tgt = logits[:, :, :-1], toks[:, :, 1:]
    else:
        pred, tgt = logits[:, cfg.n_vis_tokens - 1:-1], toks
    want = torch.nn.functional.cross_entropy(pred.reshape(-1, cfg.vocab),
                                             tgt.reshape(-1))
    loss, _ = steps.loss_fn(params, cfg, _torch(batch), remat=False)
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)


def test_remat_on_and_off_give_equal_grads(front):
    cfg, _, tree, batch = front
    out = []
    for remat in (True, False):
        params = _port(tree, grad=True)
        loss, _ = steps.loss_fn(params, cfg, _torch(batch), remat=remat)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(params))))
    (loss_on, on), (loss_off, off) = out
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_three_train_steps_match_jax(front):
    cfg, jcfg, tree, _ = front
    batches = [_batch(cfg, 2, 16, seed=20 + i) for i in range(3)]
    jopt = JaxAdamW(lr=jax_warmup_cosine(3e-3, 1, 3))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jax.jit(lambda p, st, b: jax_steps.train_step(jopt, jcfg, p, st,
                                                           b))
    jsteps = []
    for b in batches:
        jparams, jstate, m = jstep(jparams, jstate, _jax(b))
        jsteps.append((float(m["loss"]), float(m["grad_norm"])))
    opt = AdamW(lr=warmup_cosine(3e-3, 1, 3))
    params = _port(tree, grad=True)
    state = opt.init(params)
    for i, b in enumerate(batches):
        params, state, m = steps.train_step(opt, cfg, params, state,
                                            _torch(b))
        np.testing.assert_allclose(float(m["loss"]), jsteps[i][0],
                                   **STEP_LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), jsteps[i][1],
                                   **STEP_GNORM_TOL)
    assert state["step"] == 3


def test_train_step_on_a_make_batch_batch(front):
    """The card's training path for the fronts: ``steps.train_step`` on a
    batch of the port's ``make_batch`` (its ``labels`` ride along unused,
    as in the JAX package): the loss finite, every parameter moved."""
    cfg, _, tree, _ = front
    batch = registry.make_batch(cfg, ShapeConfig("smoke", 32, 2, "train"),
                                torch.Generator().manual_seed(3))
    params = _port(tree, grad=True)
    before = [p.detach().clone() for p in tree_leaves(params)]
    opt = AdamW(lr=1e-3)
    params, _, m = steps.train_step(opt, cfg, params, opt.init(params), batch)
    assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(not torch.equal(a, b.detach())
               for a, b in zip(before, tree_leaves(params)))


@pytest.mark.parametrize("name", FRONTS)
def test_train_main_refuses_the_fronts(name, capsys):
    """``launch/train``'s synthetic pipeline gives text alone, as the JAX
    package's does: ``--arch`` of a front stops before any weights are
    drawn, naming the path that trains it."""
    from repro_torch.launch import train as train_lm

    with pytest.raises(SystemExit) as stop:
        train_lm.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--steps", "1"])
    assert stop.value.code == 2
    assert "registry.make_batch" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the projector's GELU
# ---------------------------------------------------------------------------
def test_bf16_projector_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation, and so does the
    projector: in bf16 the port's vision embedding equals the projector
    computed by hand with ``gelu(approximate="tanh")`` bit for bit, and
    ``common.gelu`` is JAX's GELU (the erf form differs by up to ~5e-4)."""
    cfg = dataclasses.replace(get_arch("internvl2-1b-reduced"),
                              dtype="bfloat16")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _torch(_batch(cfg, 2, 5, seed=3))
    x = transformer.embed_inputs(params, cfg, batch)
    vp = params["vis_proj"]
    v = batch["vis_embeds"].to(torch.bfloat16) @ vp["in"]["w"] + vp["in"]["b"]
    v = torch.nn.functional.gelu(v, approximate="tanh")
    v = v @ vp["out"]["w"] + vp["out"]["b"]
    nv = cfg.n_vis_tokens
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (2, nv + 5,
                                                            cfg.d_model)
    assert torch.equal(x[:, :nv], v)
    assert torch.equal(x[:, nv:], params["embed"][batch["tokens"].long()])
    grid = np.linspace(-6, 6, 2001).astype(np.float32)
    got = common.gelu(torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(grid)),
                               rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(grid)).numpy()
    assert float(np.abs(got - erf).max()) > 1e-4


def test_embed_inputs_matches_jax_in_bf16():
    """Audio and vision embeddings in bf16 against JAX's: the codebooks
    summed onto zeros in bf16, codebook 0 first, bit for bit; the vision
    prefix within one bf16 step of JAX's (two matrix products' own
    summation orders)."""
    for name in FRONTS:
        jcfg = dataclasses.replace(jax_configs.get_arch(name + "-reduced"),
                                   dtype="bfloat16")
        cfg = dataclasses.replace(get_arch(name + "-reduced"),
                                  dtype="bfloat16")
        tree = _np_tree(jcfg)
        batch = _batch(cfg, 2, 6, seed=4)
        want = np.asarray(jax_transformer.embed_inputs(
            jax.tree.map(jnp.asarray, tree), jcfg, _jax(batch)), np.float32)
        got = transformer.embed_inputs(_port(tree), cfg,
                                       _torch(batch)).float().numpy()
        if cfg.n_codebooks:
            assert np.array_equal(got, want)
        else:
            nv = cfg.n_vis_tokens
            assert np.array_equal(got[:, nv:], want[:, nv:])
            np.testing.assert_allclose(got[:, :nv], want[:, :nv],
                                       rtol=2 ** -7, atol=2 ** -7)
