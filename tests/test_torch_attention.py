"""The port's dense attention path (``repro_torch.models.attention``,
``common.apply_rope``, the attention slots of ``transformer``) against the
JAX package on the CPU, on ``qwen2-0.5b-reduced`` (QKV biases, tied
embeddings, rope theta 1e6) and ``yi-9b-reduced`` (no biases): d_model
256, 4 query heads over 2 kv heads of 64, 2 layers, vocab 512, f32.

Parameters come from the JAX ``init_params`` through ``split`` and
``convert``, with the zero-initialised QKV biases and the unit norm scales
drawn at random (the same numbers on both sides): the JAX init zeroes the
biases, so drawn weights alone never exercise them.  The port's attention
runs its plans ``flash_prefill`` and ``decode_attn`` (on the CPU the
kernels' plain versions) or the plain ``blocked`` and ``einsum``; the JAX
model runs its jnp ``flash_attention`` and grouped decode contractions.
The model-level tolerance is tests/test_consistency.py's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert, steps  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import attention, common, registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

ARCHS = ("qwen2-0.5b-reduced", "yi-9b-reduced")
#: layer-level agreement of the same f32 math in two frameworks
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
#: tests/test_consistency.py's model-level tolerance
TOL = dict(rtol=3e-4, atol=3e-4)
PERTURB = {"bq", "bk", "bv", "scale"}


def _perturb(tree, rng, key=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng, key) for v in tree)
    a = np.asarray(tree)
    if key in PERTURB:
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


def _cfgs(name, **overrides):
    return (dataclasses.replace(get_arch(name), **overrides),
            dataclasses.replace(jax_get_arch(name), **overrides))


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """(config, JAX config, JAX params, the port's params), f32."""
    cfg, jcfg = _cfgs(request.param)
    plain, _ = split(jax_registry.build(jcfg).init(jax.random.PRNGKey(0)))
    tree = _perturb(jax.tree.map(np.asarray, plain),
                    np.random.default_rng(0))
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), \
        convert.params_from_numpy(tree)


def _layer(jparams, params):
    """Layer 0's attention parameters in both packages."""
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mix"])
    return jp, transformer._layer(params["blocks"][0]["mix"], 0)


def _rand(*shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _toks(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "yi-9b", "stablelm-12b",
                                  "command-r-35b"])
def test_configs_are_the_jax_configs(name):
    for suffix in ("", "-reduced"):
        assert dataclasses.asdict(get_arch(name + suffix)) == \
            dataclasses.asdict(jax_get_arch(name + suffix))


def test_init_params_has_the_jax_tree(both):
    cfg, _, jparams, _ = both
    mine = registry.build(cfg).init(torch.Generator().manual_seed(0))
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(mine)] == \
        [(tuple(t.shape), t.dtype) for t in tree_leaves(want)]
    mix = transformer._layer(mine["blocks"][0]["mix"], 0)
    assert ("bq" in mix) == cfg.qkv_bias
    if cfg.qkv_bias:
        assert not any(bool(mix[b].any()) for b in ("bq", "bk", "bv"))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    x = _rand(2, 40, 3, 64, seed=1)
    positions = np.broadcast_to(np.arange(40), (2, 40))
    _close(common.rope_freqs(64, theta), jax_common.rope_freqs(64, theta))
    _close(common.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(positions.copy()), theta),
           jax_common.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                                 theta))
    pos = np.array([[7], [33]])                   # decode: a position a lane
    _close(common.apply_rope(torch.from_numpy(x[:, :1]),
                             torch.from_numpy(pos), theta),
           jax_common.apply_rope(jnp.asarray(x[:, :1]), jnp.asarray(pos),
                                 theta))


def test_linear_bias_matches_jax():
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal((8, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    x = _rand(3, 8, seed=3)
    _close(common.apply_linear(convert.params_from_numpy(p),
                               torch.from_numpy(x)),
           jax_common.apply_linear(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x)))
    lin = common.init_linear(torch.Generator().manual_seed(0), 8, 5,
                             torch.float32, bias=True)
    assert lin["b"].shape == (5,) and not bool(lin["b"].any())


def test_qkv_matches_jax_with_random_biases(both):
    cfg, _, jparams, params = both
    jp, p = _layer(jparams, params)
    x = _rand(2, 9, cfg.d_model, seed=4)
    for got, want in zip(attention._qkv(p, torch.from_numpy(x)),
                         jax_attention._qkv(jp, jnp.asarray(x))):
        _close(got, want)


@pytest.mark.parametrize("plan", ["flash_prefill", "blocked"])
@pytest.mark.parametrize("window", [0, 8])
def test_apply_attention_matches_jax(both, plan, window, monkeypatch):
    cfg, jcfg, jparams, params = both
    cfg, jcfg = (dataclasses.replace(c, sliding_window=window)
                 for c in (cfg, jcfg))
    monkeypatch.setattr(attention, "PREFILL_PLAN", plan)
    jp, p = _layer(jparams, params)
    x = _rand(2, 24, cfg.d_model, seed=5)
    positions = np.broadcast_to(np.arange(24), (2, 24)).copy()
    want = jax_attention.apply_attention(jp, jnp.asarray(x), jcfg,
                                         jnp.asarray(positions))
    got = attention.apply_attention(p, torch.from_numpy(x), cfg,
                                    torch.from_numpy(positions))
    _close(got, want)


def test_blocked_plan_checks_its_blocks():
    q = torch.zeros(1, 600, 2, 16)
    with pytest.raises(ValueError, match="multiple of the blocks"):
        attention.flash_attention(q, q, q)


def _jax_cache(jcfg, B, max_seq):
    """Layer 0's zero cache slot of the JAX model, as numpy."""
    c, _ = split(jax_attention.init_cache_slot(jcfg, 1, B, max_seq,
                                               jnp.float32))
    return {k: np.asarray(v)[0] for k, v in c.items()}


CACHES = {"full": {}, "ring": dict(sliding_window=8),
          "int8": dict(kv_quant=True)}


@pytest.mark.parametrize("layout", sorted(CACHES))
def test_prefill_cache_matches_jax(both, layout):
    """The roped k and the v of a prefill segment land in the same slots
    with the same values (int8 codes and scales with ``kv_quant``)."""
    cfg, jcfg, jparams, params = both
    cfg, jcfg = (dataclasses.replace(c, **CACHES[layout]) for c in (cfg, jcfg))
    jp, p = _layer(jparams, params)
    x = _rand(2, 13, cfg.d_model, seed=6)
    positions = np.broadcast_to(np.arange(13), (2, 13)).copy()
    jc = _jax_cache(jcfg, 2, 16)
    want = jax_attention.prefill_cache(jp, jnp.asarray(x), jax.tree.map(
        jnp.asarray, jc), jcfg, jnp.asarray(positions))
    cache = convert.params_from_numpy(jc)
    out = attention.prefill_cache(p, torch.from_numpy(x), cache, cfg,
                                  torch.from_numpy(positions))
    assert out is cache and set(cache) == set(want)
    for name in cache:
        assert cache[name].dtype == convert.params_from_numpy(
            np.asarray(want[name])).dtype
        _close(cache[name], want[name])


@pytest.mark.parametrize("layout,plan", [("full", "decode_attn"),
                                         ("full", "einsum"),
                                         ("ring", "decode_attn"),
                                         ("int8", "decode_attn")])
def test_decode_attention_matches_jax(both, layout, plan, monkeypatch):
    """One token at a position per lane against a cache a prefill of 10
    wrote: the output and the written slot match JAX's.  A full cache runs
    the decode plan (K9's plain version, or the grouped contractions); a
    ring and an int8 cache always run the contractions."""
    cfg, jcfg, jparams, params = both
    cfg, jcfg = (dataclasses.replace(c, **CACHES[layout]) for c in (cfg, jcfg))
    monkeypatch.setattr(attention, "DECODE_PLAN", plan)
    jp, p = _layer(jparams, params)
    x = _rand(2, 10, cfg.d_model, seed=7)
    positions = np.broadcast_to(np.arange(10), (2, 10)).copy()
    jc = jax_attention.prefill_cache(
        jp, jnp.asarray(x), jax.tree.map(jnp.asarray, _jax_cache(jcfg, 2, 16)),
        jcfg, jnp.asarray(positions))
    cache = convert.params_from_numpy(jax.tree.map(np.asarray, jc))
    for pos in (np.int32(10), np.array([10, 12], np.int32)):
        xt = _rand(2, 1, cfg.d_model, seed=8 + int(np.sum(pos)))
        want, jc = jax_attention.decode_attention(jp, jnp.asarray(xt), jc,
                                                  jnp.asarray(pos), jcfg)
        got = attention.decode_attention(p, torch.from_numpy(xt), cache,
                                         torch.from_numpy(np.asarray(pos)),
                                         cfg)
        assert got.shape == (2, 1, cfg.d_model)
        _close(got, want)
        for name in cache:
            _close(cache[name], jc[name])


def test_quantize_matches_jax():
    x = _rand(4, 8, 64, seed=9, scale=3.0)
    q, s = attention._quantize(torch.from_numpy(x))
    jq, js = jax_attention._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(s, js)
    _close(attention._dequant(q, s, torch.float32),
           jax_attention._dequant(jq, js, jnp.float32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plan", ["flash_prefill", "blocked"])
def test_forward_matches_jax(both, plan, monkeypatch):
    cfg, jcfg, jparams, params = both
    monkeypatch.setattr(attention, "PREFILL_PLAN", plan)
    toks = _toks(cfg, 2, 24, seed=10)
    want, _ = jax_registry.build(jcfg).forward(jparams,
                                               {"tokens": jnp.asarray(toks)})
    got, aux = registry.build(cfg).forward(params,
                                           {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and aux == {}
    _close(got, want, TOL)


def _prefill_and_decode(cfg, jcfg, jparams, params, toks, S):
    """Prefill ``S`` tokens and decode the rest in both packages: the
    port's and JAX's logits of each step and their caches."""
    jmodel, model = jax_registry.build(jcfg), registry.build(cfg)
    jcache, _ = split(jmodel.init_cache(2, 32))
    jlogits, jcache = jmodel.prefill(jparams, jcache,
                                     {"tokens": jnp.asarray(toks[:, :S])})
    cache = model.init_cache(2, 32)
    logits, cache = model.prefill(params, cache,
                                  {"tokens": torch.from_numpy(toks[:, :S])})
    steps_ = [(logits[:, 0], jlogits[:, 0])]
    for t in range(S, toks.shape[1]):
        jlogits, jcache = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, t])})
        logits, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, t])})
        steps_.append((logits, jlogits))
    assert int(cache["pos"]) == toks.shape[1]
    return steps_, cache, jcache


@pytest.mark.parametrize("overrides", [{}, dict(sliding_window=8)],
                         ids=["full", "ring"])
def test_prefill_and_decode_match_jax_and_forward(both, overrides):
    """Prefill 16 tokens and decode 4 more (tests/test_consistency.py's
    shape): each position's logits match JAX's prefill and decode and the
    port's own full forward (windowed as the cache is), and the caches
    hold JAX's k and v."""
    cfg, jcfg, jparams, params = both
    cfg, jcfg = (dataclasses.replace(c, **overrides) for c in (cfg, jcfg))
    S, K = 16, 4
    toks = _toks(cfg, 2, S + K, seed=11)
    full, _ = registry.build(cfg).forward(params,
                                          {"tokens": torch.from_numpy(toks)})
    steps_, cache, jcache = _prefill_and_decode(cfg, jcfg, jparams, params,
                                                toks, S)
    for t, (logits, jlogits) in enumerate(steps_):
        _close(logits, jlogits, TOL)
        _close(logits, full[:, S - 1 + t], TOL)
    for name, buf in cache["slots"][0].items():
        _close(buf, jcache["slots"][0][name], TOL)


def test_kv_quant_prefill_and_decode_match_jax(both):
    """The int8 cache (tests/test_kv_quant.py): the prefill's logits match
    JAX's at TOL and its int8 codes are JAX's to within one step (a code is
    a rounding of an f32 value both packages compute to within ~1e-6, so
    a value at a rounding tie may land one step apart), its scales JAX's;
    the decode logits match JAX's int8 decode to within one int8 step of
    their scale (max|logit| / 127: what one code apart can move), and the
    full model's within test_kv_quant's 8% of their scale."""
    cfg, jcfg, jparams, params = both
    cfg_q, jcfg_q = (dataclasses.replace(c, kv_quant=True)
                     for c in (cfg, jcfg))
    S, K = 16, 4
    toks = _toks(cfg, 2, S + K, seed=11)
    steps_, cache, jcache = _prefill_and_decode(cfg_q, jcfg_q, jparams,
                                                params, toks, S)
    _close(*steps_[0], TOL)
    slot, jslot = cache["slots"][0], jcache["slots"][0]
    for name in ("k", "v"):
        assert slot[name].dtype == torch.int8
        diff = np.abs(slot[name].numpy().astype(int)
                      - np.asarray(jslot[name]).astype(int))
        assert diff.max() <= 1 and diff.mean() < 1e-3
    for name in ("k_scale", "v_scale"):
        _close(slot[name], jslot[name], TOL)
    full, _ = registry.build(cfg).forward(params,
                                          {"tokens": torch.from_numpy(toks)})
    for t, (logits, jlogits) in enumerate(steps_[1:]):
        want = np.asarray(jlogits)
        step = np.abs(want).max() / 127.0
        assert np.abs(logits.numpy() - want).max() <= step
        f = full[:, S + t]
        assert float((logits - f).abs().max() / f.abs().max()) < 0.08


def test_window_equals_full_when_window_covers_seq(both):
    cfg, _, _, params = both
    toks = torch.from_numpy(_toks(cfg, 2, 24, seed=12))
    a, _ = registry.build(dataclasses.replace(cfg, sliding_window=64)
                          ).forward(params, {"tokens": toks})
    b, _ = registry.build(cfg).forward(params, {"tokens": toks})
    _close(a, b, TOL)


def test_decode_writes_the_cache_in_place(both):
    """A decode step writes one slot of each layer's k and v buffers and
    copies no cache: the buffers are the ones the prefill wrote."""
    cfg, _, _, params = both
    model = registry.build(cfg)
    cache = model.init_cache(2, 32)
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    toks = torch.from_numpy(_toks(cfg, 2, 9, seed=13))
    _, cache = model.prefill(params, cache, {"tokens": toks[:, :8]})
    before = cache["slots"][0]["k"].clone()
    _, cache = model.decode_step(params, cache, {"tokens": toks[:, 8]})
    assert [t.data_ptr() for t in tree_leaves(cache)] == ptrs
    k = cache["slots"][0]["k"]
    assert torch.equal(k[:, :, :8], before[:, :, :8])
    assert bool(k[:, :, 8].any()) and not bool(k[:, :, 9:].any())


def test_training_through_attention_raises_naming_its_roadmap_item(both):
    cfg, _, _, params = both
    toks = torch.from_numpy(_toks(cfg, 2, 8, seed=14))
    trainable = convert.params_from_numpy(convert.params_to_numpy(params))
    for t in tree_leaves(trainable):
        t.requires_grad_()
    with pytest.raises(NotImplementedError,
                       match='ROADMAP Queue 1, "Attention training"'):
        registry.build(cfg).forward(trainable, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="Attention training"):
        steps.loss_fn(params, cfg, {"tokens": toks})
    with torch.no_grad():                          # inference still runs
        logits, _ = registry.build(cfg).forward(trainable, {"tokens": toks})
    assert bool(torch.isfinite(logits).all())
