"""The dense GQA models with LayerNorm (StableLM-2-12B, Command-R-35B) and
the long-context ring layout, the port against the JAX package on the CPU.

The two LayerNorm archs at their reduced width (d_model 256, 2 layers,
f32) with their served head shapes kept where ``reduced()`` would cut
them to 4/2 x 64: StableLM-shaped 4/1 query heads of 160, Command-R-shaped
8/1 of 128 with its tied 256k-entry head (reduced to the vocab of 512)
and rope theta 8e6.  The same ``dataclasses.replace`` on both sides;
weights from JAX's ``init_params`` through ``convert``, the norms' scales
and biases (LayerNorm's are ones and zeros as drawn) set at random, the
same numbers on both sides.  Held: the forward on both prefill plans,
prefill plus decode on the full cache (and on a ring of 8), the wave and
slot engines' greedy tokens against JAX's engines, the ``long_500k``
layout (``config_for_shape``'s window, reduced to 64) on a prompt longer
than the ring and a decode that wraps it, against JAX's ``decode_step``,
and the accounting of the served layouts.  The entry points' parsers
default as the JAX package's do.  Tolerances: tests/test_consistency.py's
3e-4 for the models, as tests/test_torch_attention.py holds them."""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import analysis as jax_analysis  # noqa: E402
from repro import serving as jax_serving  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import analysis, convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.models import attention, registry  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, Request,  # noqa: E402
                                 SlotEngine)

#: tests/test_consistency.py's model-level tolerance
TOL = dict(rtol=3e-4, atol=3e-4)
#: the served head shapes at the reduced width
SHAPED = {"stablelm-12b": dict(n_heads=4, n_kv_heads=1, head_dim=160),
          "command-r-35b": dict(n_heads=8, n_kv_heads=1, head_dim=128)}
PERTURB = {"scale", "bias"}


def _cfgs(name: str, window: int = 0):
    """(port config, JAX config): ``name`` reduced with its served heads,
    and with ``window`` the ``long_500k`` layout (``config_for_shape`` on
    the full config, its window reduced to ``window``)."""
    out = []
    for get, reg, shapes in ((get_arch, registry, INPUT_SHAPES),
                             (jax_get_arch, jax_registry, JAX_SHAPES)):
        cfg = get(name)
        if window:
            cfg = reg.config_for_shape(cfg, shapes["long_500k"])
        cfg = cfg.reduced()
        if window:
            assert cfg.sliding_window == min(reg.LONG_CONTEXT_WINDOW, 64)
            cfg = dataclasses.replace(cfg, sliding_window=window)
        out.append(dataclasses.replace(cfg, **SHAPED.get(name, {})))
    return tuple(out)


def _perturb(tree, rng, key=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng, key) for v in tree)
    a = np.asarray(tree)
    if key in PERTURB:
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


def _params(jcfg):
    """(JAX params, the port's params): JAX's draw, norms perturbed."""
    plain, _ = split(jax_registry.build(jcfg).init(jax.random.PRNGKey(0)))
    tree = _perturb(jax.tree.map(np.asarray, plain),
                    np.random.default_rng(0))
    return jax.tree.map(jnp.asarray, tree), convert.params_from_numpy(tree)


@pytest.fixture(scope="module", params=sorted(SHAPED))
def both(request):
    """(config, JAX config, JAX params, the port's params), f32."""
    cfg, jcfg = _cfgs(request.param)
    return (cfg, jcfg, *_params(jcfg))


def _toks(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_the_served_shapes_are_kept(both):
    """LayerNorm (a scale and a bias a norm), the served heads, and for
    Command-R its tied head (no ``lm_head``) and rope theta 8e6."""
    cfg, jcfg, jparams, params = both
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.norm == "ln" and set(params["final_norm"]) == {"scale",
                                                              "bias"}
    mix = params["blocks"][0]["mix"]
    assert tuple(mix["wq"].shape[-2:]) == (cfg.n_heads, cfg.head_dim)
    assert tuple(mix["wk"].shape[-2:]) == (cfg.n_kv_heads, cfg.head_dim)
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    if cfg.name.startswith("command-r"):
        assert cfg.tie_embeddings and cfg.rope_theta == 8e6
    assert float(params["final_norm"]["bias"].abs().max()) > 0


@pytest.mark.parametrize("plan", ["flash_prefill", "blocked"])
def test_forward_matches_jax(both, plan, monkeypatch):
    cfg, jcfg, jparams, params = both
    monkeypatch.setattr(attention, "PREFILL_PLAN", plan)
    toks = _toks(cfg, 2, 24, seed=10)
    want, _ = jax_registry.build(jcfg).forward(jparams,
                                               {"tokens": jnp.asarray(toks)})
    got, _ = registry.build(cfg).forward(params,
                                         {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, cfg.vocab)
    _close(got, want)


def _prefill_and_decode(cfg, jcfg, jparams, params, toks, S, max_seq=32):
    """Prefill ``S`` tokens and decode the rest in both packages: the
    pairs of (port, JAX) logits of the prefill and of each step, and the
    two caches."""
    jmodel, model = jax_registry.build(jcfg), registry.build(cfg)
    jcache, _ = split(jmodel.init_cache(2, max_seq))
    jlogits, jcache = jmodel.prefill(jparams, jcache,
                                     {"tokens": jnp.asarray(toks[:, :S])})
    cache = model.init_cache(2, max_seq)
    logits, cache = model.prefill(params, cache,
                                  {"tokens": torch.from_numpy(toks[:, :S])})
    pairs = [(logits[:, 0], jlogits[:, 0])]
    for t in range(S, toks.shape[1]):
        jlogits, jcache = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, t])})
        logits, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, t])})
        pairs.append((logits, jlogits))
    assert int(cache["pos"]) == toks.shape[1]
    return pairs, cache, jcache


@pytest.mark.parametrize("window", [0, 8], ids=["full", "ring"])
def test_prefill_and_decode_match_jax_and_forward(both, window):
    """Prefill 16 tokens, decode 4: each position's logits match JAX's
    and the port's own forward (windowed as the cache is); the caches
    hold JAX's k and v."""
    cfg, jcfg, jparams, params = both
    cfg, jcfg = (dataclasses.replace(c, sliding_window=window)
                 for c in (cfg, jcfg))
    S = 16
    toks = _toks(cfg, 2, S + 4, seed=11)
    full, _ = registry.build(cfg).forward(params,
                                          {"tokens": torch.from_numpy(toks)})
    pairs, cache, jcache = _prefill_and_decode(cfg, jcfg, jparams, params,
                                               toks, S)
    for t, (logits, jlogits) in enumerate(pairs):
        _close(logits, jlogits)
        _close(logits, full[:, S - 1 + t])
    for name, buf in cache["slots"][0].items():
        _close(buf, jcache["slots"][0][name])


def _requests(vocab, make, seed=4):
    rng = np.random.default_rng(seed)
    lens, news = (9, 5, 13, 7, 11), (4, 6, 3, 5, 4)
    return [make(i, rng.integers(0, vocab, (n,)).astype(np.int32),
                 max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


def test_wave_engine_tokens_equal_the_jax_engine(both):
    """Ragged prompts left-padded in waves of 2 (a short wave filled with
    an inactive lane): greedy tokens equal to the JAX engine's; the pool
    at capacity."""
    cfg, jcfg, jparams, params = both
    want = jax_serving.Engine(
        jax_registry.build(jcfg), jparams,
        config=jax_serving.EngineConfig(n_slots=2, max_seq=32)).serve(
            _requests(cfg.vocab, jax_serving.Request))
    engine = Engine(registry.build(cfg), params,
                    config=EngineConfig(n_slots=2, max_seq=32))
    got = engine.serve(_requests(cfg.vocab, Request))
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    assert engine.pool.stats.buffers_built == engine.pool.stats.capacity


def test_slot_engine_tokens_equal_the_jax_engine(both):
    """Continuous batching over 2 slots (whole-prompt admission, lanes
    freed and refilled): tokens and finish reasons equal to the JAX slot
    engine's."""
    cfg, jcfg, jparams, params = both
    want = jax_serving.SlotEngine(
        jax_registry.build(jcfg), jparams,
        config=jax_serving.EngineConfig(n_slots=2, max_seq=32,
                                        queue_capacity=8)).serve(
            _requests(cfg.vocab, jax_serving.Request))
    engine = SlotEngine(registry.build(cfg), params, config=EngineConfig(
        n_slots=2, max_seq=32, queue_capacity=8))
    got = engine.serve(_requests(cfg.vocab, Request))
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert g.finish_reason == w.finish_reason
    assert engine.pool.stats.buffers_built == engine.pool.stats.capacity


# ---------------------------------------------------------------------------
# the long-context layout: a ring of the window's slots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen2-0.5b", *sorted(SHAPED)])
def test_long_context_ring_matches_jax(name):
    """``config_for_shape(arch, long_500k)`` at the reduced window of 64:
    a 120-token prompt into the 64-slot ring (only its last 64 positions
    kept), then 16 decode steps (positions 120 to 135: the ring wraps
    from slot 63 to 0): every step's logits and the ring's k and v match
    JAX's prefill and ``decode_step``, and the port's logits its own
    forward under the same window."""
    cfg, jcfg = _cfgs(name, window=64)
    jparams, params = _params(jcfg)
    S, K = 120, 16
    toks = _toks(cfg, 2, S + K, seed=12)
    pairs, cache, jcache = _prefill_and_decode(cfg, jcfg, jparams, params,
                                               toks, S, max_seq=S + K)
    slot = cache["slots"][0]
    assert slot["k"].shape[2] == 64
    full, _ = registry.build(cfg).forward(params,
                                          {"tokens": torch.from_numpy(toks)})
    for t, (logits, jlogits) in enumerate(pairs):
        _close(logits, jlogits)
        _close(logits, full[:, S - 1 + t])
    for k, buf in slot.items():
        _close(buf, jcache["slots"][0][k])


@pytest.mark.parametrize("name", ["qwen2-0.5b", "yi-9b", *sorted(SHAPED)])
@pytest.mark.parametrize("layout", ["long_500k", "int8"])
def test_served_layouts_accounting_equals_jax(name, layout):
    """``analysis.cache_bytes`` and ``analytic_costs`` of the ring and int8
    layouts at full width equal JAX's; the ring holds the window's
    positions and no more, the int8 cache under 0.6x the bf16 one."""
    cfg, jcfg = get_arch(name), jax_get_arch(name)
    if layout == "long_500k":
        cfg = registry.config_for_shape(cfg, INPUT_SHAPES["long_500k"])
        jcfg = jax_registry.config_for_shape(jcfg, JAX_SHAPES["long_500k"])
        assert cfg.sliding_window == jcfg.sliding_window == 8192
    else:
        cfg, jcfg = (dataclasses.replace(c, kv_quant=True)
                     for c in (cfg, jcfg))
    for shape, jshape in ((INPUT_SHAPES[k], JAX_SHAPES[k])
                          for k in ("decode_32k", "long_500k")):
        B, S = shape.global_batch, shape.seq_len
        assert analysis.cache_bytes(cfg, B, S) == \
            jax_analysis.cache_bytes(jcfg, B, S)
        assert analysis.analytic_costs(cfg, shape) == \
            jax_analysis.analytic_costs(jcfg, jshape)
    if layout == "long_500k":
        assert analysis.cache_bytes(cfg, 1, 524_288) == \
            analysis.cache_bytes(cfg, 1, 8192)
    else:
        full = dataclasses.replace(cfg, kv_quant=False)
        assert analysis.cache_bytes(cfg, 2, 4096) < \
            0.6 * analysis.cache_bytes(full, 2, 4096)


# ---------------------------------------------------------------------------
# the entry points' defaults
# ---------------------------------------------------------------------------
PARSE_ARGS = argparse.ArgumentParser.parse_args


def _defaults(main, argv, monkeypatch) -> dict:
    """The parsed defaults of an entry point's parser: ``main`` stops at
    its ``parse_args`` (called with ``argv`` or, for the JAX package's
    entry points, which parse ``sys.argv``, with the program name
    alone)."""
    seen = {}

    class Parsed(Exception):
        pass

    def parse(self, args=None, namespace=None):
        seen.update(vars(PARSE_ARGS(self, [] if args is None else args,
                                    namespace)))
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    monkeypatch.setattr("sys.argv", ["prog"])
    with pytest.raises(Parsed):
        main(*argv)
    return seen


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_entry_point_defaults_equal_jax(entry, monkeypatch):
    """Every option of the JAX entry point's parser has the same default
    in the port's (``--arch`` qwen2-0.5b); the port's own options
    (``--device``, ``--model-axis``) beside them."""
    import importlib

    jax_main = importlib.import_module(f"repro.launch.{entry}").main
    main = importlib.import_module(f"repro_torch.launch.{entry}").main
    want = _defaults(jax_main, (), monkeypatch)
    got = _defaults(main, ([],), monkeypatch)
    assert want["arch"] == got["arch"] == "qwen2-0.5b"
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) <= {"device", "model_axis"}
    assert got["device"] == "cuda"
