"""The port's serving stack on the vision and audio fronts (the codebook
axis of ``SlotManager.tokens``, ``Result.tokens`` and the engines'
prompts, the vision prefix of every prefill) against the JAX package's
engines on the CPU, in f32, at ``internvl2-1b-reduced`` and
``musicgen-large-reduced``.

Parameters are drawn by the JAX init and carried across with
``convert.params_from_numpy``; the port's greedy tokens, finish reasons
and counters must equal those of the JAX package's ``SlotEngine`` and
wave ``Engine`` on the same requests.  A vision engine's cache is sized
for the prefix too: the JAX engines check a prompt's text alone against
``max_seq``, and a decode past the cache writes nowhere in JAX and is
refused up front in the port."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import serving as jax_serving  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import (FINISH_REASONS, Engine,  # noqa: E402
                                 EngineConfig, FaultPlan, FinishReason,
                                 Request, SlotEngine)

import test_torch_serving_slots as slots_tests  # noqa: E402

JaxSlotEngine = jax_serving.SlotEngine
JaxEngine = jax_serving.Engine
JaxEngineConfig = jax_serving.EngineConfig
FRONTS = ("internvl2-1b", "musicgen-large")
LENS, NEWS = [4, 10, 6, 8], [3, 8, 2, 5]
MAX_SEQ = 32


def _pair(name):
    jmodel = jax_registry.build(jax_get_arch(name + "-reduced"))
    plain, _ = split(jmodel.init(jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    return jmodel, plain, registry.build(get_arch(name + "-reduced")), params


@pytest.fixture(scope="module", params=FRONTS)
def front(request):
    return (request.param, *_pair(request.param))


def _requests(cfg, lens=LENS, news=NEWS, seed=1, cls=Request):
    """(K, S) codebook prompts for audio, (S,) text ones otherwise."""
    rng = np.random.default_rng(seed)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return [cls(i, rng.integers(0, cfg.vocab, tail + (int(n),)).astype(
        np.int32), max_new_tokens=int(m))
        for i, (n, m) in enumerate(zip(lens, news))]


def _both(cfg, **kw):
    return (_requests(cfg, cls=jax_serving.Request, **kw),
            _requests(cfg, **kw))


def _kw(cfg, **extra):
    """Engine settings with room for the vision prefix."""
    return dict(n_slots=2, max_seq=MAX_SEQ + cfg.n_vis_tokens, **extra)


def _same_results(got, want):
    slots_tests._same_results(got, want)
    for g, w in zip(got, want):
        assert g.tokens.shape == np.asarray(w.tokens).shape


def test_slot_engine_matches_jax_whole_prompt(front):
    """Whole-prompt admission: every request's tokens ((K, m) for audio)
    and finish reason equal JAX's slot engine's."""
    name, jmodel, plain, model, params = front
    cfg = model.cfg
    jreqs, reqs = _both(cfg)
    want = JaxSlotEngine(jmodel, plain,
                         config=JaxEngineConfig(**_kw(cfg))).serve(jreqs)
    got = SlotEngine(model, params, config=EngineConfig(**_kw(cfg))
                     ).serve(reqs)
    _same_results(got, want)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    for r, req in zip(got, reqs):
        assert r.finish_reason == FinishReason.LENGTH
        assert r.tokens.shape == tail + (req.max_new_tokens,)


def test_wave_engine_matches_jax(front):
    """The wave engine (waves of 2, left-padded (B, [K,] S) prompts, the
    vision prefix's zero patch embeddings): JAX's wave engine's tokens,
    and at batch 1 the slot engine's."""
    name, jmodel, plain, model, params = front
    cfg = model.cfg
    jreqs, reqs = _both(cfg)
    want = JaxEngine(jmodel, plain,
                     config=JaxEngineConfig(**_kw(cfg))).serve(jreqs)
    got = Engine(model, params, config=EngineConfig(**_kw(cfg))).serve(reqs)
    _same_results(got, want)
    one = Engine(model, params, config=EngineConfig(
        n_slots=1, max_seq=MAX_SEQ + cfg.n_vis_tokens, pool_capacity=1)
        ).serve(reqs)
    slot = SlotEngine(model, params, config=EngineConfig(**_kw(cfg))
                      ).serve(reqs)
    for a, b in zip(one, slot):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_wave_engine_pads_a_short_wave_with_codebook_dummies():
    """Three audio requests in waves of 2: the second wave's dummy lane
    is a (K, 0) prompt; the Results are JAX's, one per request."""
    jmodel, plain, model, params = _pair("musicgen-large")
    cfg = model.cfg
    jreqs, reqs = _both(cfg, lens=[5, 7, 3], news=[4, 2, 3])
    eng = Engine(model, params, config=EngineConfig(**_kw(cfg)))
    assert eng._dummy_request().prompt.shape == (cfg.n_codebooks, 0)
    got = eng.serve(reqs)
    want = JaxEngine(jmodel, plain,
                     config=JaxEngineConfig(**_kw(cfg))).serve(jreqs)
    _same_results(got, want)
    assert [r.tokens.shape for r in got] == [(cfg.n_codebooks, m)
                                             for m in (4, 2, 3)]


def test_chunked_admission_matches_jax_on_audio():
    """MusicGen's chunked admission (chunks of 4, 2 prefill lanes) slices
    every codebook alike: its tokens equal JAX's chunked engine's and the
    port's whole-prompt admission's."""
    jmodel, plain, model, params = _pair("musicgen-large")
    cfg = model.cfg
    jreqs, reqs = _both(cfg)
    kw = _kw(cfg, prefill_chunk_len=4, prefill_lanes=2)
    want = JaxSlotEngine(jmodel, plain,
                         config=JaxEngineConfig(**kw)).serve(jreqs)
    chunked = SlotEngine(model, params, config=EngineConfig(**kw)
                         ).serve(reqs)
    whole = SlotEngine(model, params, config=EngineConfig(**_kw(cfg))
                       ).serve(reqs)
    _same_results(chunked, want)
    _same_results(whole, want)


def test_chunked_vision_engine_raises_as_jax():
    """The vision prefix is prepended whole: both packages refuse a
    chunked vision engine with the same ValueError; whole-prompt
    admission builds."""
    jmodel, plain, model, params = _pair("internvl2-1b")
    kw = _kw(model.cfg, prefill_chunk_len=4)
    with pytest.raises(ValueError, match="vis-token") as want:
        JaxSlotEngine(jmodel, plain, config=JaxEngineConfig(**kw))
    with pytest.raises(ValueError, match="vis-token") as got:
        SlotEngine(model, params, config=EngineConfig(**kw))
    assert str(got.value) == str(want.value)
    SlotEngine(model, params, config=EngineConfig(**_kw(model.cfg)))


@pytest.mark.parametrize("engine", ["slot", "wave"])
def test_vision_request_past_the_cache_is_refused(engine):
    """A vision request whose text fits ``max_seq`` (the JAX package's
    rule) but whose prefix, text and decode writes pass the cache is
    refused with a ValueError before any lane is touched (the slot
    engine at submit and at serve; the wave engine, whose last decode
    writes one position more, at serve); the request that fills the
    cache exactly is served and gives JAX's tokens."""
    jmodel, plain, model, params = _pair("internvl2-1b")
    cfg = model.cfg
    kw = dict(n_slots=1, max_seq=MAX_SEQ + cfg.n_vis_tokens)
    make, jmake = ((SlotEngine, JaxSlotEngine) if engine == "slot"
                   else (Engine, JaxEngine))
    # n_vis + 10 + fits - 1 decode writes (slot) or fits (wave) == max_seq
    fits = MAX_SEQ - 10 + (engine == "slot")
    jreq, req = (r[0] for r in _both(cfg, lens=[10], news=[fits]))
    want = jmake(jmodel, plain, config=JaxEngineConfig(**kw)).serve([jreq])
    _same_results(make(model, params, config=EngineConfig(**kw)
                       ).serve([req]), want)
    over = dataclasses.replace(req, max_new_tokens=fits + 1)
    assert 10 + over.max_new_tokens - 1 <= kw["max_seq"]   # JAX admits it
    eng = make(model, params, config=EngineConfig(**kw))
    if engine == "slot":
        with pytest.raises(ValueError, match="vision prefix"):
            eng.submit(over)
    with pytest.raises(ValueError, match="vision prefix"):
        eng.serve([over])


def test_audio_stream_events_and_empty_results():
    """Streamed audio events carry (K,) tokens that reassemble into the
    (K, m) Result; a zero-budget request ends with (K, 0) tokens; the
    manager's tick tokens are (n_slots, K)."""
    _, _, model, params = _pair("musicgen-large")
    cfg = model.cfg
    K = cfg.n_codebooks
    reqs = _requests(cfg, lens=[5, 3, 6], news=[3, 0, 4])
    eng = SlotEngine(model, params, config=EngineConfig(**_kw(cfg)))
    assert tuple(eng.manager.tokens.shape) == (2, K)
    assert eng.manager.empty_tokens().shape == (K, 0)
    events = []
    results = eng.serve(reqs, on_token=events.append)
    assert [r.tokens.shape for r in results] == [(K, 3), (K, 0), (K, 4)]
    for req, res in zip(reqs, results):
        toks = [ev.token for ev in events
                if ev.uid == req.uid and ev.token is not None]
        assert all(t.shape == (K,) for t in toks)
        if toks:
            np.testing.assert_array_equal(np.stack(toks, -1), res.tokens)


def _chaos_plan(seed):
    return FaultPlan.seeded(seed, n_slots=2, ticks=10,
                            uids=tuple(range(len(LENS))), n_poison=2,
                            n_prefill=1, n_slow_burst=1, slow_extra_s=0.01,
                            n_flood=1, flood_n=2)


def test_chaos_seed_on_musicgen():
    """Chaos seed 0 (poisoned lanes, a prefill fault, a slow burst, a
    flood of (K, S) prompts) on the audio model: no exception escapes,
    every request ends with a reason of the closed set, healthy lanes
    equal the fault-free run, the pools never reallocate, and JAX's engine
    under the same plan and clock retires the same requests (floods
    included) with the same tokens and counters."""
    jmodel, plain, model, params = _pair("musicgen-large")
    cfg = model.cfg
    kw = dict(n_slots=2, max_seq=64, queue_capacity=4, retry_budget=1)
    baseline = {r.uid: r.tokens for r in SlotEngine(
        model, params, config=EngineConfig(**kw)).serve(_requests(cfg))}
    faults = _chaos_plan(0)
    engine = SlotEngine(model, params, clock=slots_tests.FakeClock(),
                        config=EngineConfig(faults=faults, **kw))
    reqs = _requests(cfg)
    for ev in engine.stream(reqs):
        assert ev.finish_reason is None or ev.finish_reason in FINISH_REASONS
    done = engine.take_finished()
    for req in reqs:
        res = done[req.uid]
        assert res.finish_reason in FINISH_REASONS
        assert res.tokens.shape[:-1] == (cfg.n_codebooks,)
        if res.finish_reason == FinishReason.LENGTH:
            np.testing.assert_array_equal(res.tokens, baseline[req.uid])
    assert engine.pool.stats.buffers_built == 1
    assert engine._scratch_pool.stats.buffers_built == 1
    jengine = JaxSlotEngine(jmodel, plain, clock=slots_tests.FakeClock(),
                            config=JaxEngineConfig(
                                faults=jax_serving.FaultPlan.from_json(
                                    faults.to_json()), **kw))
    for _ in jengine.stream(_requests(cfg, cls=jax_serving.Request)):
        pass
    want = jengine.take_finished()
    assert sorted(done) == sorted(want)
    assert len(done) > len(reqs)                    # the flood retired too
    _same_results([done[u] for u in sorted(done)],
                  [want[u] for u in sorted(want)])

    def counters(e):
        return {k: v for k, v in e.metrics.snapshot()["counters"].items()
                if k != "serving/ticks"}

    assert counters(engine) == counters(jengine)


@pytest.mark.parametrize("name", FRONTS)
def test_front_tick_captures_no_host_sync_and_keeps_buffers(name):
    """Every tick of a served front under the dispatch mode that fails on
    a host read or a data-dependent shape (what a CUDA graph cannot hold):
    the audio tick's (B, K) tokens and (B, K, V) logits, the vision
    model's text tick; the manager's cache and tick buffers keep their
    data_ptr()s across admit, tick and retire."""
    cfg = get_arch(name + "-reduced")
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    engine = SlotEngine(model, params, config=EngineConfig(
        n_slots=3, max_seq=24 + cfg.n_vis_tokens))
    ptrs = slots_tests._resident_ptrs(engine)
    tick = engine.ticks["decode/base"]
    inner, modes = tick.fn, []

    def guarded(*args):
        with slots_tests._NoHostSync() as mode:
            out = inner(*args)
        modes.append(mode)
        return out

    tick.fn = guarded
    results = engine.serve(_requests(cfg, lens=[5, 3], news=[4, 3]))
    assert [r.finish_reason for r in results] == ["length"] * 2
    assert len(modes) == 3 and all("where" in m.ops for m in modes)
    assert slots_tests._resident_ptrs(engine) == ptrs
    sampled, lane_ok, logits = tick()
    tail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert tuple(sampled.shape) == (3,) + tail
    assert lane_ok.dtype == torch.bool and tuple(lane_ok.shape) == (3,)
    assert tuple(logits.shape) == (3,) + tail + (cfg.vocab,)
    assert slots_tests._resident_ptrs(engine) == ptrs


def test_guarded_audio_step_poisons_a_lane_across_its_codebooks():
    """``guarded_decode_step`` on (B, K, V) logits: a poisoned lane is NaN
    in every codebook and reported, the others bit-equal to the unguarded
    step."""
    from repro_torch import steps as steps_lib

    cfg = dataclasses.replace(get_arch("musicgen-large-reduced"))
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    batch = {"tokens": toks, "active": torch.tensor([True, True])}
    clean, ok, _ = steps_lib.guarded_decode_step(
        cfg, params, model.init_cache(2, 8, per_lane_pos=True), batch)
    bad, ok_bad, _ = steps_lib.guarded_decode_step(
        cfg, params, model.init_cache(2, 8, per_lane_pos=True),
        dict(batch, poison=torch.tensor([False, True])))
    assert tuple(clean.shape) == (2, cfg.n_codebooks, cfg.vocab)
    assert ok.tolist() == [True, True] and ok_bad.tolist() == [True, False]
    assert torch.isnan(bad[1]).all() and torch.equal(bad[0], clean[0])
