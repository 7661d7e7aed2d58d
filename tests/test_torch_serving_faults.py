"""The port's chaos path (``repro_torch.serving.faults`` through the slot
engine) against the JAX package's, on the CPU.

The JAX package's tests/test_serving_faults.py, case for case, on its
micro dense model (``_tiny_cfg``), f32, parameters drawn by the JAX init
and carried across with ``convert.params_from_numpy``: the same
``FaultPlan`` drives both packages' ``SlotEngine`` and the port's tokens,
finish reasons, counters and ``take_finished`` contents must equal JAX's;
under any seeded plan healthy lanes equal the fault-free run and
``buffers_built`` stays at capacity.  ``FaultPlan.seeded`` must give JAX's
plan for the same arguments (its JSON equal to JAX's).  Beside them the
device half of the fault path: ``masked_decode_step`` and
``guarded_decode_step`` against JAX's for each serving family, active and
inactive lanes, an inactive lane's cache rows and ``pos`` untouched bit
for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import serving as jax_serving  # noqa: E402
from repro import steps as jax_steps  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import steps as steps_lib  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import jamba_1_5_large_398b as jamba  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.serving import (FINISH_REASONS, EngineConfig,  # noqa: E402
                                 FaultInjector, FaultPlan, FinishReason,
                                 LanePoison, PrefillFault, QueueFlood,
                                 Request, Result, SlotEngine, SlowTick)

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # hypothesis is a dev-only dependency
    HAVE_HYPOTHESIS = False

JaxSlotEngine = jax_serving.SlotEngine
JaxEngineConfig = jax_serving.EngineConfig


def _tiny(get):
    return dataclasses.replace(
        get("qwen2-0.5b").reduced(), n_layers=2, d_model=64,
        n_heads=2, n_kv_heads=1, head_dim=16, d_ff=128, vocab=128)


def _pair(get_cfg):
    jmodel = jax_registry.build(get_cfg(jax_get_arch))
    plain, _ = split(jmodel.init(jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    return jmodel, plain, registry.build(get_cfg(get_arch)), params


@pytest.fixture(scope="module")
def tiny():
    return _pair(_tiny)


LENS, NEWS = [5, 9, 3, 7], [6, 4, 8, 5]


def _requests(lens=LENS, news=NEWS, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, 128, (int(l),)).astype(np.int32),
                max_new_tokens=int(m))
            for i, (l, m) in enumerate(zip(lens, news))]


def _jax_requests(**kw):
    return _requests(cls=jax_serving.Request, **kw)


def _jax_plan(plan: FaultPlan):
    """The same plan as the JAX package's FaultPlan (by its JSON)."""
    return jax_serving.FaultPlan.from_json(plan.to_json())


class FakeClock:
    """Deterministic monotonic clock: advances 1.0 per call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


@pytest.fixture(scope="module")
def baseline(tiny):
    """Fault-free reference tokens for the standard request set — what
    every healthy (finish_reason='length') lane must match bit-for-bit —
    equal to the JAX engine's."""
    jmodel, plain, model, params = tiny
    results = SlotEngine(model, params, config=EngineConfig(
        n_slots=2, max_seq=64, queue_capacity=8)).serve(_requests())
    want = JaxSlotEngine(jmodel, plain, config=JaxEngineConfig(
        n_slots=2, max_seq=64, queue_capacity=8)).serve(_jax_requests())
    _same_results(results, want)
    assert all(r.finish_reason == FinishReason.LENGTH for r in results)
    return {r.uid: r.tokens for r in results}


def _same_results(got, want):
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.finish_reason == w.finish_reason, (g.uid, g.finish_reason,
                                                     w.finish_reason)
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens),
                                      err_msg=f"uid {g.uid}")


def _counters(engine):
    return {k: v for k, v in engine.metrics.snapshot()["counters"].items()
            if k != "serving/ticks"}


def _serve_both(tiny, reqs_kw=None, **kw):
    """Serve the same requests under the same config (and FaultPlan) in
    both packages; the port's Results must equal JAX's, its counters
    too.  Returns (port engine, port results)."""
    jmodel, plain, model, params = tiny
    reqs_kw = reqs_kw or {}
    jkw = dict(kw)
    if jkw.get("faults") is not None:
        jkw["faults"] = _jax_plan(jkw["faults"])
    jengine = JaxSlotEngine(jmodel, plain, config=JaxEngineConfig(**jkw))
    want = jengine.serve(_jax_requests(**reqs_kw))
    engine = SlotEngine(model, params, config=EngineConfig(**kw))
    got = engine.serve(_requests(**reqs_kw))
    _same_results(got, want)
    assert _counters(engine) == _counters(jengine)
    return engine, got


# ---------------------------------------------------------------------------
# FaultPlan / closed finish_reason set (no model)
# ---------------------------------------------------------------------------
def test_fault_plan_seeded_deterministic_and_json_roundtrip():
    kw = dict(n_slots=2, ticks=8, uids=(0, 1, 2), n_poison=2, n_prefill=1,
              n_slow_burst=1, n_flood=1)
    a, b = FaultPlan.seeded(7, **kw), FaultPlan.seeded(7, **kw)
    assert a == b
    assert a != FaultPlan.seeded(8, **kw)
    assert FaultPlan.from_json(a.to_json()) == a
    kinds = {type(f) for f in a.faults}
    assert kinds == {LanePoison, PrefillFault, SlowTick, QueueFlood}


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_fault_plan_seeded_equals_the_jax_plan(seed):
    kw = dict(n_slots=2, ticks=10, uids=(0, 1, 2, 3), n_poison=2,
              n_prefill=1, n_slow_burst=1, slow_extra_s=0.01, n_flood=1,
              flood_n=2)
    got = FaultPlan.seeded(seed, **kw).to_json()
    assert got == jax_serving.FaultPlan.seeded(seed, **kw).to_json()
    assert FaultPlan.from_json(got) == FaultPlan.seeded(seed, **kw)


def test_result_rejects_reasons_outside_closed_set():
    empty = np.zeros((0,), np.int32)
    for reason in sorted(FINISH_REASONS):
        Result(0, empty, 0.0, 0.0, [], finish_reason=reason)
    with pytest.raises(ValueError, match="closed"):
        Result(0, empty, 0.0, 0.0, [], finish_reason="oom")
    assert FINISH_REASONS == jax_serving.FINISH_REASONS


# ---------------------------------------------------------------------------
# Guard semantics at the steps level
# ---------------------------------------------------------------------------
def test_guarded_step_all_false_poison_is_bit_identical(tiny):
    _, _, model, params = tiny
    cache = model.init_cache(2, 16, per_lane_pos=True)
    cache["pos"].copy_(torch.tensor([3, 0], dtype=torch.int32))
    batch = {"tokens": torch.tensor([7, 0], dtype=torch.int32),
             "active": torch.tensor([True, False])}
    ref_cache = {"pos": cache["pos"].clone(),
                 "slots": [{k: v.clone() for k, v in s.items()}
                           for s in cache["slots"]]}
    ref_logits, ref_cache = steps_lib.masked_decode_step(
        model.cfg, params, ref_cache, dict(batch))
    logits, lane_ok, _ = steps_lib.guarded_decode_step(
        model.cfg, params, cache,
        dict(batch, poison=torch.tensor([False, False])))
    assert torch.equal(logits, ref_logits)
    assert lane_ok.tolist() == [True, True]
    poisoned, lane_ok, _ = steps_lib.guarded_decode_step(
        model.cfg, params, ref_cache,
        dict(batch, poison=torch.tensor([True, False])))
    assert lane_ok.tolist() == [False, True]
    assert torch.isnan(poisoned[0]).all()


def _family(get, arch):
    if arch == "jamba-attention-free":
        free = dict(jamba.ATTENTION_FREE, n_layers=2)
        return dataclasses.replace(get("jamba-1.5-large-398b"),
                                   **free).reduced()
    return get(arch).reduced()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-attention-free",
                                  "rwkv6-3b"])
def test_masked_and_guarded_steps_match_jax(arch):
    """A 3-lane tick (lanes 0 and 2 active at positions 5 and 2, lane 1
    free at 0) on a cache of random states, through the port's and JAX's
    ``masked_decode_step`` and ``guarded_decode_step``: the active lanes'
    logits and new cache rows at 1e-5, the inactive lane's rows and
    ``pos`` bit for bit what they were (the port writes in place), the
    poisoned lane NaN and reported, an all-False mask bit-identical."""
    jmodel, plain, model, params = _pair(lambda get: _family(get, arch))
    cfg, jcfg = model.cfg, jmodel.cfg
    jcache, _ = split(jmodel.init_cache(3, 12))
    rng = np.random.default_rng(2)
    jcache = jax.tree.map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(a.dtype),
        jcache)
    pos = np.array([5, 0, 2], np.int32)
    jcache = dict(jcache, pos=pos)
    toks = np.array([7, 3, 11], np.int32)
    active = np.array([True, False, True])
    jlogits, jnew = jax_steps.masked_decode_step(
        jcfg, plain, jcache, {"tokens": toks, "active": active})
    jg_logits, jg_ok, _ = jax_steps.guarded_decode_step(
        jcfg, plain, jcache, {"tokens": toks, "active": active,
                              "poison": np.array([False, False, True])})

    def port_cache():
        tree = convert.params_from_numpy(jax.tree.map(np.asarray, jcache))
        return tree

    before = port_cache()
    cache = port_cache()
    batch = {"tokens": torch.from_numpy(toks),
             "active": torch.from_numpy(active)}
    logits, out = steps_lib.masked_decode_step(cfg, params, cache, batch)
    assert out is cache
    np.testing.assert_allclose(logits[active].numpy(),
                               np.asarray(jlogits)[active],
                               rtol=1e-5, atol=1e-5)
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jnew))
    for got_t, want_t, old_t in zip(tree_leaves(cache), tree_leaves(want),
                                    tree_leaves(before)):
        if got_t.dim() == 1:                                    # pos
            assert got_t.tolist() == [6, 0, 3] == want_t.tolist()
            continue
        g, w, o = got_t.float(), want_t.float(), old_t.float()
        assert torch.equal(g[:, 1], o[:, 1])          # inactive: untouched
        torch.testing.assert_close(g[:, [0, 2]], w[:, [0, 2]], rtol=1e-5,
                                   atol=1e-5)
    g_logits, g_ok, _ = steps_lib.guarded_decode_step(
        cfg, params, port_cache(),
        dict(batch, poison=torch.tensor([False, False, True])))
    assert g_ok.tolist() == np.asarray(jg_ok).tolist() == [True, True, False]
    assert torch.isnan(g_logits[2]).all()
    assert torch.equal(g_logits[0], logits[0])
    np.testing.assert_allclose(g_logits[0].numpy(), np.asarray(jg_logits)[0],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="per-lane"):
        steps_lib.masked_decode_step(cfg, params, model.init_cache(3, 12),
                                     batch)


# ---------------------------------------------------------------------------
# Engine: DOA fast-fail, quarantine, retries, prefill faults
# ---------------------------------------------------------------------------
def test_submit_dead_on_arrival_publishes_deadline_result(tiny):
    _, _, model, params = tiny
    engine = SlotEngine(model, params, clock=FakeClock(), config=EngineConfig(
        n_slots=2, max_seq=64, queue_capacity=4))
    req = Request(9, np.array([1, 2], np.int32), max_new_tokens=2,
                  deadline_s=0.5)
    assert engine.submit(req) is False
    assert len(engine.queue) == 0
    res = engine.take_finished()[9]
    assert res.finish_reason == FinishReason.DEADLINE
    assert res.tokens.shape[-1] == 0
    assert engine.metrics.counter("serving/deadline_miss").value == 1


def test_quarantine_without_budget_errors_healthy_lane_identical(
        tiny, baseline):
    faults = FaultPlan(seed=0, faults=(LanePoison(tick=1, lane=0),))
    engine, results = _serve_both(
        tiny, dict(lens=LENS[:2], news=[6, 4]), n_slots=2, max_seq=64,
        queue_capacity=8, faults=faults)
    assert results[0].finish_reason == FinishReason.ERROR
    assert results[0].tokens.shape[-1] == 2
    np.testing.assert_array_equal(results[0].tokens, baseline[0][:2])
    assert results[1].finish_reason == FinishReason.LENGTH
    np.testing.assert_array_equal(results[1].tokens, baseline[1])
    assert engine.metrics.counter("serving/quarantined").value == 1
    assert engine.metrics.counter("serving/retries").value == 0
    assert engine.pool.stats.buffers_built == 1
    assert not engine.manager.poison.any()     # the static buffer cleared


def test_quarantine_retry_regenerates_identical_tokens(tiny, baseline):
    faults = FaultPlan(seed=0, faults=(LanePoison(tick=1, lane=0),))
    engine, results = _serve_both(
        tiny, dict(lens=LENS[:2], news=[6, 4]), n_slots=2, max_seq=64,
        queue_capacity=8, faults=faults, retry_budget=2)
    for r in results:
        assert r.finish_reason == FinishReason.LENGTH
        np.testing.assert_array_equal(r.tokens, baseline[r.uid])
    assert engine.metrics.counter("serving/quarantined").value == 1
    assert engine.metrics.counter("serving/retries").value == 1
    assert engine.pool.stats.buffers_built == 1


def test_retries_exhausted_under_persistent_poison(tiny):
    faults = FaultPlan(seed=0, faults=tuple(
        LanePoison(tick=t, lane=0) for t in range(64)))
    engine, [res] = _serve_both(
        tiny, dict(lens=[5], news=[4]), n_slots=1, max_seq=64,
        queue_capacity=4, faults=faults, retry_budget=1)
    assert res.finish_reason == FinishReason.RETRIES_EXHAUSTED
    assert engine.metrics.counter("serving/retries").value == 1
    assert engine.metrics.counter("serving/quarantined").value == 2
    assert engine.pool.stats.buffers_built == 1


def test_prefill_fault_without_budget_is_error(tiny, baseline):
    faults = FaultPlan(seed=0, faults=(PrefillFault(uid=0),))
    engine, results = _serve_both(
        tiny, dict(lens=LENS[:2], news=[6, 4]), n_slots=2, max_seq=64,
        queue_capacity=8, faults=faults)
    assert results[0].finish_reason == FinishReason.ERROR
    assert results[0].tokens.shape[-1] == 0
    assert results[1].finish_reason == FinishReason.LENGTH
    np.testing.assert_array_equal(results[1].tokens, baseline[1])
    assert engine._scratch_pool.stats.buffers_built == 1


def test_prefill_fault_with_budget_retries_to_length(tiny, baseline):
    faults = FaultPlan(seed=0, faults=(PrefillFault(uid=0),))
    engine, results = _serve_both(
        tiny, dict(lens=LENS[:2], news=[6, 4]), n_slots=2, max_seq=64,
        queue_capacity=8, faults=faults, retry_budget=1)
    for r in results:
        assert r.finish_reason == FinishReason.LENGTH
        np.testing.assert_array_equal(r.tokens, baseline[r.uid])
    assert engine.metrics.counter("serving/retries").value == 1
    assert engine._scratch_pool.stats.buffers_built == 1


# ---------------------------------------------------------------------------
# Chunked prefill x faults: per-ATTEMPT consumption, chunk-k targeting
# ---------------------------------------------------------------------------
def test_take_prefill_fault_is_per_attempt_and_chunk_targeted():
    plan = FaultPlan(seed=0, faults=(PrefillFault(uid=1, chunk=2),))
    inj = FaultInjector(plan, 2, vocab=16, max_seq=32)
    assert not inj.take_prefill_fault(1, chunk=0)
    assert not inj.take_prefill_fault(1, chunk=1)
    assert inj.take_prefill_fault(1, chunk=2)
    assert not inj.take_prefill_fault(1, chunk=2)
    inj2 = FaultInjector(FaultPlan(seed=0, faults=(PrefillFault(uid=3),)),
                         2, vocab=16, max_seq=32)
    assert inj2.take_prefill_fault(3, chunk=5)
    assert not inj2.take_prefill_fault(3, chunk=5)
    p = FaultPlan(seed=1, faults=(PrefillFault(uid=2, chunk=1),))
    assert FaultPlan.from_json(p.to_json()) == p
    legacy = {"seed": 0, "faults": [{"kind": "PrefillFault", "uid": 4}]}
    assert FaultPlan.from_json(legacy).faults[0].chunk is None
    # the flood requests are JAX's, drawn from the plan's seed
    flood = FaultPlan(seed=4, faults=(QueueFlood(tick=0, n=2),))
    mine = FaultInjector(flood, 2, vocab=16, max_seq=32).flood_requests(0, 1.)
    theirs = jax_serving.FaultInjector(
        _jax_plan(flood), 2, vocab=16, max_seq=32).flood_requests(0, 1.)
    assert [(r.uid, r.prompt.tolist(), r.max_new_tokens, r.deadline_s)
            for r in mine] == [(r.uid, r.prompt.tolist(), r.max_new_tokens,
                                r.deadline_s) for r in theirs]


def test_chunk_k_fault_discards_partial_state_retry_token_identical(tiny):
    """A fault at chunk k of a chunked admission discards the k chunks of
    partial scratch state; the retry restarts from chunk 0 and the final
    tokens equal an unfaulted chunked run's (and JAX's)."""
    kw = dict(n_slots=2, max_seq=64, queue_capacity=8, prefill_chunk_len=4,
              prefill_lanes=2)
    _, clean = _serve_both(tiny, dict(lens=[13, 5], news=[4, 3]), **kw)
    want = {r.uid: r.tokens for r in clean}
    faults = FaultPlan(seed=0, faults=(PrefillFault(uid=0, chunk=2),))
    engine, results = _serve_both(tiny, dict(lens=[13, 5], news=[4, 3]),
                                  faults=faults, retry_budget=1, **kw)
    for r in results:
        assert r.finish_reason == FinishReason.LENGTH
        np.testing.assert_array_equal(r.tokens, want[r.uid])
    assert engine.metrics.counter("serving/retries").value == 1
    sp = engine._scratch_pool.stats
    assert sp.buffers_built == sp.capacity == 2
    assert sp.outstanding == 0


def test_chunk_k_fault_without_budget_is_error(tiny):
    faults = FaultPlan(seed=0, faults=(PrefillFault(uid=0, chunk=1),))
    engine, [res] = _serve_both(
        tiny, dict(lens=[9], news=[3]), n_slots=1, max_seq=64,
        queue_capacity=4, prefill_chunk_len=4, prefill_lanes=1,
        faults=faults)
    assert res.finish_reason == FinishReason.ERROR
    assert res.tokens.shape[-1] == 0
    sp = engine._scratch_pool.stats
    assert sp.buffers_built == sp.capacity == 1
    assert sp.outstanding == 0


# ---------------------------------------------------------------------------
# Degradation ladder: watchdog downshift, shed, recovery
# ---------------------------------------------------------------------------
def test_ladder_degrades_sheds_and_recovers(tiny):
    jmodel, plain, model, params = tiny
    cfg = model.cfg
    faults = FaultPlan(seed=0, faults=tuple(
        SlowTick(tick=t, extra_s=1e6) for t in range(3)))
    kw = dict(n_slots=2, max_seq=64, queue_capacity=4, tick_slo_s=50.0,
              slo_breach_ticks=3, slo_recover_ticks=3,
              ladder=["decode/base"])
    engine = SlotEngine(
        model, params, config=EngineConfig(faults=faults, **kw),
        extra_plans={"decode/fallback":
                     lambda p, c, b: steps_lib.decode_step(cfg, p, c, b)})
    jengine = JaxSlotEngine(
        jmodel, plain, config=JaxEngineConfig(faults=_jax_plan(faults), **kw),
        extra_plans={"decode/fallback":
                     lambda p, c, b: jax_steps.decode_step(jmodel.cfg, p, c,
                                                           b)})
    outs = []
    for eng, cls in ((engine, Request), (jengine, jax_serving.Request)):
        reqs = _requests(lens=[5, 9], news=[12, 12], cls=cls)
        doomed = cls(7, np.array([1, 2, 3], np.int32), max_new_tokens=4,
                     deadline_s=eng.clock() + 1000.0)
        outs.append(eng.serve(reqs + [doomed]))
    results = outs[0]
    _same_results(results, outs[1])
    assert [r.finish_reason for r in results[:2]] == [
        FinishReason.LENGTH, FinishReason.LENGTH]
    assert results[2].finish_reason == FinishReason.SHED
    assert engine.metrics.counter("serving/shed").value == 1
    plans = [d.plan for d in engine.scheduler.decisions]
    assert plans[:3] == ["decode/base"] * 3
    assert "decode/fallback" in plans[3:]
    assert engine.scheduler.level == 0
    assert engine.pool.stats.buffers_built == 1


# ---------------------------------------------------------------------------
# The chaos property (fixed seeds against JAX; hypothesis on the port)
# ---------------------------------------------------------------------------
def _chaos_plan(seed):
    return FaultPlan.seeded(seed, n_slots=2, ticks=10,
                            uids=tuple(range(len(LENS))), n_poison=2,
                            n_prefill=1, n_slow_burst=1, slow_extra_s=0.01,
                            n_flood=1, flood_n=2)


def _chaos_property(tiny, baseline, seed, against_jax):
    """Any seeded FaultPlan: no exception escapes stream(), every request
    terminates with a reason from the closed set, healthy lanes match the
    fault-free run token-for-token, and the pools never reallocate; with
    ``against_jax`` the JAX engine under the same plan and the same
    FakeClock retires the same requests with the same tokens."""
    jmodel, plain, model, params = tiny
    faults = _chaos_plan(seed)
    kw = dict(n_slots=2, max_seq=64, queue_capacity=4, retry_budget=1)
    engine = SlotEngine(model, params, clock=FakeClock(),
                        config=EngineConfig(faults=faults, **kw))
    reqs = _requests()
    for ev in engine.stream(reqs):
        assert ev.finish_reason is None or ev.finish_reason in FINISH_REASONS
    done = engine.take_finished()
    for req in reqs:
        assert req.uid in done, f"request {req.uid} never terminated"
        res = done[req.uid]
        assert res.finish_reason in FINISH_REASONS
        if res.finish_reason == FinishReason.LENGTH:
            np.testing.assert_array_equal(res.tokens, baseline[req.uid])
    assert engine.pool.stats.buffers_built == 1
    assert engine._scratch_pool.stats.buffers_built == 1
    if against_jax:
        jengine = JaxSlotEngine(jmodel, plain, clock=FakeClock(),
                                config=JaxEngineConfig(
                                    faults=_jax_plan(faults), **kw))
        for _ in jengine.stream(_jax_requests()):
            pass
        want = jengine.take_finished()
        assert sorted(done) == sorted(want)
        _same_results([done[u] for u in sorted(done)],
                      [want[u] for u in sorted(want)])
        assert _counters(engine) == _counters(jengine)


@pytest.mark.parametrize("seed", [0, 3])
def test_chaos_fixed_seeds(tiny, baseline, seed):
    _chaos_property(tiny, baseline, seed, against_jax=True)


if HAVE_HYPOTHESIS:
    @settings(max_examples=4, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2**16))
    def test_chaos_property_hypothesis(tiny, baseline, seed):
        _chaos_property(tiny, baseline, seed, against_jax=False)
