"""The port's slot engine (``repro_torch.serving``: continuous batching,
the queue, chunked admission, the decode tick) against the JAX package's
``SlotEngine`` on the CPU.

The JAX package's tests/test_serving_slots.py, case for case: its micro
dense model (``_tiny_cfg``: 2 layers, d=64) for the quick cases, and the
reduced ``qwen2-0.5b``, ``rwkv6-3b``, attention-free Jamba stack, MoE
``olmoe-1b-7b`` and whole Jamba hybrid (attention, Mamba and MoE) for the
per-family sweeps, all f32.  Parameters are drawn by the JAX init and
carried across with ``convert.params_from_numpy``; the port's greedy
tokens, finish reasons and ``take_finished`` contents must equal those of
the JAX package's ``SlotEngine`` on the same requests (and its deadline
cases run both engines on the same deterministic ``FakeClock``).  Beside
them: ``chunk_prefill_attention`` against JAX's on full, ring and int8
caches, and the tick run under a dispatch mode that fails on every op
which reads a device value on the host or makes a tensor of
data-dependent shape (what a CUDA-graph capture cannot hold), with the
manager's buffers never rebound across admit, tick and retire."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import serving as jax_serving  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert, serving  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import jamba_1_5_large_398b as jamba  # noqa: E402
from repro_torch.core import state as state_lib  # noqa: E402
from repro_torch.models import attention, registry  # noqa: E402
from repro_torch.obs import metrics as metrics_lib  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, QueueFull,  # noqa: E402
                                 Request, RequestQueue, SlotEngine,
                                 chunk_schedule)
from repro_torch.serving.tick import DecodeTick  # noqa: E402

JaxSlotEngine = jax_serving.SlotEngine
JaxEngineConfig = jax_serving.EngineConfig


def _tiny(get):
    return dataclasses.replace(
        get("qwen2-0.5b").reduced(), n_layers=2, d_model=64,
        n_heads=2, n_kv_heads=1, head_dim=16, d_ff=128, vocab=128)


def _family(get, arch):
    """The reduced config of a serving family in either package."""
    if arch == "jamba-attention-free":
        free = dict(jamba.ATTENTION_FREE, n_layers=2)
        return dataclasses.replace(get("jamba-1.5-large-398b"),
                                   **free).reduced()
    return get(arch).reduced()


def _pair(get_cfg):
    """(JAX model, JAX plain params, port model, port params) for the
    config ``get_cfg(get_arch)`` returns in each package."""
    jmodel = jax_registry.build(get_cfg(jax_get_arch))
    plain, _ = split(jmodel.init(jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    return jmodel, plain, registry.build(get_cfg(get_arch)), params


@pytest.fixture(scope="module")
def tiny():
    return _pair(_tiny)


def _requests(vocab, lens, news, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, (int(l),)).astype(np.int32),
                max_new_tokens=int(m))
            for i, (l, m) in enumerate(zip(lens, news))]


def _both(vocab, lens, news, seed=0):
    """The same requests for the JAX engine and the port's."""
    return (_requests(vocab, lens, news, seed, jax_serving.Request),
            _requests(vocab, lens, news, seed))


class FakeClock:
    """Deterministic monotonic clock: advances 1.0 per call (the JAX
    tests' clock)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _same_results(got, want):
    """Tokens, finish reasons and uids of the port's Results equal to the
    JAX engine's."""
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.finish_reason == w.finish_reason, (g.uid, g.finish_reason,
                                                     w.finish_reason)
        assert g.tokens.dtype == np.int32
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens),
                                      err_msg=f"uid {g.uid}")


def _resident_ptrs(engine):
    m = engine.manager
    return [t.data_ptr() for t in (*tree_leaves(m.cache), m.tokens,
                                   m.active, m.poison)]


# ---------------------------------------------------------------------------
# Queue (no model)
# ---------------------------------------------------------------------------
def test_queue_fifo_and_backpressure():
    q = RequestQueue(capacity=2)
    a = Request(0, np.array([1], np.int32))
    b = Request(1, np.array([2], np.int32))
    q.submit(a)
    q.submit(b)
    assert q.full and len(q) == 2
    with pytest.raises(QueueFull, match="full"):
        q.submit(Request(2, np.array([3], np.int32)))
    assert q.pop() is a          # FIFO
    assert q.pop() is b
    assert q.pop() is None


def test_queue_expiry_with_duplicate_uids_and_equal_prompts():
    """Expiry partitions by identity — dataclass ``==`` over ndarray
    prompts would raise 'truth value of an array is ambiguous'."""
    clock = FakeClock()
    q = RequestQueue(capacity=4, clock=clock)
    assert q.submit(Request(5, np.array([1, 2, 3], np.int32)))
    assert q.submit(Request(5, np.array([1, 2, 3], np.int32), deadline_s=1.5))
    expired = q.expire()                                  # clock -> 2.0
    assert len(expired) == 1 and expired[0].deadline_s == 1.5
    assert len(q) == 1 and q.pop().deadline_s is None


def test_queue_deadline_expiry():
    clock = FakeClock()
    q = RequestQueue(capacity=4, clock=clock)
    assert not q.submit(Request(0, np.array([1], np.int32), deadline_s=0.5))
    assert len(q) == 0
    assert q.submit(Request(1, np.array([2], np.int32), deadline_s=2.5))
    assert q.submit(Request(2, np.array([3], np.int32)))            # none
    expired = q.expire()                                  # clock -> 3.0
    assert [r.uid for r in expired] == [1]
    assert len(q) == 1 and q.pop().uid == 2


def test_serving_exports_match_the_jax_package():
    assert sorted(serving.__all__) == sorted(jax_serving.__all__)
    for name in serving.__all__:
        assert hasattr(serving, name), name


def test_metrics_match_the_jax_package():
    from repro.obs import metrics as jax_metrics

    snaps = []
    for lib in (metrics_lib, jax_metrics):
        m = lib.Metrics()
        m.counter("serving/ticks").inc(3)
        m.gauge("serving/occupancy").set(0.5)
        for v in (4.0, 1.0, 3.0, 2.0):
            m.histogram("serving/ttft_s").observe(v)
        m.histogram("serving/tbt_s")
        snaps.append(m.snapshot())
    got, want = snaps
    assert got["counters"] == want["counters"]
    assert got["gauges"] == want["gauges"]
    assert got["histograms"]["serving/ttft_s"] == \
        want["histograms"]["serving/ttft_s"]
    assert got["histograms"]["serving/tbt_s"]["count"] == 0


def test_lane_write_and_lane_zero_touch_one_lane_in_place():
    tree = {"a": torch.arange(24.).reshape(2, 3, 4), "b": [torch.ones(2, 3)]}
    lane = {"a": torch.full((2, 1, 4), -1.0), "b": [torch.full((2, 1), 7.)]}
    ptrs = [t.data_ptr() for t in tree_leaves(tree)]
    before = {k: v.clone() for k, v in (("a", tree["a"]),
                                         ("b", tree["b"][0]))}
    assert state_lib.lane_write(tree, lane, 1, axis=1) is tree
    assert torch.equal(tree["a"][:, 1], torch.full((2, 4), -1.0))
    assert torch.equal(tree["a"][:, [0, 2]], before["a"][:, [0, 2]])
    assert torch.equal(tree["b"][0][:, 1], torch.full((2,), 7.))
    state_lib.lane_zero(tree, 2, axis=1)
    assert not tree["a"][:, 2].any() and not tree["b"][0][:, 2].any()
    assert torch.equal(tree["a"][:, 0], before["a"][:, 0])
    assert [t.data_ptr() for t in tree_leaves(tree)] == ptrs


# ---------------------------------------------------------------------------
# Slot engine (quick loop: tiny config, 8 requests)
# ---------------------------------------------------------------------------
def test_slot_engine_smoke_mixed_max_new(tiny):
    jmodel, plain, model, params = tiny
    lens, news = [5, 9, 3, 7, 5, 9, 3, 7], [2, 8, 4, 6, 8, 1, 6, 4]
    jreqs, reqs = _both(128, lens, news)
    want = JaxSlotEngine(jmodel, plain, config=JaxEngineConfig(
        n_slots=3, max_seq=64, queue_capacity=4)).serve(jreqs)
    engine = SlotEngine(model, params, config=EngineConfig(
        n_slots=3, max_seq=64, queue_capacity=4))
    events = []
    results = engine.serve(reqs, on_token=events.append)
    _same_results(results, want)
    for r, req in zip(results, reqs):
        assert r.finish_reason == "length"
        assert r.tokens.shape == (req.max_new_tokens,)
    # streamed events reassemble into exactly the returned tokens
    for req, res in zip(reqs, results):
        toks = [ev.token for ev in events if ev.uid == req.uid]
        assert np.array_equal(np.stack(toks, -1), res.tokens)
        dones = [ev.done for ev in events if ev.uid == req.uid]
        assert sum(dones) == 1 and dones[-1]
    order = [ev.uid for ev in events if ev.done]
    assert order.index(0) < order.index(1)
    assert engine.pool.stats.buffers_built == engine.pool.stats.capacity == 1
    assert engine._scratch_pool.stats.buffers_built == 1


def test_slot_engine_no_alloc_after_warmup(tiny):
    """JAX counts live device buffers; the port holds the resident cache
    and the tick buffers to their addresses, and both pools to their
    build-time buffers and single checkouts."""
    _, _, model, params = tiny
    engine = SlotEngine(model, params, config=EngineConfig(n_slots=2,
                                                           max_seq=64))
    ptrs = _resident_ptrs(engine)
    scratch = [t.data_ptr() for t in tree_leaves(engine._scratch)]
    engine.serve(_requests(128, [4, 6, 4], [3, 2, 4]))           # warmup
    engine.serve(_requests(128, [4, 6, 4], [2, 4, 3], seed=1))
    assert _resident_ptrs(engine) == ptrs
    assert [t.data_ptr() for t in tree_leaves(engine._scratch)] == scratch
    assert (engine.pool.stats.buffers_built,
            engine._scratch_pool.stats.buffers_built) == (1, 1)
    assert engine.pool.stats.checkouts == 1
    assert engine._scratch_pool.stats.checkouts == 1
    assert engine.metrics.counter("serving/ticks").value > 0
    assert engine.metrics.histogram("serving/ttft_s").count == 6


def test_slot_engine_traced_run_token_identical(tiny):
    """Tracing on vs off changes no token; the trace carries per-tick
    spans with the chosen plan, TTFT admit events and nested sched/choose
    decisions, and closes with a serve/metrics summary."""
    _, _, model, params = tiny

    def reqs():
        return _requests(128, [4, 6, 3], [3, 2, 4])

    base = SlotEngine(model, params, config=EngineConfig(n_slots=2,
                                                         max_seq=64))
    want = [r.tokens for r in base.serve(reqs())]
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        traced = SlotEngine(model, params, config=EngineConfig(n_slots=2,
                                                               max_seq=64))
        got = [r.tokens for r in traced.serve(reqs())]
    finally:
        trace_lib.set_tracer(old)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert traced.pool.stats.buffers_built == 1
    ticks = [r for r in sink.records if r["name"] == "serve/tick"]
    admits = [r for r in sink.records if r["name"] == "serve/admit"]
    chooses = [r for r in sink.records if r["name"] == "sched/choose"]
    assert ticks and len(admits) == 3
    tick_ids = {r["span"] for r in ticks}
    for t in ticks:
        assert t["type"] == "span" and t["attrs"]["plan"]
        assert t["attrs"]["tick_s"] > 0
    for a in admits:
        assert a["attrs"]["ttft_s"] > 0
    assert chooses and all(c["parent"] in tick_ids for c in chooses)
    summaries = [r for r in sink.records if r["name"] == "serve/metrics"]
    snap = summaries[-1]["attrs"]
    assert snap["counters"]["serving/deadline_miss"] == 0
    assert snap["counters"]["serving/retired"] == 3
    assert snap["histograms"]["serving/ttft_s"]["count"] == 3


def test_slot_engine_ttft_on_results(tiny):
    _, _, model, params = tiny
    engine = SlotEngine(model, params, config=EngineConfig(n_slots=2,
                                                           max_seq=64))
    results = engine.serve(_requests(128, [4, 7, 3], [3, 2, 4]))
    for r in results:
        assert r.finish_reason == "length"
        assert r.ttft_s > 0.0
        assert r.ttft_s <= r.prefill_s + r.decode_s + 1.0
    assert engine.metrics.histogram("serving/ttft_s").count == len(results)
    assert engine.metrics.histogram("serving/tbt_s").count > 0
    assert engine.metrics.counter("serving/retired").value == len(results)
    assert engine.pool.stats.buffers_built == 1


def test_slot_engine_backpressure(tiny):
    jmodel, plain, model, params = tiny
    engine = SlotEngine(model, params, config=EngineConfig(
        n_slots=1, max_seq=64, queue_capacity=2))
    jengine = JaxSlotEngine(jmodel, plain, config=JaxEngineConfig(
        n_slots=1, max_seq=64, queue_capacity=2))
    for eng, cls in ((engine, Request), (jengine, jax_serving.Request)):
        eng.submit(cls(0, np.array([1, 2], np.int32), max_new_tokens=2))
        eng.submit(cls(1, np.array([3], np.int32), max_new_tokens=2))
    with pytest.raises(QueueFull):
        engine.submit(Request(2, np.array([4], np.int32)))
    for _ in engine.stream():
        pass
    for _ in jengine.stream():
        pass
    assert sorted(engine.finished) == [0, 1]
    got, want = engine.take_finished(), jengine.take_finished()
    _same_results([got[u] for u in (0, 1)], [want[u] for u in (0, 1)])
    assert engine.finished == {}


def _deadline_requests(cls):
    return [cls(0, np.array([1, 2, 3], np.int32), max_new_tokens=32,
                deadline_s=6.0),
            cls(1, np.array([4, 5], np.int32), max_new_tokens=2,
                deadline_s=0.5),
            cls(2, np.array([6], np.int32), max_new_tokens=3)]


def test_deadline_expiry_queued_and_resident(tiny):
    jmodel, plain, model, params = tiny
    want = JaxSlotEngine(jmodel, plain, clock=FakeClock(),
                         config=JaxEngineConfig(n_slots=1, max_seq=64)
                         ).serve(_deadline_requests(jax_serving.Request))
    results = SlotEngine(model, params, clock=FakeClock(),
                         config=EngineConfig(n_slots=1, max_seq=64)
                         ).serve(_deadline_requests(Request))
    _same_results(results, want)
    assert results[0].finish_reason == "deadline"
    assert 0 < results[0].tokens.shape[-1] < 32
    assert results[1].finish_reason == "deadline"
    assert results[1].tokens.shape[-1] == 0
    assert results[2].finish_reason == "length"
    assert results[2].tokens.shape[-1] == 3


def test_zero_budget_request_gets_zero_tokens(tiny):
    _, _, model, params = tiny
    engine = SlotEngine(model, params, config=EngineConfig(n_slots=2,
                                                           max_seq=64))
    results = engine.serve([
        Request(0, np.array([1, 2], np.int32), max_new_tokens=0),
        Request(1, np.array([3, 4], np.int32), max_new_tokens=2)])
    assert results[0].tokens.shape == (0,)
    assert results[0].finish_reason == "length"
    assert results[1].tokens.shape == (2,)


def test_deadline_checked_on_mid_admission_refill(tiny):
    jmodel, plain, model, params = tiny

    def reqs(cls):
        return [cls(0, np.array([1, 2], np.int32), max_new_tokens=1),
                cls(1, np.array([3], np.int32), max_new_tokens=1,
                    deadline_s=0.5)]

    want = JaxSlotEngine(jmodel, plain, clock=FakeClock(),
                         config=JaxEngineConfig(n_slots=2, max_seq=64,
                                                queue_capacity=1)
                         ).serve(reqs(jax_serving.Request))
    results = SlotEngine(model, params, clock=FakeClock(),
                         config=EngineConfig(n_slots=2, max_seq=64,
                                             queue_capacity=1)
                         ).serve(reqs(Request))
    _same_results(results, want)
    assert results[0].finish_reason == "length"
    assert results[1].finish_reason == "deadline"
    assert results[1].tokens.shape[-1] == 0


def test_request_exceeding_lane_budget_rejected_upfront(tiny):
    _, _, model, params = tiny
    engine = SlotEngine(model, params, config=EngineConfig(n_slots=2,
                                                           max_seq=16))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        engine.submit(Request(0, np.arange(12, dtype=np.int32),
                              max_new_tokens=8))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        engine.serve([Request(0, np.arange(12, dtype=np.int32),
                              max_new_tokens=8)])
    res = engine.serve([Request(0, np.arange(12, dtype=np.int32),
                                max_new_tokens=5)])
    assert res[0].tokens.shape == (5,)


def test_wave_engine_pads_with_inactive_dummies(tiny):
    """Ragged wave tails pad with zero-length dummies; every request gets
    ITS OWN budget; the decode plan of every step comes from the
    scheduler."""
    _, _, model, params = tiny
    with pytest.warns(DeprecationWarning):
        engine = Engine(model, params, batch_size=4, max_seq=64,
                        pool_capacity=1)
    results = engine.serve(_requests(128, [6] * 5, [4, 2, 4, 4, 3]))
    assert [r.uid for r in results] == [0, 1, 2, 3, 4]
    assert [r.tokens.shape[-1] for r in results] == [4, 2, 4, 4, 3]
    assert [d.plan for d in engine.scheduler.decisions] == \
        ["decode/base"] * (4 + 3)
    assert results[0].plan_decisions == ["decode/base"] * 4
    assert engine.metrics.counter("serving/waves").value == 2


# ---------------------------------------------------------------------------
# EngineConfig (consolidated construction surface + deprecated aliases)
# ---------------------------------------------------------------------------
def test_engine_config_aliases_warn_and_match(tiny):
    _, _, model, params = tiny
    with pytest.warns(DeprecationWarning, match="deprecated"):
        legacy = SlotEngine(model, params, n_slots=3, max_seq=64,
                            queue_capacity=4, retry_budget=1)
    modern = SlotEngine(model, params, config=EngineConfig(
        n_slots=3, max_seq=64, queue_capacity=4, retry_budget=1))
    assert legacy.config == modern.config
    assert (legacy.n_slots, legacy.max_seq, legacy.retry_budget) == (3, 64, 1)
    want = [r.tokens for r in modern.serve(_requests(128, [4, 6], [3, 2]))]
    got = [r.tokens for r in legacy.serve(_requests(128, [4, 6], [3, 2]))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        wave = Engine(model, params, batch_size=2, max_seq=32,
                      pool_capacity=1)
    assert wave.config.n_slots == wave.config.batch_size == 2
    # the same fields as the JAX package's EngineConfig
    assert [f.name for f in dataclasses.fields(EngineConfig)] == \
        [f.name for f in dataclasses.fields(JaxEngineConfig)]


def test_engine_config_rejects_mixed_and_unknown(tiny):
    _, _, model, params = tiny
    with pytest.raises(ValueError, match="not both"):
        SlotEngine(model, params, config=EngineConfig(), n_slots=2)
    with pytest.raises(TypeError, match="unexpected keyword"):
        SlotEngine(model, params, bogus_knob=2)
    with pytest.raises(TypeError, match="unexpected keyword"):
        Engine(model, params, n_slots=2)      # a slot-only spelling


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------
def test_chunk_schedule_fixed_shapes():
    assert chunk_schedule(13, 8) == [8, 4, 1]
    assert chunk_schedule(24, 8) == [8, 8, 8]
    assert chunk_schedule(7, 8) == [4, 2, 1]
    assert chunk_schedule(1, 8) == [1]
    assert chunk_schedule(0, 8) == []
    with pytest.raises(ValueError):
        chunk_schedule(4, 0)
    for s in range(1, 70):
        segs = chunk_schedule(s, 8)
        assert sum(segs) == s and set(segs) <= {8, 4, 2, 1}
        assert segs == jax_serving.chunk_schedule(s, 8)


def test_chunked_prefill_token_identity_and_one_shape(tiny):
    """Chunking changes scheduling, not math: greedy tokens equal
    whole-prompt admission's and the JAX chunked engine's; the chunks run
    at the segment lengths of ``chunk_schedule`` only (JAX's one
    executable per distinct length), and both pools keep their
    build-time buffers through lane churn."""
    jmodel, plain, model, params = tiny
    lens, news = [5, 29, 3, 13, 7, 21], [4, 6, 3, 5, 2, 4]
    whole = SlotEngine(model, params, config=EngineConfig(
        n_slots=3, max_seq=64)).serve(_requests(128, lens, news, seed=3))
    jreqs, reqs = _both(128, lens, news, seed=3)
    want = JaxSlotEngine(jmodel, plain, config=JaxEngineConfig(
        n_slots=3, max_seq=64, prefill_chunk_len=8,
        prefill_lanes=2)).serve(jreqs)
    engine = SlotEngine(model, params, config=EngineConfig(
        n_slots=3, max_seq=64, prefill_chunk_len=8, prefill_lanes=2))
    seen = []
    step = engine._prefill_chunk

    def watched(cache, batch, first):
        seen.append(batch["tokens"].shape[1])
        return step(cache, batch, first)

    engine._prefill_chunk = watched
    got = engine.serve(reqs)
    _same_results(got, want)
    for w, g in zip(whole, got):
        assert g.finish_reason == "length"
        np.testing.assert_array_equal(w.tokens, g.tokens)
    segs = set()
    for n in lens:
        segs.update(chunk_schedule(n, 8))
    assert set(seen) == segs
    assert len(seen) == sum(len(chunk_schedule(n, 8)) for n in lens)
    assert engine.pool.stats.buffers_built == 1
    sp = engine._scratch_pool.stats
    assert sp.buffers_built == sp.capacity == 2
    assert sp.outstanding == 0
    assert engine.metrics.histogram("serving/prefill_chunk_s").count == \
        len(seen)


def test_decode_continues_during_chunked_prefill(tiny):
    jmodel, plain, model, params = tiny

    def reqs(cls):
        return [cls(0, np.arange(1, 5, dtype=np.int32), max_new_tokens=12),
                cls(1, np.arange(1, 25, dtype=np.int32), max_new_tokens=2)]

    kw = dict(n_slots=2, max_seq=64, queue_capacity=4, prefill_chunk_len=4,
              prefill_lanes=2)
    jevents, events = [], []
    want = JaxSlotEngine(jmodel, plain, config=JaxEngineConfig(**kw)).serve(
        reqs(jax_serving.Request), on_token=jevents.append)
    results = SlotEngine(model, params, config=EngineConfig(**kw)).serve(
        reqs(Request), on_token=events.append)
    _same_results(results, want)
    uids = [ev.uid for ev in events if ev.token is not None]
    assert uids == [ev.uid for ev in jevents if ev.token is not None]
    assert uids[:uids.index(1)].count(0) >= 5
    assert all(r.finish_reason == "length" for r in results)


def test_partial_prefill_abort_keeps_pool_at_capacity(tiny):
    jmodel, plain, model, params = tiny

    def reqs(cls):
        return [cls(0, np.arange(1, 41, dtype=np.int32), max_new_tokens=4,
                    deadline_s=4.0),
                cls(1, np.arange(1, 7, dtype=np.int32), max_new_tokens=3)]

    kw = dict(n_slots=1, max_seq=64, queue_capacity=4, prefill_chunk_len=4,
              prefill_lanes=1)
    want = JaxSlotEngine(jmodel, plain, clock=FakeClock(),
                         config=JaxEngineConfig(**kw)).serve(
        reqs(jax_serving.Request))
    engine = SlotEngine(model, params, clock=FakeClock(),
                        config=EngineConfig(**kw))
    results = engine.serve(reqs(Request))
    _same_results(results, want)
    assert results[0].finish_reason == "deadline"
    assert results[0].tokens.shape[-1] == 0
    assert results[1].finish_reason == "length"
    assert results[1].tokens.shape == (3,)
    sp = engine._scratch_pool.stats
    assert sp.buffers_built == sp.capacity == 1
    assert sp.outstanding == 0
    assert engine.pool.stats.buffers_built == 1
    assert engine.metrics.counter("serving/deadline_miss").value == 1


def test_chunked_rejects_invalid_config(tiny):
    _, _, model, params = tiny
    with pytest.raises(ValueError, match="prefill_chunk_len"):
        SlotEngine(model, params, config=EngineConfig(
            n_slots=2, max_seq=64, prefill_chunk_len=65))
    with pytest.raises(ValueError, match="prefill_lanes"):
        SlotEngine(model, params, config=EngineConfig(
            n_slots=2, max_seq=64, prefill_chunk_len=4, prefill_lanes=0))


# ---------------------------------------------------------------------------
# Per-family sweeps (the JAX package's slow cases), against JAX's engine
# ---------------------------------------------------------------------------
FAMILIES = ["qwen2-0.5b", "jamba-attention-free", "rwkv6-3b", "olmoe-1b-7b",
            "jamba-1.5-large-398b"]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    arch = request.param
    jmodel, plain, model, params = _pair(lambda get: _family(get, arch))
    vocab = model.cfg.vocab
    jreqs, reqs = _both(vocab, [4, 10, 6, 8], [3, 8, 2, 5], seed=1)
    return arch, jmodel, plain, model, params, jreqs, reqs


def test_chunked_prefill_token_identity_per_family(family):
    """Chunked admission equals whole-prompt admission and JAX's chunked
    engine for every serving family — attention replays the positions
    through the chunk mask, rwkv/mamba prefill FROM their cache state."""
    _, jmodel, plain, model, params, jreqs, reqs = family
    kw = dict(n_slots=2, max_seq=32, prefill_chunk_len=4, prefill_lanes=2)
    want = JaxSlotEngine(jmodel, plain,
                         config=JaxEngineConfig(**kw)).serve(jreqs)
    chunked = SlotEngine(model, params, config=EngineConfig(**kw)
                         ).serve(reqs)
    whole = SlotEngine(model, params, config=EngineConfig(
        n_slots=2, max_seq=32)).serve(reqs)
    _same_results(chunked, want)
    _same_results(whole, want)


def test_slot_vs_wave_equivalence(family):
    """The slot engine's greedy outputs equal JAX's slot engine's and the
    unpadded per-request reference (the wave engine at batch_size=1)."""
    _, jmodel, plain, model, params, jreqs, reqs = family
    want = JaxSlotEngine(jmodel, plain, config=JaxEngineConfig(
        n_slots=2, max_seq=32)).serve(jreqs)
    out = SlotEngine(model, params, config=EngineConfig(
        n_slots=2, max_seq=32)).serve(reqs)
    ref = Engine(model, params, config=EngineConfig(
        n_slots=1, max_seq=32, pool_capacity=1)).serve(reqs)
    _same_results(out, want)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(r.tokens, o.tokens)


# ---------------------------------------------------------------------------
# The tick: no host sync, nothing rebound
# ---------------------------------------------------------------------------
class _NoHostSync(TorchDispatchMode):
    """Fails on every op a CUDA-graph capture cannot hold: a device value
    read on the host, or a tensor whose shape depends on data."""
    FORBIDDEN = {"_local_scalar_dense", "item", "is_nonzero", "equal",
                 "allclose", "nonzero", "masked_select", "unique",
                 "_unique", "_unique2", "unique_dim", "unique_consecutive",
                 "repeat_interleave", "masked_scatter", "argwhere"}

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.ops.add(name)
        if name in self.FORBIDDEN:
            raise AssertionError(f"host sync or data-dependent shape in the "
                                 f"tick: aten.{name}")
        if name in ("index", "index_put", "index_put_", "_index_put_impl_",
                    "index_select") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in _flat(args[1] if len(args) > 1 else [])):
            raise AssertionError(f"boolean indexing in the tick: "
                                 f"aten.{name}")
        return func(*args, **kwargs)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


@pytest.mark.parametrize("arch", FAMILIES)
def test_tick_captures_no_host_sync_and_keeps_buffers(arch):
    """One tick of each family under the dispatch mode (the whole tick:
    the active-masked step, the poison hook, the finite guard, greedy
    sampling and the copy into ``tokens``), with lanes active and free;
    the manager's cache and tick buffers keep their addresses across
    admit, tick and retire."""
    cfg = _family(get_arch, arch)
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    engine = SlotEngine(model, params, config=EngineConfig(n_slots=3,
                                                           max_seq=24))
    ptrs = _resident_ptrs(engine)
    tick = engine.ticks["decode/base"]
    inner, modes = tick.fn, []

    def guarded(*args):
        with _NoHostSync() as mode:
            out = inner(*args)
        modes.append(mode)
        return out

    tick.fn = guarded
    results = engine.serve(_requests(cfg.vocab, [5, 3], [4, 3]))
    assert [r.finish_reason for r in results] == ["length"] * 2
    assert len(modes) == 3 and all("where" in m.ops for m in modes)
    assert _resident_ptrs(engine) == ptrs
    assert engine.manager.active.tolist() == [False] * 3
    # the warmup-free eager tick returns static-shaped outputs
    sampled, lane_ok, logits = tick()
    assert sampled.shape == (3,) and lane_ok.dtype == torch.bool
    assert logits.shape == (3, cfg.vocab)
    assert _resident_ptrs(engine) == ptrs


def test_decode_tick_refuses_a_graph_on_the_cpu(tiny):
    _, _, model, params = tiny
    engine = SlotEngine(model, params, config=EngineConfig(n_slots=2,
                                                           max_seq=16))
    with pytest.raises(ValueError, match="CUDA"):
        DecodeTick(engine.ticks["decode/base"].fn, params,
                   engine.manager.cache, engine.manager.tick_batch(),
                   graph=True)
    assert engine.ticks["decode/base"].graph is None     # the CPU: eager


def test_launch_counts_read_every_kernel_wrapper(monkeypatch):
    """The decode tick counts its captured launches over the kernels
    package's registry: every wrapper with a ``launches`` counter, by
    name, so a family's decode kernel is counted without serving naming
    it."""
    from repro_torch import kernels
    from repro_torch.kernels import decode_attn, mamba_scan, wkv6

    counts = kernels.launch_counts()
    assert {"lstm_cell", "lstm_seq", "lstm_seq_bwd", "wkv6", "wkv6_bwd",
            "mamba_scan", "mamba_scan_bwd", "flash_prefill",
            "decode_attn"} <= set(counts)
    assert all(isinstance(v, int) for v in counts.values())
    for fn, n in ((decode_attn.decode_attn, 3), (mamba_scan.mamba_scan, 2),
                  (wkv6.wkv6, 1)):
        monkeypatch.setattr(fn, "launches", fn.launches + n)
    after = kernels.launch_counts()
    assert {k: after[k] - counts[k] for k in after if after[k] != counts[k]
            } == {"decode_attn": 3, "mamba_scan": 2, "wkv6": 1}


def test_per_lane_pos_cache_spec(tiny):
    _, _, model, _ = tiny
    assert model.init_cache(3, 8, per_lane_pos=True)["pos"].shape == (3,)
    assert model.init_cache(3, 8)["pos"].shape == ()


# ---------------------------------------------------------------------------
# chunk_prefill_attention against JAX's (full, ring and int8 caches)
# ---------------------------------------------------------------------------
CACHES = {"full": {}, "ring": dict(sliding_window=8),
          "int8": dict(kv_quant=True)}


@pytest.mark.parametrize("kind", sorted(CACHES))
def test_chunk_prefill_attention_matches_jax(kind):
    """Three consecutive chunks (5, 2, 1 tokens from position 0) of two
    rows against JAX's on the same cache: the outputs at 1e-5 and the
    cache after each chunk equal (int8 codes within one step)."""
    over = CACHES[kind]
    get_cfg = (lambda get: dataclasses.replace(
        get("qwen2-0.5b").reduced(), **over))
    jcfg, cfg = get_cfg(jax_get_arch), get_cfg(get_arch)
    jmodel = jax_registry.build(jcfg)
    plain, _ = split(jmodel.init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, plain)
    mix = tree["blocks"][0]["mix"]
    rng = np.random.default_rng(5)
    for b in ("bq", "bk", "bv"):
        mix[b] = (0.1 * rng.standard_normal(mix[b].shape)).astype(
            mix[b].dtype)
    p_j = jax.tree.map(lambda a: a[0], mix)
    p_t = convert.params_from_numpy(p_j)
    max_seq, B = 12, 2
    jcache, _ = split(jax_attention.init_cache_slot(
        jcfg, 1, B, max_seq, np.float32))
    jcache = {k: np.asarray(v)[0] for k, v in jcache.items()}
    tcache = convert.params_from_numpy(jcache)
    jcache = {k: jax.numpy.asarray(v) for k, v in jcache.items()}
    start = 0
    for L in (5, 2, 1):
        x = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(start + np.arange(L), (B, L)).astype(np.int32)
        want, jcache = jax_attention.chunk_prefill_attention(
            p_j, x, jcache, jcfg, pos)
        got = attention.chunk_prefill_attention(
            p_t, torch.from_numpy(x), tcache, cfg, torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        for name, w in jcache.items():
            w = np.asarray(w)
            g = tcache[name].numpy()
            if w.dtype == np.int8:
                assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                           err_msg=name)
        start += L
