"""The port's serving slice on the CPU: the wave ``Engine`` against the JAX
package's wave ``Engine`` (greedy tokens identical for the same requests
and transplanted params) on the reduced RWKV6-3B and on the reduced
attention-free Jamba stack (Mamba layers, whose decode runs the scan at
T = 1), the preallocated ``StatePool``, and the
``repro_torch.launch.serve`` entry point."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.partitioning import split  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import jamba_1_5_large_398b as jamba  # noqa: E402
from repro_torch.core.state import StatePool, make_buffer  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, FinishReason,  # noqa: E402
                                 Request, Result)

NAME = "rwkv6-3b-reduced"


def _prompts(n, seed=0):
    """Ragged prompts: the wave pads them on the left."""
    rng = np.random.default_rng(seed)
    vocab = get_arch(NAME).vocab
    return [rng.integers(0, vocab, (int(rng.integers(5, 14)),)
                        ).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def engines():
    jmodel = jax_registry.build(jax_get_arch(NAME))
    plain, _ = split(jmodel.init(jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    jengine = JaxEngine(jmodel, plain,
                        config=JaxEngineConfig(n_slots=2, max_seq=32))
    engine = Engine(registry.build(get_arch(NAME)), params,
                    config=EngineConfig(n_slots=2, max_seq=32))
    return jengine, engine


def test_wave_engine_tokens_equal_the_jax_engine(engines):
    jengine, engine = engines
    prompts = _prompts(5)
    budgets = [4, 6, 3, 5, 4]
    want = jengine.serve([JaxRequest(i, p, max_new_tokens=m)
                          for i, (p, m) in enumerate(zip(prompts, budgets))])
    got = engine.serve([Request(i, p, max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, budgets))])
    assert [r.uid for r in got] == [r.uid for r in want] == list(range(5))
    for g, w in zip(got, want):
        assert g.tokens.dtype == np.int32
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert g.finish_reason == FinishReason.LENGTH
        assert set(g.plan_decisions) == {"decode/base"}


@pytest.fixture(scope="module")
def mamba_engines():
    """The JAX and the port's wave engines on the reduced attention-free
    Jamba (``dataclasses.replace`` of the config in both packages)."""
    free = dict(jamba.ATTENTION_FREE, n_layers=2)
    jcfg = dataclasses.replace(jax_get_arch("jamba-1.5-large-398b"),
                               **free).reduced()
    cfg = dataclasses.replace(get_arch("jamba-1.5-large-398b"),
                              **free).reduced()
    jmodel = jax_registry.build(jcfg)
    plain, _ = split(jmodel.init(jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    return (JaxEngine(jmodel, plain,
                      config=JaxEngineConfig(n_slots=2, max_seq=32)),
            Engine(registry.build(cfg), params,
                   config=EngineConfig(n_slots=2, max_seq=32)))


def test_mamba_wave_engine_tokens_equal_the_jax_engine(mamba_engines):
    """Ragged prompts, left-padded in waves of 2, a short wave filled with
    an inactive lane: greedy tokens equal to JAX's, the pool's buffers
    (conv windows and ssm states) zeroed in place between waves."""
    jengine, engine = mamba_engines
    prompts = _prompts(5, seed=2)
    budgets = [4, 6, 3, 5, 4]
    want = jengine.serve([JaxRequest(i, p, max_new_tokens=m)
                          for i, (p, m) in enumerate(zip(prompts, budgets))])
    got = engine.serve([Request(i, p, max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, budgets))])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    stats = engine.pool.stats
    assert stats.buffers_built == stats.capacity and stats.outstanding == 0
    buf = engine.pool.checkout()
    assert set(buf["slots"][0]) == {"conv", "h"}
    engine.pool.give_back(buf)


@pytest.fixture(scope="module")
def dense_engines():
    """The JAX and the port's wave engines on ``qwen2-0.5b-reduced``, its
    QKV biases (zero as drawn) set at random in both."""
    name = "qwen2-0.5b-reduced"
    jmodel = jax_registry.build(jax_get_arch(name))
    plain, _ = split(jmodel.init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, plain)
    rng = np.random.default_rng(3)
    mix = tree["blocks"][0]["mix"]
    for b in ("bq", "bk", "bv"):
        mix[b] = (0.1 * rng.standard_normal(mix[b].shape)).astype(
            mix[b].dtype)
    return (JaxEngine(jmodel, jax.tree.map(jax.numpy.asarray, tree),
                      config=JaxEngineConfig(n_slots=2, max_seq=32)),
            Engine(registry.build(get_arch(name)),
                   convert.params_from_numpy(tree),
                   config=EngineConfig(n_slots=2, max_seq=32)))


def test_dense_wave_engine_tokens_equal_the_jax_engine(dense_engines):
    """Ragged prompts left-padded with token 0 at positions arange(S) (no
    pad mask, as the JAX engine runs them) in waves of 2, a short wave
    filled with an inactive lane: greedy tokens equal to JAX's, the k/v
    caches zeroed in place between waves."""
    jengine, engine = dense_engines
    prompts = _prompts(5, seed=4)
    budgets = [4, 6, 3, 5, 4]
    want = jengine.serve([JaxRequest(i, p, max_new_tokens=m)
                          for i, (p, m) in enumerate(zip(prompts, budgets))])
    got = engine.serve([Request(i, p, max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, budgets))])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    stats = engine.pool.stats
    assert stats.buffers_built == stats.capacity and stats.outstanding == 0
    buf = engine.pool.checkout()
    assert set(buf["slots"][0]) == {"k", "v"}
    assert not any(bool(t.any()) for t in buf["slots"][0].values())
    engine.pool.give_back(buf)


def test_pool_never_allocates_while_serving(engines):
    _, engine = engines
    stats = engine.pool.stats
    built, checkouts = stats.buffers_built, stats.checkouts
    engine.serve([Request(i, p, max_new_tokens=3)
                  for i, p in enumerate(_prompts(4, seed=1))])
    assert stats.buffers_built == built == stats.capacity
    assert stats.outstanding == 0 and stats.resets == stats.checkouts
    assert stats.checkouts == checkouts + 2       # one per wave of 2


def test_wave_traces_its_span(engines):
    _, engine = engines
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        engine.serve([Request(0, _prompts(1)[0], max_new_tokens=2)])
    finally:
        trace_lib.set_tracer(old)
    spans = [r for r in sink.records if r["name"] == "serve/wave"]
    assert len(spans) == 1 and spans[0]["attrs"]["max_new"] == 2
    assert "decode_s" in spans[0]["attrs"]


def test_state_pool_checks_out_and_zeroes_in_place():
    spec = {"a": torch.empty(2, 3, device="meta"),
            "b": [torch.empty(4, dtype=torch.int32, device="meta")]}
    pool = StatePool(spec, capacity=2)
    x = pool.checkout()
    y = pool.checkout()
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.checkout()
    x["a"].fill_(3.0)
    x["b"][0].fill_(7)
    storage = x["a"].data_ptr()
    pool.give_back(x)
    z = pool.checkout()
    assert z["a"].data_ptr() == storage and not z["a"].any() \
        and not z["b"][0].any()
    assert pool.stats.buffers_built == 2 and pool.stats.high_water == 2
    assert pool.stats.allocation_bytes == 2 * (6 * 4 + 4 * 4)
    assert make_buffer(spec, "cpu")["a"].device.type == "cpu"
    del y


def test_result_finish_reason_is_a_closed_set():
    with pytest.raises(ValueError):
        Result(0, np.zeros(0, np.int32), 0.0, 0.0, [], finish_reason="oops")


def test_serve_entry_point_runs_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                      "--prompt-len", "9", "--max-new", "2",
                      "--batch-size", "2"])
    assert len(out["results"]) == 3
    assert all(r.tokens.shape == (2,) for r in out["results"])
    assert len(out["waves"]) == 2
    assert out["pool"].buffers_built == out["pool"].capacity
    printed = capsys.readouterr().out
    assert "arch=rwkv6-3b-reduced served=3 new_tokens=6" in printed
    assert "wave 1: prefill" in printed and "ms/token" in printed


def test_serve_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--requests", "1"])


def test_slot_engine_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="slot"):
        serve.main(["--device", "cpu", "--reduced", "--engine", "slot"])
