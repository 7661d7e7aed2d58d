"""The port's serving slice against the JAX package: the four plans, the
``fused_cell`` route, the scheduler, the classifier module, the HAR data
and the ``launch.classify`` entry point, all on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mobirnn_lstm import LSTMConfig as JaxConfig  # noqa: E402
from repro.core import lstm as jax_lstm  # noqa: E402
from repro.core import wavefront as jax_wavefront  # noqa: E402
from repro.data import har as jax_har  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.mobirnn_lstm import LSTMConfig  # noqa: E402
from repro_torch.core import lstm, wavefront  # noqa: E402
from repro_torch.core.scheduler import (Plan, Scheduler,  # noqa: E402
                                        SyntheticLoadSensor)
from repro_torch.data import har  # noqa: E402
from repro_torch.launch import classify  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402

#: the JAX package's f32 LSTM tolerance (core/plans.LSTM_TOL)
TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dict(hidden=16, n_layers=2, seq_len=8)


def _both(seed, **shape):
    """The JAX params of ``shape`` (annotated, as its plans take them) and
    the port's copy of their plain tree."""
    jcfg = JaxConfig(**shape)
    jparams = jax_lstm.init_params(jax.random.PRNGKey(seed), jcfg)
    plain, _ = split(jparams)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    return jcfg, jparams, LSTMConfig(**shape), tparams


def _x(seed, B, T, D=9):
    return np.random.default_rng(seed).standard_normal(
        (B, T, D)).astype(np.float32)


@pytest.fixture(scope="module")
def small():
    """B=3, T=8, H=16, L=2: params, input, and the JAX sequential and
    fused_seq (Pallas, interpret mode) logits."""
    jcfg, jparams, cfg, params = _both(0, **SMALL)
    x = _x(1, 3, 8)
    return dict(
        cfg=cfg, params=params, x=torch.from_numpy(x),
        sequential=np.asarray(jax_lstm.forward_sequential(
            jparams, jnp.asarray(x), jcfg)),
        fused_seq=np.asarray(jax_lstm.forward_fused_seq(
            jparams, jnp.asarray(x), jcfg, interpret=True)))


@pytest.mark.parametrize("jax_plan", ["sequential", "fused_seq"])
@pytest.mark.parametrize("plan", list(lstm.FORWARD_PLANS))
def test_plan_matches_jax(small, plan, jax_plan):
    got = lstm.FORWARD_PLANS[plan](small["params"], small["x"], small["cfg"])
    np.testing.assert_allclose(got.numpy(), small[jax_plan], **TOL)


def test_the_port_has_four_plans():
    assert list(lstm.FORWARD_PLANS) == ["sequential", "wavefront",
                                        "fused_cell", "fused_seq"]
    assert set(lstm.FORWARD_PLANS) < set(jax_lstm.FORWARD_PLANS)


def test_slice_at_full_width_matches_jax():
    """2 x 32, T=128, B=4: the port's fused_seq against JAX sequential."""
    jcfg, jparams, cfg, params = _both(7)
    x = _x(8, 4, cfg.seq_len)
    want = jax.jit(lambda p, v: jax_lstm.forward_sequential(p, v, jcfg))(
        jparams, jnp.asarray(x))
    got = lstm.forward_fused_seq(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _dispatch_events(fn):
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        out = fn()
    finally:
        trace_lib.set_tracer(old)
    return out, [r for r in sink.records if r["name"] == "plan/dispatch"]


def test_fused_seq_routes_to_fused_cell_with_an_event(small):
    out, events = _dispatch_events(lambda: lstm.forward_fused_seq(
        small["params"], small["x"], small["cfg"], smem_budget=1024))
    assert len(events) == 1
    ev = events[0]
    assert ev["type"] == "event" and ev["attrs"]["fallback"] == "fused_cell"
    assert ev["attrs"]["plan"] == "fused_seq"
    assert {"type", "name", "seq", "ts", "span", "parent", "attrs"} <= set(ev)
    np.testing.assert_allclose(out.numpy(), small["sequential"], **TOL)


def test_fused_seq_reports_its_tiling(small):
    _, events = _dispatch_events(lambda: lstm.forward_fused_seq(
        small["params"], small["x"], small["cfg"]))
    assert len(events) == 1 and "fallback" not in events[0]["attrs"]
    assert events[0]["attrs"]["block_b"] == 1      # one row per block
    assert events[0]["attrs"]["time_chunk"] is None


def test_fused_seq_routes_at_2x64():
    cfg = LSTMConfig().with_complexity(64, 2)
    params = lstm.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_x(2, 1, 3))
    out, events = _dispatch_events(
        lambda: lstm.forward_fused_seq(params, x, cfg))
    assert events[0]["attrs"]["fallback"] == "fused_cell"
    torch.testing.assert_close(out, lstm.forward_sequential(params, x, cfg),
                               **TOL)


def test_plan_viability():
    paper = lstm.plan_viability(LSTMConfig(), 1, 128)
    wide = lstm.plan_viability(LSTMConfig().with_complexity(64, 2), 1, 128)
    assert all(paper(n) for n in lstm.FORWARD_PLANS)
    assert not wide("fused_seq")
    assert all(wide(n) for n in lstm.FORWARD_PLANS if n != "fused_seq")


def test_scheduler_calibrates_and_chooses(small):
    args = (small["params"], small["x"][:1], small["cfg"])
    sched = Scheduler(SyntheticLoadSensor(0.0),
                      viable=lstm.plan_viability(small["cfg"], 1, 8,
                                                 smem_budget=1024),
                      ladder=["wavefront"])
    for name, fn in lstm.FORWARD_PLANS.items():
        sched.register(Plan(name, fn))
    sched.calibrate(*args, repeats=1)
    assert sched.plans["fused_seq"].base_latency_s == float("inf")
    assert all(0 < sched.plans[n].base_latency_s < float("inf")
               for n in ("sequential", "wavefront", "fused_cell"))
    d = sched.choose()
    assert d.plan != "fused_seq" and set(d.predicted_s) == {
        "sequential", "wavefront", "fused_cell"}
    out, d2 = sched.run(*args)
    assert out.shape == (1, small["cfg"].n_classes)
    assert sched.degrade() and "wavefront" not in sched.choose().predicted_s
    assert not sched.degrade()                   # the ladder is spent
    assert sched.recover() and not sched.recover()


def test_classifier_module_runs_each_plan(small):
    for name in lstm.FORWARD_PLANS:
        model = lstm.LSTMClassifier(small["cfg"], plan=name,
                                    params=small["params"])
        assert not any(p.requires_grad for p in model.parameters())
        np.testing.assert_allclose(model(small["x"]).numpy(),
                                   small["sequential"], **TOL)
    with pytest.raises(ValueError):
        lstm.LSTMClassifier(small["cfg"], plan="fused_seq_q8")


def test_accuracy_matches_jax():
    jcfg, jparams, cfg, params = _both(3, **SMALL)
    x = _x(4, 6, 8)
    labels = np.arange(6, dtype=np.int32) % 6
    want = jax_lstm.accuracy(jparams, jnp.asarray(x), jnp.asarray(labels),
                             jcfg)
    got = lstm.accuracy(params, torch.from_numpy(x),
                        torch.from_numpy(labels).long(), cfg)
    assert float(got) == pytest.approx(float(want))


@pytest.mark.parametrize("dims", [(2, 128), (3, 4), (5, 2)])
def test_wavefront_buffers_match_jax(dims):
    assert wavefront.wavefront_width(*dims) == \
        jax_wavefront.wavefront_width(*dims)
    assert wavefront.live_buffers(*dims) == jax_wavefront.live_buffers(*dims)


def test_har_equals_jax_har():
    mine = har.make_har(n_train=5, n_test=3, seed=11)
    theirs = jax_har.make_har(n_train=5, n_test=3, seed=11)
    for m, t in zip(mine, theirs):
        assert np.array_equal(m.x, t.x) and np.array_equal(m.y, t.y)
        assert m.x.dtype == t.x.dtype and m.y.dtype == t.y.dtype


def test_classify_serves_on_the_cpu(capsys):
    out = classify.main(["--device", "cpu", "--requests", "3"])
    assert set(out["table"]) == set(lstm.FORWARD_PLANS)
    assert out["chosen"] in lstm.FORWARD_PLANS
    assert out["logits"].shape == (3, 6)
    assert bool(torch.isfinite(out["logits"]).all())
    printed = capsys.readouterr().out
    assert "scheduler chose" in printed and "fused_seq" in printed


def test_classify_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        classify.main(["--device", "cuda", "--requests", "1"])
