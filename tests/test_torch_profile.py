"""The port's measured profiler (``repro_torch.obs.profile``), the
families' profile hooks (``core/plans.py``), ``Scheduler.calibrate(
profile=)`` and the JSONL trace sink, on the CPU: the JAX package's
tests/test_obs.py cases on the port, plus its files read by the JAX
package.  On the CPU a candidate runs the kernel's plain version, so the
times here say nothing of the card; ``chip_smoke.py`` (P2, P3) sweeps the
kernels there."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.obs import profile as jax_profile  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402

from repro_torch.core import factorization, plans  # noqa: E402
from repro_torch.core.scheduler import (Plan, Scheduler,  # noqa: E402
                                        SyntheticLoadSensor)
from repro_torch.obs import profile as profile_lib  # noqa: E402
from repro_torch.obs import trace as trace_lib  # noqa: E402

HOOKS = {"lstm": {"batch": 2, "seq_len": 16},
         "rwkv6": {"seq_len": 32, "n_bh": 2, "target": 8},
         "mamba": {"batch": 2, "seq_len": 32, "d_inner": 40, "d_state": 5}}


@pytest.fixture
def list_sink():
    """Install a ListSink tracer globally; always restore the old one."""
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    yield sink
    trace_lib.set_tracer(old)


@pytest.fixture(scope="module")
def swept():
    return profile_lib.profile_families(
        ("lstm", "rwkv6"), repeats=1, warmup=1, max_points=2,
        hook_kwargs=HOOKS, device="cpu")


def test_profiler_sweeps_both_families(swept):
    assert swept.families() == ["lstm", "rwkv6"]
    assert swept.device_kind == profile_lib.device_kind("cpu") == "cpu:cpu"
    assert swept.key == f"cpu:cpu/smem{factorization.H100_SMEM_PER_BLOCK}"
    for fam in ("lstm", "rwkv6"):
        pts = [p for p in swept.points if p.family == fam]
        assert len(pts) >= 2          # >= 2 tiling points per family
        for p in pts:
            assert p.measured_s > 0 and math.isfinite(p.measured_s)
            assert p.point            # tiling coordinates recorded


def test_profile_save_load_round_trip(swept, tmp_path):
    path = swept.save(str(tmp_path / "profile.json"))
    loaded = profile_lib.DeviceProfile.load(path)
    assert loaded.to_json() == swept.to_json()
    assert loaded.key == swept.key


def test_profile_file_reads_through_the_jax_package(swept, tmp_path):
    """The JSON keeps JAX's schema: JAX's loader reads the port's file,
    its budget field holding the shared memory of a block."""
    path = swept.save(str(tmp_path / "profile.json"))
    theirs = jax_profile.DeviceProfile.load(path)
    assert theirs.vmem_budget == swept.smem_budget
    assert theirs.best_latencies() == swept.best_latencies()
    assert [p.to_json() for p in theirs.points] == \
        [p.to_json() for p in swept.points]
    back = profile_lib.DeviceProfile.from_json(theirs.to_json())
    assert back.to_json() == swept.to_json()


def test_model_vs_measured_report(swept):
    rows = profile_lib.model_vs_measured(swept, threshold=3.0)
    assert len(rows) == len(swept.points)
    for r in rows:
        assert r["finite"]            # every profiled point has a model
        assert r["ratio"] > 0
    # the plain versions on the CPU against the H100's roofline: far off,
    # the ratio is a relative diagnostic here
    assert all(r["diverged"] for r in rows)
    assert not any(r["diverged"] for r in profile_lib.model_vs_measured(
        swept))
    with pytest.raises(ValueError, match="> 1"):
        profile_lib.model_vs_measured(swept, threshold=1.0)


def test_calibrate_consumes_profile(swept, list_sink):
    def boom(*a, **k):
        raise AssertionError("profiled plan must not run during calibrate")

    ran = []
    s = Scheduler(SyntheticLoadSensor(0.0))
    s.register(Plan("fused_seq", boom))
    s.register(Plan("chunked_scan", boom))
    s.register(Plan("sequential", lambda: ran.append(1)))
    s.calibrate(profile=swept.best_latencies(), repeats=2)
    for name in ("fused_seq", "chunked_scan"):
        assert s.plans[name].base_latency_s == \
            swept.best_latencies()[name] > 0
    assert len(ran) == 3              # one warmup and two timed calls
    sources = {r["attrs"]["plan"]: r["attrs"]["source"]
               for r in list_sink.records if r["name"] == "sched/calibrate"}
    assert sources == {"fused_seq": "profile", "chunked_scan": "profile",
                       "sequential": "measured"}
    # rename maps family plan names onto the scheduler's registry
    renamed = swept.best_latencies(rename={"fused_seq": "accel"})
    assert "accel" in renamed and "fused_seq" not in renamed


def test_unknown_family_hook_raises(monkeypatch):
    fam = plans.get_family("lstm")
    assert fam.profile_hook is not None
    bare = dataclasses.replace(fam, profile_hook=None)
    monkeypatch.setattr(plans, "get_family", lambda name: bare)
    with pytest.raises(ValueError, match="no profile_hook"):
        profile_lib.profile_families(("lstm",), max_points=1, device="cpu")


def test_profile_points_are_traced(list_sink):
    prof = profile_lib.profile_families(
        ("mamba",), repeats=1, warmup=0, max_points=2, hook_kwargs=HOOKS,
        device="cpu")
    events = [r for r in list_sink.records if r["name"] == "profile/point"]
    assert len(events) == len(prof.points) == 2
    for e, p in zip(events, prof.points):
        assert e["attrs"]["measured_s"] == p.measured_s
        assert {k: e["attrs"][k] for k in p.point} == p.point


@pytest.mark.parametrize("family", ["lstm", "rwkv6", "mamba"])
def test_hooks_admit_only_points_within_a_blocks_shared_memory(family):
    """Every point of each hook fits a thread block, in the coarse-to-fine
    order of the JAX hooks, and its candidate runs the plain version on the
    CPU (``fn`` equal to ``plain`` bit for bit)."""
    from repro_torch.kernels import lstm_seq as seq_lib
    from repro_torch.kernels import mamba_scan as ms_lib
    from repro_torch.kernels import wkv6 as wkv6_lib

    hook = plans.get_family(family).profile_hook
    budget = factorization.H100_SMEM_PER_BLOCK
    cands = hook(max_points=8, device="cpu", **HOOKS[family])
    assert cands
    for c in cands:
        assert c.family == family and c.model_s > 0
        p = c.point
        if family == "lstm":
            x = c.args[2]
            ws = seq_lib.working_set_bytes(
                x.shape[1], 2, x.shape[2], 32, p["block_b"],
                time_chunk=p["time_chunk"], n_blocks=p.get("n_blocks", 1))
        elif family == "rwkv6":
            ws = wkv6_lib.working_set_bytes(c.args[0].shape[1], 8, 8,
                                            p["chunk"])
        else:
            ws = ms_lib.working_set_bytes(c.args[0].shape[1], 5, p["chunk"],
                                          p["di_tile"])
        assert ws <= budget, (family, p, ws)
        got, want = c.fn(*c.args), c.plain(*c.args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    if family == "lstm":
        # one block holds the paper's 2 x 32: no split points
        assert [(c.point["time_chunk"], c.point.get("n_blocks", 1))
                for c in cands] == [(None, 1), (8, 1), (4, 1)]
        # at 2 x 64 the table splits the f32 stack over G blocks, and the
        # hook offers the table's tile over G and 2G blocks only
        table = seq_lib.choose_batch_block(2, 16, 2, 64, 64)
        wide = hook(max_points=8, device="cpu", hidden=64, **HOOKS[family])
        assert [(c.point["block_b"], c.point["n_blocks"]) for c in wide] == \
            [(table.block_b, table.n_blocks),
             (table.block_b, 2 * table.n_blocks)]
        for c in wide:
            assert seq_lib.working_set_bytes(
                16, 2, 64, 64, c.point["block_b"],
                n_blocks=c.point["n_blocks"]) <= budget
            got, want = c.fn(*c.args), c.plain(*c.args)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    elif family == "rwkv6":
        assert [c.point["chunk"] for c in cands] == [8, 4, 2, 1]
    else:
        assert [(c.point["di_tile"], c.point["chunk"]) for c in cands] == \
            [(64, 32), (64, 16), (64, 8), (64, 4), (32, 32), (32, 16),
             (32, 8), (32, 4)]
    # a budget nothing fits admits nothing
    assert hook(max_points=8, device="cpu", smem_budget=1,
                **HOOKS[family]) == []


def test_time_fn_is_the_best_of_its_repeats():
    calls = []
    assert profile_lib.time_fn(lambda: calls.append(1), repeats=3,
                               warmup=2) >= 0
    assert len(calls) == 5


def test_jsonl_trace_reads_back_through_the_jax_package(tmp_path):
    """A trace the port writes (``configure(path)``) reads back through
    the JAX package's ``read_jsonl`` as the same records: non-finite floats
    as null, numpy and tensor scalars as numbers, arrays as lists."""
    path = str(tmp_path / "trace.jsonl")
    old = trace_lib.get_tracer()
    tracer = trace_lib.configure(path)
    try:
        with tracer.span("sched/run", plan="fused_seq") as span:
            tracer.event("sched/choose", plan="fused_seq",
                         predicted_s=float("inf"), load=np.float32(0.5),
                         n=torch.tensor(3), shape=np.arange(3))
            span.set(latency_s=0.25)
        tracer.event("profile/point", measured_s=float("nan"))
    finally:
        tracer.close()
        trace_lib.set_tracer(old)
    assert not tracer.enabled
    mine = trace_lib.read_jsonl(path)
    assert jax_trace.read_jsonl(path) == mine
    assert [r["name"] for r in mine] == ["sched/choose", "sched/run",
                                         "profile/point"]
    choose, run, point = mine
    assert choose["attrs"] == {"plan": "fused_seq", "predicted_s": None,
                               "load": 0.5, "n": 3, "shape": [0, 1, 2]}
    assert choose["parent"] == run["span"] and run["type"] == "span"
    assert run["attrs"]["latency_s"] == 0.25 and run["dur_s"] >= 0
    assert point["attrs"]["measured_s"] is None
    assert [r["seq"] for r in mine] == [0, 1, 2]
    with pytest.raises(ValueError, match="path or sink"):
        trace_lib.configure(path, sink=trace_lib.ListSink())
