"""The port's analysis module (``repro_torch.analysis``) against the JAX
package's ``repro.analysis`` on the CPU: the model accounting over every
architecture and input shape, the three stream-cost rooflines over a grid
of tilings (their FLOPs and bytes equal JAX's, their times at the H100's
rates), the launch counters against JAX's jaxpr dispatch counts, and the
kernel work that ``chip_smoke.py`` prices its kernel table with, pinned at
PERF.md's shapes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import analysis as jax_analysis  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro import steps as jax_steps  # noqa: E402
from repro.configs.mobirnn_lstm import LSTMConfig as JaxConfig  # noqa: E402
from repro.core import lstm as jax_lstm  # noqa: E402
from repro.core import plans as jax_plans  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import analysis, configs, convert, steps  # noqa: E402
from repro_torch.configs.mobirnn_lstm import LSTMConfig  # noqa: E402
from repro_torch.core import lstm, plans  # noqa: E402
from repro_torch.kernels import lstm_seq as seq_lib  # noqa: E402
from repro_torch.kernels import mamba_scan as ms_lib  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_lib  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

NAMES = sorted(configs.ARCHS)
BF16, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# model accounting: JAX's arithmetic, so every number equals JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_model_accounting_equals_jax(name, reduced):
    full = name + ("-reduced" if reduced else "")
    cfg, jcfg = configs.get_arch(full), jax_configs.get_arch(full)
    assert analysis.param_counts(cfg) == jax_analysis.param_counts(jcfg)
    for shape_name, shape in configs.INPUT_SHAPES.items():
        jshape = jax_configs.INPUT_SHAPES[shape_name]
        assert analysis.model_flops(cfg, shape) == \
            jax_analysis.model_flops(jcfg, jshape)
        assert analysis.analytic_costs(cfg, shape) == \
            jax_analysis.analytic_costs(jcfg, jshape)
        B, S = shape.global_batch, shape.seq_len
        assert analysis.cache_bytes(cfg, B, S) == \
            jax_analysis.cache_bytes(jcfg, B, S)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_param_counts_against_the_built_model(name, reduced):
    """The analytic count is JAX's: it books 4 d_model a layer for norms,
    where the built model holds 2 (RMSNorm scales) or 4 (LayerNorm) a
    layer, its final norm, and per-family vectors; every matrix is counted
    as built.  So the built model's parameters (the full-width one's on
    meta tensors) are within 4 d_model x (layers + 1) of the count, and
    the active count is the total less the experts a token does not
    use."""
    cfg = configs.get_arch(name + ("-reduced" if reduced else ""))
    params = registry.build(cfg).init(
        torch.Generator().manual_seed(0),
        torch.device("cpu" if reduced else "meta"))
    built = sum(t.numel() for t in tree_leaves(params))
    total, active = analysis.param_counts(cfg)
    assert abs(built - total) <= 4 * cfg.d_model * (cfg.n_layers + 1), \
        (built, total)
    if cfg.moe is None:
        assert active == total
    else:
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        mult = 3 if cfg.mlp_act == "swiglu" else 2
        unused = (cfg.moe.n_experts - cfg.moe.top_k) * mult * \
            cfg.d_model * cfg.moe.d_ff
        assert total - active == n_moe * unused


def test_model_flops_counts_active_non_embedding_parameters():
    """The training-step MFU's numerator: 6 N tokens with N the active
    parameters less the embedding, far below 6 x all parameters for a MoE
    model (OLMoE uses 8 of its 64 experts a token)."""
    cfg = configs.get_arch("olmoe-1b-7b")
    total, active = analysis.param_counts(cfg)
    shape = configs.base.ShapeConfig("step", 512, 4, "train")
    emb = cfg.vocab * cfg.d_model
    assert analysis.model_flops(cfg, shape) == 6.0 * (active - emb) * 4 * 512
    assert analysis.model_flops(cfg, shape) < 0.25 * 6 * total * 4 * 512


# ---------------------------------------------------------------------------
# stream-cost rooflines: JAX's flops and bytes, the port's rates and tables
# ---------------------------------------------------------------------------
def _rates_and_table(got, resident):
    assert got["t_compute"] == got["flops"] / analysis.F32_FLOP_PER_S
    assert got["t_memory"] == got["hbm_bytes"] / analysis.HBM_BYTES_PER_S
    assert got["smem_resident_bytes"] == resident
    assert "vmem_resident_bytes" not in got


@pytest.mark.parametrize("mode", ["fwd", "bwd"])
def test_lstm_stream_costs_equal_jax(mode):
    for T, L, P, H, B, bm, tc, db, q8 in [
            (128, 2, 32, 32, 64, 1, None, 4, False),
            (128, 2, 32, 32, 64, 1, 64, 4, False),
            (128, 2, 32, 32, 64, 2, 32, 2, False),
            (300, 2, 32, 32, 64, 1, 128, 4, False),
            (48, 3, 40, 16, 5, 4, 12, 4, True),
            (512, 2, 64, 64, 2, 1, 7, 2, True)]:
        kw = dict(dtype_bytes=db, mode=mode, quantized=q8)
        got = analysis.lstm_seq_stream_costs(T, L, P, H, B, bm, tc, **kw)
        want = jax_analysis.lstm_seq_stream_costs(T, L, P, H, B, bm, tc,
                                                  **kw)
        assert (got["flops"], got["hbm_bytes"]) == \
            (want["flops"], want["hbm_bytes"])
        _rates_and_table(got, seq_lib.working_set_bytes(
            T, L, P, H, bm, db, mode=mode, time_chunk=tc, quantized=q8))


@pytest.mark.parametrize("mode", ["fwd", "bwd"])
def test_wkv6_stream_costs_equal_jax(mode):
    for T, BH, dk, dv, C, bt, db in [(512, 160, 64, 64, 32, 1, 2),
                                     (512, 160, 64, 64, 16, 4, 4),
                                     (500, 160, 64, 64, 32, 1, 4),
                                     (23, 5, 8, 10, 8, 2, 4),
                                     (7, 3, 8, 8, 32, 8, 2)]:
        got = analysis.wkv6_stream_costs(T, BH, dk, dv, C, db, mode,
                                         bh_tile=bt)
        want = jax_analysis.wkv6_stream_costs(T, BH, dk, dv, C, db, mode,
                                              bh_tile=bt)
        assert (got["flops"], got["hbm_bytes"]) == \
            (want["flops"], want["hbm_bytes"])
        _rates_and_table(got, wkv6_lib.working_set_bytes(
            T, dk, dv, min(C, T), mode=mode))


@pytest.mark.parametrize("mode", ["fwd", "bwd"])
def test_mamba_stream_costs_equal_jax(mode):
    for T, B, di, ds, bm, C, db, tile in [
            (512, 4, 16384, 16, 1, 64, 4, None),
            (512, 4, 16384, 16, 2, 32, 2, 64),
            (500, 4, 16384, 16, 4, 512, 4, 32),
            (23, 3, 40, 5, 2, 8, 4, None),
            (1, 4, 64, 16, 1, 1, 2, None)]:
        got = analysis.mamba_scan_stream_costs(T, B, di, ds, bm, C, db,
                                               mode, di_tile=tile)
        want = jax_analysis.mamba_scan_stream_costs(T, B, di, ds, bm, C, db,
                                                    mode)
        assert (got["flops"], got["hbm_bytes"]) == \
            (want["flops"], want["hbm_bytes"])
        _rates_and_table(got, ms_lib.working_set_bytes(
            T, ds, min(C, T), tile or ms_lib.default_di_tile(di, mode), mode,
            io_bytes=db))


def test_roofline_for_one_card():
    r = analysis.Roofline(flops=2e12, hbm_bytes=1e9, model_flops=1e12)
    assert r.t_compute == 2e12 / analysis.BF16_FLOP_PER_S
    assert r.t_memory == 1e9 / analysis.HBM_BYTES_PER_S
    assert r.t_collective == 0.0 and r.dominant == "compute"
    assert r.useful_flops_frac == 0.5
    d = r.to_dict()
    assert d["n_chips"] == 1 and d["collective_bytes"] == {}
    assert d["t_compute_s"] == r.t_compute and d["dominant"] == "compute"
    slow = analysis.Roofline(1e9, 1e12)
    assert slow.dominant == "memory" and slow.useful_flops_frac == 0.0


# ---------------------------------------------------------------------------
# launch counting against JAX's jaxpr dispatch counts
# ---------------------------------------------------------------------------
def _lstm_both(T):
    shape = dict(hidden=16, n_layers=2, seq_len=T)
    jcfg = JaxConfig(**shape)
    jparams = jax_lstm.init_params(jax.random.PRNGKey(0), jcfg)
    plain, _ = split(jparams)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    x = np.random.default_rng(1).standard_normal((2, T, 9)).astype(
        np.float32)
    return jcfg, jparams, LSTMConfig(**shape), tparams, x


@pytest.mark.parametrize("T", [6, 12])
@pytest.mark.parametrize("plan", list(lstm.FORWARD_PLANS))
def test_lstm_launch_counts_equal_jax_dispatches(plan, T):
    jcfg, jparams, cfg, params, x = _lstm_both(T)
    labels = np.array([0, 1])
    jfwd = jax_lstm.FORWARD_PLANS[plan]
    want_fwd = jax_analysis.count_kernel_dispatches(jax.make_jaxpr(
        lambda p, x: jfwd(p, x, jcfg))(jparams, jnp.asarray(x)))
    want_train = jax_analysis.count_train_dispatches(
        lambda p: jax_lstm.loss_fn(p, jnp.asarray(x), jnp.asarray(labels),
                                   jcfg, forward=jfwd), jparams)
    fwd = lstm.FORWARD_PLANS[plan]
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got_fwd = analysis.count_launches(fwd, params, xt, cfg)
    got_train = analysis.count_train_launches(
        lambda p: lstm.loss_fn(p, xt, torch.from_numpy(labels), cfg,
                               forward=fwd), params)
    assert (got_fwd, got_train) == (want_fwd, want_train)
    spec = plans.get_family("lstm").plans[plan]
    if spec.fwd_launches is not None:
        assert (got_fwd, got_train) == (spec.fwd_launches,
                                        spec.train_launches)
    if plan == "fused_cell":
        assert got_fwd == got_train == T * cfg.n_layers


JNAME = "rwkv6-3b-reduced"


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("n_layers", [2, 4])
def test_rwkv6_train_launches_equal_jax_dispatches(n_layers, remat):
    jcfg = dataclasses.replace(jax_configs.get_arch(JNAME), n_layers=n_layers)
    cfg = dataclasses.replace(configs.get_arch(JNAME), n_layers=n_layers)
    jparams, _ = split(jax_registry.build(jcfg).init(jax.random.PRNGKey(0)))
    tokens = np.zeros((2, 24), np.int32)
    old = jax_rwkv.WKV_PLAN
    jax_rwkv.WKV_PLAN = "chunked_scan"
    try:
        want = jax_analysis.count_train_dispatches(
            lambda p: jax_steps.loss_fn(p, jcfg, {"tokens": jnp.asarray(
                tokens)}, remat=remat)[0], jparams)
    finally:
        jax_rwkv.WKV_PLAN = old
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    got = analysis.count_train_launches(
        lambda p: steps.loss_fn(p, cfg, {"tokens": torch.from_numpy(tokens)},
                                remat=remat)[0], params)
    assert got == want == (3 if remat else 2) * n_layers


@pytest.mark.parametrize("T", [16, 61])
def test_mamba_fused_scan_launches_equal_jax_dispatches(T):
    fam, jfam = plans.get_family("mamba"), jax_plans.get_family("mamba")
    case = plans.Case(f"T{T}", (2, T, 8, 4, 16, 2))
    args, chunk, block_b = fam.make_inputs(case, "float32")
    jcase = jax_plans.Case(f"T{T}", (2, T, 8, 4, 16, 2))
    jargs = jfam.make_inputs(jcase, "float32")
    jfn = jax_plans.MAMBA_PLANS["fused_scan"]

    def jplan(*a):
        return jfn(*a, chunk=chunk, block_b=block_b)

    def jloss(*a):
        y, h = jplan(*a)
        return jnp.sum(jnp.tanh(y)) + 0.5 * jnp.sum(h * h)

    want = (jax_analysis.count_kernel_dispatches(
        jax.make_jaxpr(jplan)(*jargs[0])),
        jax_analysis.count_train_dispatches(jloss, *jargs[0]))

    def plan(*a):
        return plans.MAMBA_PLANS["fused_scan"](*a, chunk=chunk,
                                               block_b=block_b)

    def loss(x, *rest):
        y, h = plan(x, *rest)
        return torch.sum(torch.tanh(y)) + 0.5 * torch.sum(h * h)

    with torch.no_grad():
        got_fwd = analysis.count_launches(plan, *args)
    got = (got_fwd, analysis.count_train_launches(loss, args[0], *args[1:]))
    assert got == want == (1, 2)


def test_count_launches_reads_the_launch_counters_for_card_tensors(
        monkeypatch):
    """With a tensor on the card the counts come from the wrappers'
    ``launches``; here a stand-in reports itself on CUDA and bumps one."""
    class Card(torch.Tensor):
        is_cuda = True

    x = torch.zeros(1).as_subclass(Card)

    def fn(_):
        seq_lib.lstm_seq.launches += 1

    before = seq_lib.lstm_seq.launches
    assert analysis.count_launches(fn, x) == 1
    seq_lib.lstm_seq.launches = before


# ---------------------------------------------------------------------------
# kernel work at PERF.md's shapes: the bounds of its kernel table
# ---------------------------------------------------------------------------
LENS = torch.full((4,), 508, dtype=torch.int32)

#: (work, flop rate, (bytes, operations), bound ms as PERF.md prints it)
WORK = [
    ("K6 bf16", analysis.wkv6_fwd_work(160, 512, 64, 64, 32, BF16), None,
     (68198400, 1882193920), "2.81e-2"),
    ("K6 f32", analysis.wkv6_fwd_work(160, 512, 64, 64, 32, F32), None,
     (110141440, 1882193920), "3.29e-2"),
    ("K6t bf16", analysis.wkv6_fwd_work(160, 512, 64, 64, 32, BF16, True),
     None, (110141440, 1882193920), "3.29e-2"),
    ("K6t f32", analysis.wkv6_fwd_work(160, 512, 64, 64, 32, F32, True),
     None, (152084480, 1882193920), "4.54e-2"),
    ("K6b bf16", analysis.wkv6_bwd_work(160, 512, 64, 64, 32, BF16), None,
     (165232640, 4011294720), "5.99e-2"),
    ("K6b f32", analysis.wkv6_bwd_work(160, 512, 64, 64, 32, F32), None,
     (238632960, 4011294720), "7.12e-2"),
    ("K7 f32", analysis.mamba_fwd_work(4, 512, 16384, 16, 64, F32), None,
     (412352512, 3791650816), "1.231e-1"),
    ("K7 bf16", analysis.mamba_fwd_work(4, 512, 16384, 16, 64, BF16), None,
     (278134784, 3791650816), "8.30e-2"),
    ("K7 decode f32", analysis.mamba_fwd_work(4, 1, 16384, 16, 1, F32), None,
     (10224128, 7405568), "3.05e-3"),
    ("K7 decode bf16", analysis.mamba_fwd_work(4, 1, 16384, 16, 1, BF16),
     None, (9961984, 7405568), "2.97e-3"),
    ("K7t f32", analysis.mamba_fwd_work(4, 512, 16384, 16, 32, F32, True),
     None, (479461376, 3791650816), "1.431e-1"),
    ("K7t bf16", analysis.mamba_fwd_work(4, 512, 16384, 16, 32, BF16, True),
     None, (345243648, 3791650816), "1.031e-1"),
    ("K7b f32", analysis.mamba_bwd_work(4, 512, 16384, 16, 32, F32), None,
     (749207552, 11408506880), "2.236e-1"),
    ("K7b bf16", analysis.mamba_bwd_work(4, 512, 16384, 16, 32, BF16), None,
     (547880960, 11408506880), "1.703e-1"),
    ("K8 qwen2", analysis.prefill_work(4, 500, 14, 2, 64, BF16), "bf16",
     (8192000, 1795584000), "2.445e-3"),
    ("K8 yi", analysis.prefill_work(4, 500, 32, 4, 128, BF16), "bf16",
     (36864000, 8208384000), "1.100e-2"),
    ("K8 musicgen", analysis.prefill_work(4, 500, 32, 32, 64, BF16), "bf16",
     (32768000, 4104192000), "9.781e-3"),
    ("K9 qwen2", analysis.decode_work(4, 14, 2, 64, LENS, BF16), "bf16",
     (1054720, 7282688), "3.148e-4"),
    ("K9 yi", analysis.decode_work(4, 32, 4, 128, LENS, BF16), "bf16",
     (4227072, 33292288), "1.262e-3"),
    ("K9 musicgen", analysis.decode_work(4, 32, 32, 64, LENS, BF16), "bf16",
     (16678912, 16646144), "4.979e-3"),
    ("K8t qwen2", analysis.attn_traj_work(4, 512, 14, 2, 64, BF16), "bf16",
     (8503296, 1882718208), "2.538e-3"),
    ("K8t olmoe", analysis.attn_traj_work(4, 512, 16, 16, 128, BF16), "bf16",
     (33685504, 4303355904), "1.006e-2"),
    ("K8t musicgen", analysis.attn_traj_work(4, 512, 32, 32, 64, BF16),
     "bf16", (33816576, 4303355904), "1.009e-2"),
    ("K8b qwen2", analysis.attn_bwd_work(4, 512, 14, 2, 64, BF16), "bf16",
     (16891904, 4706795520), "5.042e-3"),
    ("K8b olmoe", analysis.attn_bwd_work(4, 512, 16, 16, 128, BF16), "bf16",
     (67239936, 10758389760), "2.007e-2"),
    ("K8b musicgen", analysis.attn_bwd_work(4, 512, 32, 32, 64, BF16),
     "bf16", (67371008, 10758389760), "2.011e-2"),
]


@pytest.mark.parametrize("what,work,rate,pinned,printed", WORK,
                         ids=[w[0] for w in WORK])
def test_kernel_work_at_the_kernel_tables_shapes(what, work, rate, pinned,
                                                 printed):
    assert work == pinned
    ms, _ = analysis.bound(*work, **(
        {} if rate is None else {"flop_rate": analysis.BF16_FLOP_PER_S}))
    digits = len(printed.split("e")[0].split(".")[1])
    assert f"{ms:.{digits}e}" == f"{float(printed):.{digits}e}", what


# ---------------------------------------------------------------------------
# the tiling helpers the rooflines price with
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("start,floor", [(1, 1), (48, 1), (64, 8), (160, 32),
                                         (5, 8)])
def test_halving_and_traffic_helpers_equal_jax(start, floor):
    from repro.core import tiling as jax_tiling
    from repro_torch.core import tiling

    assert list(tiling.halving(start, floor)) == \
        list(jax_tiling.halving(start, floor))
    assert list(tiling.halving(start)) == list(jax_tiling.halving(start))
    for n, t in ((start, floor), (start + 3, max(1, floor - 1)), (7, 32)):
        assert tiling.ceil_chunks(n, t) == jax_tiling.ceil_chunks(n, t)
        assert tiling.pad_tiles(n, t) == jax_tiling.pad_tiles(n, t)
        assert tiling.streamed_axis_rows(n, t) == \
            jax_tiling.streamed_axis_rows(n, t)
    assert tiling.streamed_axis_rows(start, None) == start
