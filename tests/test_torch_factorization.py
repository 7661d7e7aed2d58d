"""The paper's work-unit cost model (``core/factorization.py``, MobiRNN
§3.1-3.2, Figs 2-6) and ``core/lstm.init_state`` against the JAX
package's: the same Python floats for every profile and shape, the
paper's claims, the Fig 3 to Fig 6 model rows, and the H100 profile built
from the port's own rates."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs import MOBIRNN_LSTM as JAX_LSTM  # noqa: E402
from repro.core import factorization as jfz  # noqa: E402
from repro.core import lstm as jax_lstm  # noqa: E402

from repro_torch import analysis  # noqa: E402
from repro_torch.configs.mobirnn_lstm import CONFIG as LSTM  # noqa: E402
from repro_torch.core import factorization as fz  # noqa: E402
from repro_torch.core import lstm  # noqa: E402

PROFILES = ("DESKTOP_GPU", "MOBILE_GPU", "MOBILE_CPU4", "MOBILE_CPU1")
SWEEP = [(prof, in_dim, hidden, bpe) for prof in PROFILES
         for in_dim in (41, 64, 137, 512) for hidden in (32, 64, 128, 256)
         for bpe in (1, 2, 4)]


@pytest.mark.parametrize("prof,in_dim,hidden,bpe", SWEEP)
def test_cost_model_equals_jax(prof, in_dim, hidden, bpe):
    """unit_time, factorize_gate and best_cols_per_unit give JAX's floats
    exactly, for every power-of-two column block up to out_dim = 4H."""
    mine, theirs = getattr(fz, prof), getattr(jfz, prof)
    out = 4 * hidden
    c = 1
    while c <= out:
        n_units = -(-out // c)
        flops = 2.0 * in_dim * c
        byts = bpe * (in_dim * c + in_dim + c)
        assert fz.unit_time(mine, n_units, flops, byts) \
            == jfz.unit_time(theirs, n_units, flops, byts)
        assert fz.factorize_gate(mine, in_dim, out, c, bpe) \
            == jfz.factorize_gate(theirs, in_dim, out, c, bpe)
        c *= 2
    assert fz.best_cols_per_unit(mine, in_dim, out, bpe) \
        == jfz.best_cols_per_unit(theirs, in_dim, out, bpe)


def test_paper_profiles_equal_jax_value_for_value():
    for name in PROFILES:
        assert dataclasses.astuple(getattr(fz, name)) \
            == dataclasses.astuple(getattr(jfz, name))


# --- the claims of tests/test_factorization.py, on the port -----------------
def test_fine_grained_slower_on_mobile_gpu():
    """Per-column factorization (Fig 2b) on the constrained GPU is slower
    than single-threaded CPU (Fig 3); the packed one (Fig 2c) wins."""
    in_dim, out = 32, 120
    t_fine_gpu = fz.factorize_gate(fz.MOBILE_GPU, in_dim, out, 1)
    t_cpu = fz.factorize_gate(fz.MOBILE_CPU1, in_dim, out, out)
    best = fz.best_cols_per_unit(fz.MOBILE_GPU, in_dim, out)
    t_packed_gpu = fz.factorize_gate(fz.MOBILE_GPU, in_dim, out, best)
    assert t_fine_gpu > t_cpu, "fine-grained offload must lose (Fig 3)"
    assert t_packed_gpu < t_fine_gpu, "packing must win (Fig 2c)"


def test_desktop_gpu_tolerates_fine_grain():
    in_dim, out = 32, 120
    t_fine_desktop = fz.factorize_gate(fz.DESKTOP_GPU, in_dim, out, 1)
    t_cpu = fz.factorize_gate(fz.MOBILE_CPU1, in_dim, out, out)
    assert t_fine_desktop < t_cpu


@pytest.mark.parametrize("prof", PROFILES + ("H100",))
def test_unit_time_monotone_in_units(prof):
    dev = getattr(fz, prof)
    f = 2.0 * 32
    times = [fz.unit_time(dev, n, f, 4.0 * 33) for n in range(1, 600)]
    assert all(b >= a for a, b in zip(times, times[1:]))
    assert fz.unit_time(dev, 120, f) >= fz.unit_time(dev, 1, f)


# --- the benchmark's model rows (benchmarks/run.py, Figs 3 to 6) -----------
def _model_rows(mod, cfg):
    """The Fig 3 to Fig 6 model rows as the JAX benchmark computes them,
    under the cost model ``mod`` and the LSTM config ``cfg``: (name,
    seconds, ratio)."""
    in_dim = cfg.input_dim + cfg.hidden
    out = 4 * cfg.hidden
    gpu_fine = mod.factorize_gate(mod.MOBILE_GPU, in_dim, out, 1)
    cpu = mod.factorize_gate(mod.MOBILE_CPU1, in_dim, out, out)
    best = mod.best_cols_per_unit(mod.MOBILE_GPU, in_dim, out)
    gpu = mod.factorize_gate(mod.MOBILE_GPU, in_dim, out, best)
    best4 = mod.best_cols_per_unit(mod.MOBILE_CPU4, in_dim, out)
    mt = mod.factorize_gate(mod.MOBILE_CPU4, in_dim, out, best4)
    rows = [("fig3/model_mobile_gpu_fine_vs_cpu", gpu_fine, gpu_fine / cpu),
            ("fig4/model_mobirnn_speedup", gpu, cpu / gpu),
            ("fig6/model_multithread_cpu", mt, gpu / mt)]
    for hidden in (32, 64, 128, 256):
        for layers in (1, 2, 3):
            c = cfg.with_complexity(hidden, layers)
            d_in, o = c.input_dim + hidden, 4 * hidden
            b = mod.best_cols_per_unit(mod.MOBILE_GPU, d_in, o)
            t_gpu = layers * mod.factorize_gate(mod.MOBILE_GPU, d_in, o, b)
            t_cpu = layers * mod.factorize_gate(mod.MOBILE_CPU1, d_in, o, o)
            rows.append((f"fig5/model_h{hidden}_l{layers}", t_gpu,
                         t_cpu / t_gpu))
    return rows


def test_figure_model_rows_equal_jax():
    mine, theirs = _model_rows(fz, LSTM), _model_rows(jfz, JAX_LSTM)
    assert mine == theirs
    ratio = dict((n, r) for n, _, r in mine)
    # the paper's shape: fine-grained GPU ~4x slower than one CPU thread
    # (Fig 3), packing ~3.9x faster (Fig 4), 4 threads >= 70% (Fig 6)
    assert ratio["fig3/model_mobile_gpu_fine_vs_cpu"] > 1.0
    assert ratio["fig4/model_mobirnn_speedup"] > 1.0
    assert ratio["fig6/model_multithread_cpu"] >= 0.7


# --- the H100 profile ------------------------------------------------------
def test_h100_profile_is_built_from_the_ports_rates():
    h = fz.H100
    assert "modelled" in h.name
    assert h.cores == fz.H100_SMS == 132
    assert h.flops_per_core == analysis.F32_FLOP_PER_S / fz.H100_SMS
    assert h.fast_mem_bytes == fz.H100_SMEM_PER_BLOCK
    assert h.mem_bw == analysis.HBM_BYTES_PER_S
    assert h.enqueue_overhead_s == fz.H100_ENQUEUE_OVERHEAD_S
    assert 1e-6 < h.enqueue_overhead_s < 1e-3
    # packing wins on the card too: the whole gate fits one block
    in_dim, out = LSTM.input_dim + LSTM.hidden, 4 * LSTM.hidden
    assert fz.best_cols_per_unit(fz.H100, in_dim, out) == out
    assert fz.factorize_gate(fz.H100, in_dim, out, out) \
        < fz.factorize_gate(fz.H100, in_dim, out, 10) \
        < fz.factorize_gate(fz.H100, in_dim, out, 1)


def test_the_tpu_block_chooser_is_not_ported():
    for name in ("TPU_V5E", "MXU_ALIGN", "DEFAULT_VMEM_BUDGET",
                 "choose_block", "grid_steps"):
        assert hasattr(jfz, name) and not hasattr(fz, name)


# --- init_state ------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 5])
def test_init_state_equals_jax(dtype, batch):
    cfg = LSTM.with_complexity(48, 3)
    jcfg = JAX_LSTM.with_complexity(48, 3)
    mine = lstm.init_state(cfg, batch, getattr(torch, dtype))
    theirs = jax_lstm.init_state(jcfg, batch, jnp.dtype(dtype))
    for m, t in zip(mine, theirs):
        assert tuple(m.shape) == t.shape == (3, batch, 48)
        assert str(m.dtype) == f"torch.{t.dtype}"
        assert not m.any()
        np.testing.assert_array_equal(m.float().numpy(),
                                      np.asarray(t, np.float32))
    assert mine[0].data_ptr() != mine[1].data_ptr()


def test_init_state_is_on_the_asked_device():
    c, h = lstm.init_state(LSTM, 2, device="meta")
    assert c.is_meta and h.is_meta and c.shape == (2, 2, 32)
