"""The port's LSTM cell math, parameter init, weight transplant and fused-cell
kernel wrapper (plain version, on the CPU) against the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mobirnn_lstm import LSTMConfig as JaxConfig  # noqa: E402
from repro.core import cell as jax_cell  # noqa: E402
from repro.core import lstm as jax_lstm  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.mobirnn_lstm import LSTMConfig  # noqa: E402
from repro_torch.core import cell, factorization, lstm  # noqa: E402
from repro_torch.kernels import lstm_cell as cell_k  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

#: the JAX package's f32 LSTM tolerance (core/plans.LSTM_TOL)
TOL = dict(rtol=2e-5, atol=2e-5)


def _cell_inputs(seed, B, D, H):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        w=(rng.standard_normal((D + H, 4 * H)) * (D + H) ** -0.5).astype(f),
        b=(rng.standard_normal(4 * H) * 0.1).astype(f),
        x=rng.standard_normal((B, D)).astype(f),
        c=rng.standard_normal((B, H)).astype(f),
        h=rng.standard_normal((B, H)).astype(f))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


SHAPES = [(3, 9, 16), (5, 9, 20), (1, 32, 32), (64, 32, 32)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%dD%dH%d" % s)
@pytest.mark.parametrize("form", ["fused", "fine"])
def test_cell_math_matches_jax(form, shape):
    """Both factorizations against their JAX twins; the fine form in
    16-column work units, so JAX's op-by-op dispatch stays quick."""
    a = _cell_inputs(0, *shape)
    if form == "fused":
        port, ref_fn = cell.lstm_cell_fused, jax_cell.lstm_cell_fused
    else:
        port = lambda *args: cell.lstm_cell_fine(*args, unit_cols=16)
        ref_fn = lambda *args: jax_cell.lstm_cell_fine(*args, unit_cols=16)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    got = port({"w": t["w"], "b": t["b"]}, t["x"], t["c"], t["h"])
    want = ref_fn({"w": j["w"], "b": j["b"]}, j["x"], j["c"], j["h"])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%dD%dH%d" % s)
def test_ref_cell_matches_jax_ref(shape):
    a = _cell_inputs(1, *shape)
    got = ref.lstm_cell(*(torch.from_numpy(a[k]) for k in "wbxch"))
    want = jax_ref.lstm_cell(*(jnp.asarray(a[k]) for k in "wbxch"))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("blocks", [(None, None), (2, 8), (5, 32)],
                         ids=["auto", "ragged", "whole"])
def test_cell_kernel_wrapper_matches_pallas_interpret(blocks):
    """B=5, D=9, H=20 through the Pallas kernel in interpret mode against
    the port's wrapper, which takes its plain version for CPU tensors."""
    a = _cell_inputs(2, 5, 9, 20)
    block_b, block_h = blocks
    got = ops.lstm_cell(*(torch.from_numpy(a[k]) for k in "wbxch"),
                        block_b=block_b, block_h=block_h)
    want = jax_ops.lstm_cell(*(jnp.asarray(a[k]) for k in "wbxch"),
                             interpret=True, block_b=block_b,
                             block_h=block_h)
    for g, w in zip(got, want):
        _close(g, w)


def test_cpu_calls_are_not_counted_as_launches():
    a = _cell_inputs(3, 2, 9, 8)
    before = cell_k.lstm_cell.launches
    cell_k.lstm_cell(*(torch.from_numpy(a[k]) for k in "wbxch"))
    assert cell_k.lstm_cell.launches == before


def test_cell_wrapper_rejects_what_the_kernel_does_not_take():
    a = {k: torch.from_numpy(v) for k, v in _cell_inputs(4, 2, 9, 8).items()}
    with pytest.raises(TypeError):
        cell_k.lstm_cell(a["w"].double(), a["b"], a["x"], a["c"], a["h"])
    with pytest.raises(ValueError):
        cell_k.lstm_cell(a["w"][1:], a["b"], a["x"], a["c"], a["h"])
    meta = {k: v.to("meta") for k, v in a.items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        cell_k.lstm_cell(*(meta[k] for k in "wbxch"))


def test_init_cell_layout():
    D, H = 9, 16
    p = cell.init_cell(torch.Generator().manual_seed(0), D, H)
    assert p["w"].shape == (D + H, 4 * H) and p["b"].shape == (4 * H,)
    assert p["w"].dtype == torch.float32
    expect_b = torch.zeros(4 * H)
    expect_b[H:2 * H] = 1.0                  # forget gate, order i,f,g,o
    assert torch.equal(p["b"], expect_b)
    scale = (D + H) ** -0.5
    assert float(p["w"].abs().max()) <= 2.0 * scale + 1e-7
    assert 0.5 * scale < float(p["w"].std()) < 1.0 * scale


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX package's plain param tree at the paper's config, as numpy."""
    theirs, _ = split(jax_lstm.init_params(jax.random.PRNGKey(3),
                                           JaxConfig()))
    return jax.tree.map(np.asarray, theirs)


def test_init_params_tree_matches_jax(jax_tree):
    mine = lstm.init_params(torch.Generator().manual_seed(0), LSTMConfig())
    assert len(mine["layers"]) == len(jax_tree["layers"]) == 2
    for m, t in zip(mine["layers"], jax_tree["layers"]):
        assert tuple(m["w"].shape) == t["w"].shape
        assert np.array_equal(m["b"].numpy(), t["b"])
    assert tuple(mine["head"]["w"].shape) == jax_tree["head"]["w"].shape
    assert np.array_equal(mine["head"]["b"].numpy(), jax_tree["head"]["b"])


def test_params_from_numpy_copies_the_jax_tree(jax_tree):
    mine = convert.params_from_numpy(jax_tree)
    for m, t in zip(mine["layers"], jax_tree["layers"]):
        assert m["w"].dtype == torch.float32
        assert np.array_equal(m["w"].numpy(), t["w"])
        assert np.array_equal(m["b"].numpy(), t["b"])
    assert np.array_equal(mine["head"]["w"].numpy(), jax_tree["head"]["w"])


@pytest.mark.parametrize("args", [(1, 32, 64), (64, 32, 64), (5, 20, 29),
                                  (3, 256, 512), (64, 32, 100_000)])
def test_choose_block_fits_a_thread_block(args):
    m, n, k = args
    bm, bn, bk = factorization.choose_block(m, n, k)
    assert bn % factorization.WARP == 0
    assert bn >= min(n, factorization.CTA_THREADS)
    assert 1 <= bm <= m and bm * bn <= factorization.CTA_THREADS
    assert bk == k
    assert bm == 1 or bm * k * 4 <= factorization.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("args", [(9, 32, 1), (32, 32, 64), (9, 20, 5)])
def test_cell_flops_matches_jax(args):
    assert cell.cell_flops(*args) == jax_cell.cell_flops(*args)
