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
    # on meta (an abstract trace) no plain version runs: the outputs'
    # shapes and dtypes come back
    meta = {k: v.to("meta") for k, v in a.items()}
    plain, cell_k.lstm_cell_plain = cell_k.lstm_cell_plain, None
    try:
        out = cell_k.lstm_cell(*(meta[k] for k in "wbxch"))
    finally:
        cell_k.lstm_cell_plain = plain
    assert [(t.device.type, t.shape) for t in out] == \
        [("meta", meta["c"].shape), ("meta", meta["h"].shape)]


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


#: every (B, D, H) that chip_smoke.py and the plans launch K1 at: both
#: layers of the 2 x 32 cell at B = 1, 5 and 64, 2 x 48, 2 x 64 and 3 x 256,
#: and a K far past one pass of the slices
CELL_LAUNCHES = [(1, 9, 32), (1, 32, 32), (5, 9, 32), (5, 32, 32),
                 (64, 9, 32), (64, 32, 32), (5, 9, 20), (1, 9, 48),
                 (64, 48, 48), (1, 9, 64), (1, 64, 64), (64, 64, 64),
                 (1, 9, 256), (1, 256, 256), (64, 256, 256),
                 (64, 99_968, 32)]


@pytest.mark.parametrize("args", CELL_LAUNCHES,
                         ids=lambda s: "B%dD%dH%d" % s)
def test_choose_block_fits_a_thread_block(args):
    """K1's table at every shape it is launched at: the threads within a
    block's 1,024 (and the kernel's 256), the shared memory priced exactly
    and within a block, each thread at most one output, the tile one the
    kernel is built for, and a K of any depth split into slices."""
    B, D, H = args
    bl = cell_k.choose_blocks(B, D, H)
    assert bl is not None
    assert bl.block_b in cell_k.BLOCK_BS and bl.block_h in cell_k.BLOCK_HS
    assert bl.threads == bl.k_slices * bl.block_h
    assert bl.threads <= cell_k.MAX_THREADS <= 1024
    assert bl.k_slices >= bl.block_b              # one output a thread
    assert bl.smem == 4 * bl.k_slices * bl.block_b * 4 * bl.block_h
    assert bl.smem == cell_k.working_set_bytes(bl.block_b, bl.block_h,
                                               bl.k_slices)
    assert bl.smem <= factorization.H100_SMEM_PER_BLOCK
    assert bl.grid == -(-B // bl.block_b) * -(-H // bl.block_h)
    # one pass of the slices covers K unless the threads run out
    assert bl.k_slices * cell_k.UNROLL >= D + H \
        or bl.threads > cell_k.MAX_THREADS - bl.block_h


@pytest.mark.parametrize("B,D,H,grid", [(1, 9, 32, 8), (1, 32, 32, 8),
                                        (1, 64, 64, 16), (64, 32, 32, 256),
                                        (1, 256, 256, 64)])
def test_table_spreads_a_cell_over_the_sms(B, D, H, grid):
    """A cell at B=1 runs on several SMs: the tile halves (columns first)
    until the grid has a block for each of the H100's 132 SMs or the tile
    is 1 row x 4 columns."""
    bl = cell_k.choose_blocks(B, D, H)
    assert bl.grid == grid
    assert bl.grid >= factorization.H100_SMS or (bl.block_b, bl.block_h) \
        == (1, 4)


def test_table_pins_and_refusals():
    """``block_b``/``block_h`` name the table's tile: a pin the kernel is
    built for is kept, any other gives no launch."""
    bl = cell_k.choose_blocks(64, 32, 32, block_b=8, block_h=32)
    assert (bl.block_b, bl.block_h, bl.threads, bl.grid) == (8, 32, 256, 8)
    assert cell_k.choose_blocks(5, 9, 20, block_h=8).block_h == 8
    assert cell_k.choose_blocks(5, 9, 20, block_b=5) is None
    assert cell_k.choose_blocks(5, 9, 20, block_h=20) is None
    assert cell_k.choose_blocks(0, 9, 20) is None


@pytest.mark.parametrize("args", [(9, 32, 1), (32, 32, 64), (9, 20, 5)])
def test_cell_flops_matches_jax(args):
    assert cell.cell_flops(*args) == jax_cell.cell_flops(*args)
