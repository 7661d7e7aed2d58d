"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's dense dispatch (``repro.models.moe._apply_moe_dense``) on the
CPU, at ``olmoe-1b-7b-reduced`` (d_model 256, 4 experts of 128, top-2),
SwiGLU and GELU experts, in f32 unless a case says otherwise.

Parameters come from the JAX ``init_moe`` through ``split`` and
``convert``; inputs are drawn with numpy and handed to both.  Beside the
parity cases: the JAX package's tests/test_moe.py properties on the port
(drops, capacity, load-balance bounds, the per-token dense formula), a
NaN row leaving every other row bit for bit, and the block under the slot
engine tests' dispatch mode that fails on any host read or data-dependent
shape (what a CUDA-graph capture cannot hold)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import jamba_1_5_large_398b as jamba  # noqa: E402
from repro_torch.models import moe  # noqa: E402

from test_torch_serving_slots import _NoHostSync  # noqa: E402

#: the same f32 dispatch in two frameworks: outputs, and the aux means
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
#: the bf16 tier of the port's bf16 comparisons (K8/K9 and the served
#: tokens, chip_smoke.MARGIN_TOL): each expert product rounds its output
#: to bf16 on both sides, from f32 sums taken in another order
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
#: no_drop, then capacity factors 1.25 and 0.5 (which drops slots)
DISPATCH = {"no_drop": (1.25, True), "cf1.25": (1.25, False),
            "cf0.5": (0.5, False)}
SHAPES = {"T,d": (40,), "B,S,d": (2, 20)}


def _cfgs(act="swiglu", cf=1.25, n_experts=4, top_k=2, dtype="float32"):
    """(the port's config, JAX's): reduced OLMoE with these MoE fields."""
    out = []
    for get in (get_arch, jax_get_arch):
        cfg = get("olmoe-1b-7b").reduced()
        out.append(dataclasses.replace(
            cfg, mlp_act=act, dtype=dtype, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf, n_experts=n_experts,
                top_k=top_k)))
    return tuple(out)


def _params(jcfg, dtype=jnp.float32, seed=0):
    """(JAX's plain params as numpy, the port's), drawn by JAX."""
    plain, _ = split(jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, dtype))
    tree = jax.tree.map(np.asarray, plain)
    return tree, convert.params_from_numpy(tree)


def _x(shape, d, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (*shape, d))).astype(np.float32)


def _jax_routing(p, x, cfg):
    """The JAX package's routing lines (moe.py:90-93) on its params."""
    xt = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
    return top_p / jnp.sum(top_p, axis=-1, keepdims=True), top_e


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["olmoe-1b-7b", "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_configs_are_the_jax_configs(name):
    for suffix in ("", "-reduced"):
        assert dataclasses.asdict(get_arch(name + suffix)) == \
            dataclasses.asdict(jax_get_arch(name + suffix))


def test_one_period_cut_is_the_jax_replacement():
    """The stated Jamba cut: one period of 8 layers at 8 experts, every
    other field the published config's, built the same way in JAX."""
    jcut = jax_get_arch("jamba-1.5-large-398b")
    jcut = dataclasses.replace(jcut, n_layers=8, moe=dataclasses.replace(
        jcut.moe, n_experts=8))
    cut = jamba.ONE_PERIOD_8_EXPERTS
    assert dataclasses.asdict(cut) == dataclasses.asdict(jcut)
    assert (cut.period, cut.moe.top_k, cut.moe.d_ff) == (8, 2, 24576)
    assert [cut.layer_kind(i) for i in range(8)] == ["ssm"] * 4 + [
        "attn"] + ["ssm"] * 3
    assert [cut.layer_is_moe(i) for i in range(8)] == [False, True] * 4


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_init_moe_has_the_jax_tree(act):
    cfg, jcfg = _cfgs(act)
    tree, _ = _params(jcfg)
    mine = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert sorted(mine) == sorted(tree)
    for k, a in tree.items():
        assert tuple(mine[k].shape) == a.shape and mine[k].dtype == \
            torch.float32
    d, ff = cfg.d_model, cfg.moe.d_ff
    # truncated normal at the JAX scales: |w| <= 2 x scale
    assert float(mine["router"].abs().max()) <= 2 * d ** -0.5
    assert float(mine["wd"].abs().max()) <= 2 * ff ** -0.5


@pytest.mark.parametrize("n,cf", [(64, 1.0), (1, 1.0), (40, 1.25),
                                  (40, 0.5), (7, 0.25)])
def test_capacity_matches_jax(n, cf):
    cfg, jcfg = _cfgs(cf=cf)
    assert moe.capacity(n, cfg) == jax_moe.capacity(n, jcfg)


# ---------------------------------------------------------------------------
# apply_moe against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_moe_matches_jax(act, dispatch, shape):
    """The same experts for every token (``top_e`` equal), the output at
    1e-5 and the three aux values at 1e-6."""
    cf, no_drop = DISPATCH[dispatch]
    cfg, jcfg = _cfgs(act, cf)
    tree, p = _params(jcfg)
    x = _x(SHAPES[shape], cfg.d_model)
    jp = jax.tree.map(jnp.asarray, tree)
    want, jaux = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg, no_drop=no_drop)
    got, aux = moe.apply_moe(p, torch.from_numpy(x), cfg, no_drop=no_drop)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want, OUT_TOL)
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        _close(aux[k], jaux[k], AUX_TOL)
    jtop_p, jtop_e = _jax_routing(jp, jnp.asarray(x), jcfg)
    _, _, top_p, top_e = moe.route(p["router"], torch.from_numpy(
        x.reshape(-1, cfg.d_model)), cfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    _close(top_p, jtop_p, AUX_TOL)
    if no_drop:
        assert float(aux["moe_drop_frac"]) == 0.0
    elif cf < 1:
        assert float(aux["moe_drop_frac"]) > 0.0


def test_ties_go_to_the_lower_expert_as_in_jax():
    """A zero router ties every expert: the port, as ``lax.top_k``, takes
    the lowest indices, in order."""
    cfg, jcfg = _cfgs(n_experts=8, top_k=3)
    tree, p = _params(jcfg)
    p["router"] = torch.zeros_like(p["router"])
    x = _x((6,), cfg.d_model)
    _, jtop_e = _jax_routing({"router": jnp.zeros(tree["router"].shape)},
                             jnp.asarray(x), jcfg)
    _, _, _, top_e = moe.route(p["router"], torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    assert top_e.tolist() == [[0, 1, 2]] * 6


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_gradients_match_jax_at_capacity(act):
    """Gradients of a weighted sum of ``out`` (and of the aux losses as
    ``loss_fn`` weighs them) with respect to x and every leaf, at
    capacity factor 0.5 where slots drop, against ``jax.grad``."""
    cfg, jcfg = _cfgs(act, 0.5)
    tree, p = _params(jcfg)
    x = _x((2, 20), cfg.d_model)
    wts = _x((2, 20), cfg.d_model, seed=2)

    def jloss(pp, xx):
        out, aux = jax_moe.apply_moe(pp, xx, jcfg)
        return jnp.sum(out * wts) + aux["moe_load_balance"] \
            + 0.1 * aux["moe_z_loss"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.apply_moe(leaves, xt, cfg)
    loss = (out * torch.from_numpy(wts)).sum() + aux["moe_load_balance"] \
        + 0.1 * aux["moe_z_loss"]
    loss.backward()
    _close(xt.grad, jgx, GRAD_TOL)
    for k, leaf in leaves.items():
        _close(leaf.grad, jgp[k], GRAD_TOL)
        assert float(leaf.grad.abs().sum()) > 0


def test_bf16_matches_jax_bf16():
    """In bf16 (router product in bf16, widened after) the port routes
    every token as JAX's bf16 does, and its output is within the bf16
    tier of JAX's."""
    cfg, jcfg = _cfgs(dtype="bfloat16", n_experts=8, top_k=2)
    tree, p = _params(jcfg, jnp.bfloat16)
    x = _x((2, 24), cfg.d_model)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jp = jax.tree.map(jnp.asarray, tree)
    xb = convert.params_from_numpy(np.asarray(jx))
    want, _ = jax_moe.apply_moe(jp, jx, jcfg, no_drop=True)
    got, _ = moe.apply_moe(p, xb, cfg, no_drop=True)
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), BF16_TOL)
    _, jtop_e = _jax_routing(jp, jx, jcfg)
    _, _, _, top_e = moe.route(p["router"], xb.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))


# ---------------------------------------------------------------------------
# the JAX package's tests/test_moe.py properties, on the port
# ---------------------------------------------------------------------------
def test_no_drop_matches_manual_dense_computation():
    """With no_drop the dispatch equals sum_k w_k expert_{e_k}(x), token
    by token."""
    cfg, jcfg = _cfgs()
    _, p = _params(jcfg)
    x = torch.from_numpy(_x((10,), cfg.d_model))
    out, _ = moe.apply_moe(p, x, cfg, no_drop=True)
    _, _, top_p, top_e = moe.route(p["router"], x, cfg)
    want = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(cfg.moe.top_k):
            e = int(top_e[t, j])
            h = torch.nn.functional.silu(x[t] @ p["wg"][e]) * (
                x[t] @ p["wu"][e])
            want[t] += top_p[t, j] * (h @ p["wd"][e])
    _close(out, want.numpy(), dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("cf,n,dropped", [(8.0, 32, False),
                                          (0.25, 64, True)])
def test_drop_fraction_follows_capacity(cf, n, dropped):
    """cf >= E/k guarantees no drop; a tight capacity drops."""
    cfg, jcfg = _cfgs(cf=cf)
    _, p = _params(jcfg)
    _, aux = moe.apply_moe(p, torch.from_numpy(_x((n,), cfg.d_model, 2)),
                           cfg)
    assert (float(aux["moe_drop_frac"]) > 0.0) == dropped


def test_capacity_is_work_unit_coarseness():
    cfg, _ = _cfgs(cf=1.0)
    assert moe.capacity(64, cfg) == 64 * 2 // 4
    assert moe.capacity(1, cfg) == cfg.moe.top_k


def test_load_balance_loss_bounds():
    """A uniform router gives a load balance of ~1 (switch
    normalisation); one collapsed onto expert 0 gives at least as much."""
    cfg, jcfg = _cfgs()
    E = cfg.moe.n_experts
    _, p = _params(jcfg)
    x = torch.from_numpy(_x((128,), cfg.d_model, 4))
    _, aux = moe.apply_moe(dict(p, router=torch.zeros_like(p["router"])), x,
                           cfg)
    assert 0.9 < float(aux["moe_load_balance"]) <= E + 1e-3
    _, aux3 = moe.apply_moe(dict(p, router=torch.eye(cfg.d_model, E) * 50),
                            x, cfg)
    assert float(aux3["moe_load_balance"]) >= float(aux["moe_load_balance"])


def test_gradients_flow_to_all_expert_weights_no_drop():
    cfg, jcfg = _cfgs()
    _, p = _params(jcfg)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    out, _ = moe.apply_moe(leaves, torch.from_numpy(_x((64,), cfg.d_model,
                                                       5)), cfg,
                           no_drop=True)
    (out ** 2).sum().backward()
    assert float(leaves["router"].grad.abs().sum()) > 0
    assert bool((leaves["wd"].grad.abs().sum((1, 2)) > 0).all())


# ---------------------------------------------------------------------------
# faults and the captured tick
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_row_leaves_other_rows_bit_equal(dtype):
    """One token's NaN (a poisoned lane) reaches its own output row only:
    every other row equals the clean run's bit for bit, though the NaN
    token's routing moves where the others sit in the expert buffers."""
    cfg, jcfg = _cfgs(dtype=dtype, n_experts=8, top_k=2)
    _, p = _params(jcfg)
    p = {k: v.to(getattr(torch, dtype)) for k, v in p.items()}
    x = torch.from_numpy(_x((4, 6), cfg.d_model)).to(getattr(torch, dtype))
    clean, _ = moe.apply_moe(p, x, cfg, no_drop=True)
    bad = x.clone()
    bad[1, 2, 5] = float("nan")
    out, _ = moe.apply_moe(p, bad, cfg, no_drop=True)
    assert bool(torch.isnan(out[1, 2]).all())
    others = torch.ones(4, 6, dtype=torch.bool)
    others[1, 2] = False
    assert torch.equal(out[others], clean[others])


@pytest.mark.parametrize("no_drop", [True, False])
def test_apply_moe_reads_nothing_on_the_host(no_drop):
    """The block under the dispatch mode that fails on a host read, a
    data-dependent shape or boolean indexing: what a CUDA graph cannot
    hold."""
    cfg, jcfg = _cfgs()
    _, p = _params(jcfg)
    x = torch.from_numpy(_x((4, 1), cfg.d_model))
    with _NoHostSync() as mode:
        out, aux = moe.apply_moe(p, x, cfg, no_drop=no_drop)
    assert {"index_put", "bmm", "sort", "cumsum"} <= mode.ops
    assert out.shape == x.shape and all(v.dim() == 0 for v in aux.values())
