"""The port's multi-device paths against the JAX package's contracts
(tests/test_distributed.py) on 8 CPU ranks of a gloo process group: the
expert-parallel MoE (``moe._apply_moe_ep``) against JAX's dense MoE, the
sequence-parallel time-mix (``rwkv._apply_tmix_seqpar``) against JAX's
``_apply_tmix_local``, and the whole reduced ``rwkv6-3b`` forward on
DTensors under a (2, 4) mesh against JAX's single device, at JAX's
tolerances; beside them the seqpar gradients against ``jax.grad`` of
JAX's ``_apply_tmix_local`` and against the port's own single-device
``apply_tmix``, ``steps.loss_fn`` on DTensors and its gradients against
``jax.value_and_grad`` of JAX's ``loss_fn``, the (1, 8) and (4, 2) meshes
(3 and 1 prefix rounds), S = 30 (the batch path), and the collectives
each rank sends.

JAX computes the references here, in the parent process, from its seeds;
they reach the ranks as a ``torch.save`` file in a temporary directory.
One 8-rank job (``torch_ranks.run``, in a subprocess with its own
timeout) runs every check; each parametrised case below reads one."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from repro import steps as jax_steps  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402

WORLD = 8

CODE = r'''
import torch
from repro_torch import analysis, steps
from repro_torch import partitioning as pt
from repro_torch.configs import get_arch
from repro_torch.core import plans
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe, registry, rwkv
from repro_torch.optim.adamw import tree_leaves, tree_map

REF = torch.load(f"{TMP}/refs.pt", weights_only=True)
MESHES = {shape: mesh_lib.group_mesh(("data", "model"), shape, "cpu")
          for shape in ((2, 4), (1, 8), (4, 2))}
RWKV = get_arch("rwkv6-3b-reduced")
OLMOE = get_arch("olmoe-1b-7b-reduced")


def close(name, got, want, tol):
    err = (got - want).abs().max().item()
    bound = tol * (1 + want.abs()).max().item()
    assert torch.allclose(got, want, rtol=tol, atol=tol), (name, err, bound)
    return err


def placed(mesh, tree, axes):
    """``tree`` as DTensor leaves on ``mesh`` by logical ``axes`` (a tree
    of axes tuples, or one tuple for a tensor), differentiable leaves."""
    rules = pt.make_rules(mesh)
    out = pt.device_put(tree, pt.tree_shardings(axes, tree, rules))
    return tree_map(lambda t: t.detach().requires_grad_(), out)


TMIX_AXES = ((("batch", "seq_model", None), ("batch", None),
              ("batch", None, None, None)))


def tmix(mesh, p, x, xp, s0):
    """The time-mix on ``mesh``: (out, shift, state, loss, leaves)."""
    rules = pt.make_rules(mesh)
    xs = placed(mesh, [x, xp, s0], list(TMIX_AXES))
    dp = placed(mesh, p, tree_map(lambda t: (None,) * t.dim(), p))
    with pt.use_rules(rules):
        out, sh, st = rwkv.apply_tmix(dp, RWKV, *xs)
    loss = ((out ** 2).sum() + (sh ** 2).sum() + (st ** 2).sum())
    return out, sh, st, loss.full_tensor(), xs + tree_leaves(dp)


def tmix_grads_one(p, x, xp, s0):
    leaves = [t.clone().requires_grad_() for t in [x, xp, s0]
              + tree_leaves(p)]
    it = iter(leaves[3:])
    q = tree_map(lambda _: next(it), p)
    out, sh, st = rwkv.apply_tmix(q, RWKV, *leaves[:3])
    loss = (out ** 2).sum() + (sh ** 2).sum() + (st ** 2).sum()
    return torch.autograd.grad(loss, leaves)


def seqpar_forward(shape, S=32):
    def run():
        r = REF["tmix"] if S == 32 else REF["tmix30"]
        x, xp, s0 = r["x"], r["xp"], r["s0"]
        out, sh, st, _, _ = tmix(MESHES[shape], r["p"], x, xp, s0)
        return [close("out", out.full_tensor(), r["out"], 4e-4),
                close("state", st.full_tensor(), r["state"], 4e-4),
                close("shift", sh.full_tensor(), r["shift"], 1e-5)]
    return run


def seqpar_grads(shape):
    """Every leaf's gradient against JAX's (``jax.grad`` of its
    ``_apply_tmix_local``) and against the port's own one device."""
    def run():
        r = REF["tmix"]
        args = (r["p_pert"], r["x"], r["xp"], r["s0"])
        *_, loss, leaves = tmix(MESHES[shape], *args)
        got = [g.full_tensor() for g in torch.autograd.grad(loss, leaves)]
        jg = r["grads"]
        want = [jg["x"], jg["xp"], jg["s0"]] + tree_leaves(jg["p"])
        one = tmix_grads_one(*args)
        assert len(got) == len(want) == len(one)
        return [max(close(f"grad {i} vs JAX", g, w, 3e-4)
                    for i, (g, w) in enumerate(zip(got, want))),
                max(close(f"grad {i} vs one device", g, w, 3e-4)
                    for i, (g, w) in enumerate(zip(got, one)))]
    return run


def seqpar_counts():
    r = REF["tmix"]
    mesh = MESHES[(2, 4)]
    xs = placed(mesh, [r["x"], r["xp"], r["s0"]], list(TMIX_AXES))
    dp = placed(mesh, r["p"], tree_map(lambda t: (None,) * t.dim(), r["p"]))
    with pt.use_rules(pt.make_rules(mesh)):
        got = analysis.count_collectives(rwkv.apply_tmix, dp, RWKV, *xs)
    j = mesh.device_mesh.get_local_rank("model")
    B_loc, d = 2, RWKV.d_model
    H, dh = rwkv.n_heads(RWKV), RWKV.ssm.head_dim
    shift, D, A = B_loc * d * 4, B_loc * H * dh * 4, B_loc * H * dh * dh * 4
    sends = (j < 3) + (j < 2) + (j < 3)     # round 1, round 2, exclusive
    want = {"collective-permute": (7, shift + sends * (D + A)),
            "all-reduce": (2, A + shift)}
    assert got == want, (got, want)
    return got


def s30_takes_the_batch_path():
    r = REF["tmix30"]
    mesh = MESHES[(2, 4)]
    xs = placed(mesh, [r["x"], r["xp"], r["s0"]], list(TMIX_AXES))
    dp = placed(mesh, r["p"], tree_map(lambda t: (None,) * t.dim(), r["p"]))
    with pt.use_rules(pt.make_rules(mesh)):
        got = analysis.count_collectives(rwkv.apply_tmix, dp, RWKV, *xs)
    assert "collective-permute" not in got, got
    return got


def ep(mesh, p, x, dtype=torch.float32):
    rules = pt.make_rules(mesh)
    p = tree_map(lambda t: t.to(dtype), p)
    dx = placed(mesh, x.to(dtype), ("batch", "seq", None))
    dp = placed(mesh, p, {k: ("experts", None, None) if k != "router"
                          else (None, None) for k in p})
    return dx, dp, rules


def ep_forward():
    r = REF["moe"]
    dx, dp, rules = ep(MESHES[(2, 4)], r["p"], r["x"])
    with pt.use_rules(rules):
        out, aux = moe.apply_moe(dp, dx, OLMOE, no_drop=True)
    assert aux["moe_drop_frac"].full_tensor().item() == 0.0
    # the load balance is taken per data shard and averaged over 'data'
    return [close("out", out.full_tensor(), r["out"], 2e-4),
            close("load balance", aux["moe_load_balance"].full_tensor(),
                  r["load_balance_by_shard"], 2e-4),
            close("z loss", aux["moe_z_loss"].full_tensor(), r["z_loss"],
                  2e-4)]


def ep_grads():
    r = REF["moe"]
    dx, dp, rules = ep(MESHES[(2, 4)], r["p"], r["x"])
    with pt.use_rules(rules):
        out, _ = moe.apply_moe(dp, dx, OLMOE, no_drop=True)
    loss = (out ** 2).sum().full_tensor()
    keys = sorted(dp)
    got = torch.autograd.grad(loss, [dp[k] for k in keys] + [dx])
    return [close(k, g.full_tensor(), r["grads"][k], 3e-4)
            for k, g in zip(keys + ["x"], got)]


def ep_counts(dtype):
    def run():
        r = REF["moe"]
        dx, dp, rules = ep(MESHES[(2, 4)], r["p"], r["x"], dtype)
        with pt.use_rules(rules):
            got = analysis.count_collectives(moe.apply_moe, dp, dx, OLMOE,
                                             no_drop=True)
        T_loc = 2 * 8
        item = torch.finfo(dtype).bits // 8
        # the combine in the model dtype, the dropped count (f32) over
        # 'model', the three aux losses (f32) averaged over 'data'
        want = {"all-reduce": (3, T_loc * OLMOE.d_model * item + 4 + 12)}
        assert got == want, (got, want)
        if dtype == torch.bfloat16:
            with pt.use_rules(rules):
                out, _ = moe.apply_moe(dp, dx, OLMOE, no_drop=True)
            dense, _ = moe.apply_moe(tree_map(lambda t: t.to(dtype), r["p"]),
                                     r["x"].to(dtype), OLMOE, no_drop=True)
            err = (out.full_tensor().float() - dense.float()).abs().max()
            assert err <= 3e-2 * dense.float().abs().max(), err
        return got
    return run


def whole_model_forward():
    r = REF["model"]
    mesh = MESHES[(2, 4)]
    rules = pt.make_rules(mesh)
    axes = registry.build(RWKV).abstract_params()[1]
    params = pt.device_put(r["params"],
                           pt.tree_shardings(axes, r["params"], rules))
    tokens = pt.device_put(r["tokens"], rules.sharding_for(
        ("batch", None), r["tokens"].shape))
    with pt.use_rules(rules):
        logits, _ = registry.build(RWKV).forward(params, {"tokens": tokens})
    return close("logits", logits.full_tensor(), r["logits"], 3e-3)


def loss_fn_on_dtensors():
    r = REF["model"]
    mesh = MESHES[(2, 4)]
    rules = pt.make_rules(mesh)
    axes = registry.build(RWKV).abstract_params()[1]
    params = placed(mesh, r["params"], axes)
    tokens = pt.device_put(r["tokens"], rules.sharding_for(
        ("batch", None), r["tokens"].shape))
    with pt.use_rules(rules):
        loss, _ = steps.loss_fn(params, RWKV, {"tokens": tokens})
    loss = loss.full_tensor()
    got = torch.autograd.grad(loss, tree_leaves(params))
    want = tree_leaves(r["grads"])
    assert len(got) == len(want)
    # JAX's loss and gradients (``jax.value_and_grad`` of its loss_fn), at
    # the rwkv6 family's f32 gradient tolerance (RWKV_GRAD_TOL, as
    # tests/test_torch_lm_train.py holds the one-device port to them)
    tol = plans.RWKV_GRAD_TOL["float32"]["rtol"]
    return [close("loss", loss, r["loss"], 3e-4)] + [
        close(f"grad {i}", g.full_tensor(), w, tol)
        for i, (g, w) in enumerate(zip(got, want))]


JOBS = {
    "ep_forward": ep_forward,
    "ep_grads": ep_grads,
    "ep_counts_f32": ep_counts(torch.float32),
    "ep_counts_bf16": ep_counts(torch.bfloat16),
    "seqpar_forward_2x4": seqpar_forward((2, 4)),
    "seqpar_forward_1x8": seqpar_forward((1, 8)),
    "seqpar_forward_4x2": seqpar_forward((4, 2)),
    "seqpar_forward_s30": seqpar_forward((2, 4), S=30),
    "seqpar_grads_2x4": seqpar_grads((2, 4)),
    "seqpar_grads_1x8": seqpar_grads((1, 8)),
    "seqpar_grads_4x2": seqpar_grads((4, 2)),
    "seqpar_counts": seqpar_counts,
    "s30_takes_the_batch_path": s30_takes_the_batch_path,
    "whole_model_forward": whole_model_forward,
    "loss_fn_on_dtensors": loss_fn_on_dtensors,
}
for name, fn in JOBS.items():
    check(name, fn)
finish()
'''

CHECKS = ("ep_forward", "ep_grads", "ep_counts_f32", "ep_counts_bf16",
          "seqpar_forward_2x4", "seqpar_forward_1x8", "seqpar_forward_4x2",
          "seqpar_forward_s30", "seqpar_grads_2x4", "seqpar_grads_1x8",
          "seqpar_grads_4x2", "seqpar_counts", "s30_takes_the_batch_path",
          "whole_model_forward", "loss_fn_on_dtensors")


def _t(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree))


def _moe_refs():
    """JAX's MOE_EP contract: olmoe-1b-7b reduced, f32, no_drop."""
    cfg = jax_get_arch("olmoe-1b-7b").reduced()
    p, _ = split(jax_moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model))
    out, aux = jax_moe._apply_moe_dense(p, x, cfg, True)

    def loss(p, x):
        return jnp.sum(jax_moe._apply_moe_dense(p, x, cfg, True)[0] ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(p, x)
    by_shard = np.mean([jax_moe._apply_moe_dense(p, x[i:i + 2], cfg, True)[1]
                        ["moe_load_balance"] for i in (0, 2)])
    return {"p": _t(p), "x": _t(x), "out": _t(out),
            "load_balance_by_shard": _t(by_shard),
            "z_loss": _t(aux["moe_z_loss"]),
            "grads": dict(_t(gp), x=_t(gx))}


def _tmix_refs(S, grads=False):
    """JAX's SEQPAR contract: rwkv6-3b reduced, f32, B 4; the parameters
    also with the zero-initialised mixes and bonus perturbed, and with
    ``grads`` JAX's gradients of sum(out**2) + sum(shift**2) +
    sum(state**2) at them."""
    cfg = jax_get_arch("rwkv6-3b").reduced()
    p, _ = split(jax_rwkv.init_tmix(jax.random.PRNGKey(0), cfg, jnp.float32))
    B, d = 4, cfg.d_model
    x = jax.random.normal(jax.random.PRNGKey(1), (B, 32, d))[:, :S] * 0.5
    xp = jax.random.normal(jax.random.PRNGKey(2), (B, d)) * 0.5
    H, dh = jax_rwkv.n_heads(cfg), cfg.ssm.head_dim
    s0 = jax.random.normal(jax.random.PRNGKey(3), (B, H, dh, dh)) * 0.3
    out, shift, state = jax_rwkv._apply_tmix_local(p, cfg, x, xp, s0)
    rng = np.random.default_rng(0)
    pert = {k: jnp.asarray(np.asarray(v) + (0.1 * rng.standard_normal(
        v.shape)).astype(np.float32))
            if k in ("maa_x", "maa", "u") else v for k, v in p.items()}

    def loss(p, x, xp, s0):
        out, shift, state = jax_rwkv._apply_tmix_local(p, cfg, x, xp, s0)
        return (jnp.sum(out ** 2) + jnp.sum(shift ** 2)
                + jnp.sum(state ** 2))

    refs = {"p": _t(p), "p_pert": _t(pert), "x": _t(x), "xp": _t(xp),
            "s0": _t(s0), "out": _t(out), "shift": _t(shift),
            "state": _t(state)}
    if grads:
        g = jax.grad(loss, argnums=(0, 1, 2, 3))(pert, x, xp, s0)
        refs["grads"] = dict(zip(("p", "x", "xp", "s0"), map(_t, g)))
    return refs


def _model_refs():
    """JAX's FULL_MODEL_SEQPAR contract: the whole rwkv6-3b reduced
    forward on one device; and JAX's ``loss_fn`` there with its
    gradients."""
    cfg = jax_get_arch("rwkv6-3b").reduced()
    m = jax_registry.build(cfg)
    params, _ = split(m.init(jax.random.PRNGKey(0)))
    batch = jax_registry.make_batch(cfg, ShapeConfig("s", 32, 4, "train"),
                                    jax.random.PRNGKey(1))
    logits, _ = m.forward(params, batch)
    toks = {"tokens": batch["tokens"]}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jax_steps.loss_fn(p, cfg, toks), has_aux=True)(params)
    return {"params": _t(params), "tokens": _t(batch["tokens"]).long(),
            "logits": _t(logits), "loss": _t(loss), "grads": _t(grads)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    torch.save({"moe": _moe_refs(), "tmix": _tmix_refs(32, grads=True),
                "tmix30": _tmix_refs(30), "model": _model_refs()},
               tmp / "refs.pt")
    return torch_ranks.run(CODE, WORLD, tmp)


@pytest.mark.parametrize("name", CHECKS)
def test_distributed(results, name):
    torch_ranks.assert_held(results, name, WORLD)
