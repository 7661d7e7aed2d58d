"""The port's RWKV6 model (``repro_torch.models.rwkv``, ``transformer``,
``registry``, ``configs``) against the JAX package on the CPU, at the
reduced config ``rwkv6-3b-reduced`` (d 256, 2 layers, heads of 32, chunk 8),
in f32 and in bf16, the dtype the full-width model is served in.
Parameters come from the JAX ``init_params``, pass through
``split`` and ``convert``; the zero-initialised mixes, bonus and norm
affines are perturbed (the same numbers on both sides) so that every term
is exercised.  The JAX Pallas plan runs in interpret mode."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import jamba_1_5_large_398b  # noqa: E402
from repro_torch.core import plans  # noqa: E402
from repro_torch.models import common, registry, rwkv  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

#: tests/test_consistency.py's model-level tolerance
TOL = dict(rtol=3e-4, atol=3e-4)
#: layer-level agreement of the same f32 math in two frameworks
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "rwkv6-3b-reduced"
CFG = get_arch(NAME)
JCFG = jax_get_arch(NAME)
PERTURB = {"maa_x", "maa", "u", "mu_k", "mu_r"}


def _perturb(tree, rng, key=""):
    """Give the zero- and one-initialised leaves random values."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng, key) for v in tree)
    a = np.asarray(tree)
    if key in PERTURB or key == "bias":
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    if key == "scale":
        return (a * (1 + 0.1 * rng.standard_normal(a.shape))).astype(a.dtype)
    return a


@pytest.fixture(scope="module")
def both():
    """(JAX plain params, the port's params, the JAX model, the port's)."""
    jmodel = jax_registry.build(JCFG)
    plain, _ = split(jmodel.init(jax.random.PRNGKey(0)))
    np_tree = _perturb(jax.tree.map(np.asarray, plain),
                       np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, np_tree)
    return jparams, convert.params_from_numpy(np_tree), jmodel, \
        registry.build(CFG)


def _slot(jparams, params, part):
    """Layer 0's ``part`` ("mix" or "mlp") of both trees."""
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0][part])
    return jp, transformer._layer(params["blocks"][0][part], 0)


def _x(B, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, CFG.d_model)).astype(np.float32),
            rng.standard_normal((B, CFG.d_model)).astype(np.float32))


def _state(B, seed):
    H, dh = rwkv.n_heads(CFG), CFG.ssm.head_dim
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((B, H, dh, dh))).astype(np.float32)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_configs_are_the_jax_configs():
    for name in ("rwkv6-3b", NAME):
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(jax_get_arch(name))
    assert CFG.period == 1 and CFG.attention_free
    assert CFG.layer_kind(0) == "ssm" and not CFG.layer_is_moe(0)


def test_init_params_has_the_jax_tree(both):
    jparams, _, _, model = both
    mine = model.init(torch.Generator().manual_seed(0))
    theirs = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in sorted(tree.items())}
        if isinstance(tree, list):
            return [spec(v) for v in tree]
        return tuple(tree.shape), tree.dtype

    assert spec(mine) == spec(theirs)


def test_project_matches_jax(both):
    jparams, params, _, _ = both
    jp, p = _slot(jparams, params, "mix")
    x, xp = _x(2, 12, seed=1)
    got = rwkv._project(p, CFG, torch.from_numpy(x), torch.from_numpy(xp))
    want = jax_rwkv._project(jp, JCFG, jnp.asarray(x), jnp.asarray(xp))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("plan", list(plans.RWKV_PLANS))
def test_apply_tmix_matches_jax_under_each_plan(both, plan):
    """S = 20 does not divide the chunk (8): the tail path is in."""
    jparams, params, _, _ = both
    jp, p = _slot(jparams, params, "mix")
    x, xp = _x(2, 20, seed=2)
    s = _state(2, seed=3)
    got = rwkv.apply_tmix(p, CFG, torch.from_numpy(x), torch.from_numpy(xp),
                          torch.from_numpy(s), plan=plan)
    want = jax_rwkv._apply_tmix_local(jp, JCFG, jnp.asarray(x),
                                      jnp.asarray(xp), jnp.asarray(s),
                                      plan=plan)
    _close(got, want, plans.RWKV_TOL["float32"])


def test_default_plan_is_the_kernel_plan():
    assert rwkv.WKV_PLAN == "chunked_scan"


def test_step_tmix_matches_jax(both):
    jparams, params, _, _ = both
    jp, p = _slot(jparams, params, "mix")
    x, xp = _x(3, 1, seed=4)
    s = _state(3, seed=5)
    got = rwkv.step_tmix(p, CFG, torch.from_numpy(x), torch.from_numpy(xp),
                         torch.from_numpy(s))
    want = jax_rwkv.step_tmix(jp, JCFG, jnp.asarray(x), jnp.asarray(xp),
                              jnp.asarray(s))
    _close(got, want, LAYER_TOL)


def test_apply_cmix_matches_jax(both):
    jparams, params, _, _ = both
    jp, p = _slot(jparams, params, "mlp")
    x, xp = _x(2, 9, seed=6)
    got = rwkv.apply_cmix(p, torch.from_numpy(x), torch.from_numpy(xp))
    want = jax_rwkv.apply_cmix(jp, jnp.asarray(x), jnp.asarray(xp))
    _close(got, want, LAYER_TOL)


def test_wkv_step_and_chunked_match_jax():
    rng = np.random.default_rng(7)
    B, S, H, d = 2, 16, 3, 4
    r, k, v = (rng.standard_normal((B, S, H, d)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, d))).astype(np.float32)
    u = rng.standard_normal((H, d)).astype(np.float32)
    s = rng.standard_normal((B, H, d, d)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (r, k, v, logw, u, s)]
    j = [jnp.asarray(a) for a in (r, k, v, logw, u, s)]
    _close(rwkv.wkv_chunked(*t, 4), jax_rwkv.wkv_chunked(*j, 4), LAYER_TOL)
    step_t = [a[:, 0] for a in t[:4]] + t[4:]
    step_j = [a[:, 0] for a in j[:4]] + j[4:]
    _close(rwkv.wkv_step(*step_t), jax_rwkv.wkv_step(*step_j), LAYER_TOL)


def _tokens(S):
    rng = np.random.default_rng(8)
    return rng.integers(0, CFG.vocab, (2, S)).astype(np.int32)


def test_forward_prefill_and_decode_match_jax(both):
    jparams, params, jmodel, model = both
    toks = _tokens(19)
    got, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    cache = model.init_cache(2, 64)
    jcache, _ = split(jmodel.init_cache(2, 64))
    pre = toks[:, :17]
    got, cache = model.prefill(params, cache, {"tokens": torch.from_numpy(pre)})
    want, jcache = jmodel.prefill(jparams, jcache, {"tokens": jnp.asarray(pre)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(jax.tree.leaves(convert.params_to_numpy(cache)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jcache))):
        np.testing.assert_allclose(g, w, **TOL)
    for t in (17, 18):
        got, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, t])})
        want, jcache = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, t])})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == 19


def test_decode_equals_forward(both):
    """The port's tests/test_consistency.py::test_decode_equals_forward
    [rwkv6-3b]: prefill of 16 tokens plus 2 decode steps reproduces the
    full-sequence logits."""
    _, params, _, model = both
    shape = ShapeConfig("smoke", 33, 2, "train")
    toks = np.array(jax_registry.make_batch(JCFG, shape, jax.random.PRNGKey(1))
                      ["tokens"])
    toks = torch.from_numpy(toks)
    prefix, extra = 16, 2
    full, _ = model.forward(params, {"tokens": toks[:, :prefix + extra]},
                            inference=True)
    cache = model.init_cache(2, 64)
    first, cache = model.prefill(params, cache, {"tokens": toks[:, :prefix]})
    torch.testing.assert_close(first[:, 0], full[:, prefix - 1], **TOL)
    for t in range(extra):
        d, cache = model.decode_step(params, cache,
                                     {"tokens": toks[:, prefix + t]})
        torch.testing.assert_close(d, full[:, prefix + t], **TOL)


def test_rwkv_chunk_size_is_execution_detail(both):
    """The chunk (work-unit) size of the scan does not change the logits."""
    _, params, _, _ = both
    toks = torch.from_numpy(_tokens(32))
    outs = []
    for chunk in (1, 4, 16):
        cfg = dataclasses.replace(
            CFG, ssm=dataclasses.replace(CFG.ssm, chunk=chunk))
        outs.append(registry.build(cfg).forward(params, {"tokens": toks})[0])
    torch.testing.assert_close(outs[0], outs[1], **TOL)
    torch.testing.assert_close(outs[0], outs[2], **TOL)


def test_convert_round_trips_params_and_caches(both):
    jparams, params, jmodel, _ = both
    np_params = jax.tree.map(np.asarray, jparams)
    back = convert.params_to_numpy(convert.params_from_numpy(np_params))
    assert isinstance(back["blocks"], list)          # JAX keeps a tuple
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jcache = jax.tree.map(np.asarray, split(jmodel.init_cache(2, 8))[0])
    cache = convert.params_from_numpy(jcache)
    assert cache["pos"].shape == () and cache["pos"].dtype == torch.int32
    assert [tuple(t.shape) for t in cache["slots"][0].values()] == \
        [tuple(a.shape) for a in jcache["slots"][0].values()]


def test_unported_layers_raise_naming_their_roadmap_item():
    """Every layer and front the port has builds; only a mix it has no
    path for raises (an ``ssm.kind`` other than rwkv6 and mamba), before
    anything is allocated.  A dense attention config builds (attention
    blocks and dense MLPs, k/v cache slots), and so do its vision and
    audio fronts (ROADMAP Queue 1, "The vision and audio fronts"): the
    codebooks' ``audio_embed`` (K, V, d) and ``audio_heads`` (K, d, V) in
    place of ``embed`` and an untied ``lm_head``, the vision projector
    ``vis_proj`` (in and out, with biases), the same k/v cache, and a slot
    engine whose token buffer is (B, K) for codebooks; so does an MoE one
    (router and expert stacks on the MoE slots, the layer of every second
    slot for Jamba's ``every=2``), and so does the attention-free Jamba
    stack."""
    from repro_torch.serving import EngineConfig, SlotEngine

    attn = dataclasses.replace(CFG, n_heads=4, n_kv_heads=2, ssm=None)
    model = registry.build(attn)
    params = model.init(torch.Generator().manual_seed(0))
    assert set(params["blocks"][0]["mix"]) == {"wq", "wk", "wv", "wo"}
    assert set(params["blocks"][0]["mlp"]) == {"wg", "wu", "wd"}
    assert set(model.init_cache(1, 8)["slots"][0]) == {"k", "v"}
    d, V = CFG.d_model, CFG.vocab
    audio = registry.build(dataclasses.replace(attn, n_codebooks=2))
    p = audio.init(torch.Generator().manual_seed(0))
    assert {"audio_embed", "audio_heads"} <= set(p)
    assert not {"embed", "lm_head"} & set(p)
    assert tuple(p["audio_embed"].shape) == (2, V, d)
    assert tuple(p["audio_heads"].shape) == (2, d, V)
    assert set(audio.init_cache(1, 8)["slots"][0]) == {"k", "v"}
    eng = SlotEngine(audio, p, config=EngineConfig(n_slots=3, max_seq=8))
    assert tuple(eng.manager.tokens.shape) == (3, 2)
    assert eng.manager.tokens.dtype == torch.int32
    vision = registry.build(dataclasses.replace(attn, n_vis_tokens=4,
                                                vis_dim=16))
    p = vision.init(torch.Generator().manual_seed(0))
    assert {"embed", "vis_proj"} <= set(p)
    assert tuple(p["vis_proj"]["in"]["w"].shape) == (16, d)
    assert tuple(p["vis_proj"]["out"]["w"].shape) == (d, d)
    assert set(p["vis_proj"]["in"]) == set(p["vis_proj"]["out"]) == {"w",
                                                                     "b"}
    assert set(vision.init_cache(1, 8)["slots"][0]) == {"k", "v"}
    other = dataclasses.replace(CFG, ssm=dataclasses.replace(CFG.ssm,
                                                             kind="s4"))
    for build in (lambda m: m.init(torch.Generator().manual_seed(0)),
                  lambda m: m.init_cache(1, 8)):
        with pytest.raises(NotImplementedError, match="rwkv6 and mamba"):
            build(registry.build(other))
    moe = dataclasses.replace(attn, moe=dataclasses.replace(
        get_arch("jamba-1.5-large-398b").moe, n_experts=4, d_ff=32))
    params = registry.build(moe).init(torch.Generator().manual_seed(0))
    assert [set(b["mlp"]) for b in params["blocks"]] == [
        {"wg", "wu", "wd"}, {"router", "wg", "wu", "wd"}]
    assert tuple(params["blocks"][1]["mlp"]["wg"].shape) == (
        1, 4, CFG.d_model, 32)
    jamba = get_arch("jamba-1.5-large-398b")
    free = dataclasses.replace(jamba, n_layers=2, **jamba_1_5_large_398b
                               .ATTENTION_FREE).reduced()
    model = registry.build(free)
    params = model.init(torch.Generator().manual_seed(0))
    assert len(params["blocks"]) == 1
    assert set(params["blocks"][0]["mix"]) >= {"in_proj", "a_log"}
    assert set(params["blocks"][0]["mlp"]) == {"wg", "wu", "wd"}
    assert set(model.init_cache(1, 8)["slots"][0]) == {"conv", "h"}


# ---------------------------------------------------------------------------
# bf16: the dtype the full-width model is served in
# ---------------------------------------------------------------------------
#: the rwkv6 family's bf16 tier
BF16_TOL = plans.RWKV_TOL["bfloat16"]
CFG16 = dataclasses.replace(CFG, dtype="bfloat16")
JCFG16 = dataclasses.replace(JCFG, dtype="bfloat16")


@pytest.fixture(scope="module")
def both16():
    """The bf16 model, JAX's and the port's, and two parameter trees, each
    as (JAX, port): ``drawn``, exactly as the JAX init draws them (and as
    ``launch/serve`` serves them: bonus u and the mixes zero), and
    ``perturbed``, every term exercised as in ``both``."""
    jmodel = jax_registry.build(JCFG16)
    plain, _ = split(jmodel.init(jax.random.PRNGKey(0)))
    drawn = jax.tree.map(np.asarray, plain)
    trees = {"drawn": drawn,
             "perturbed": _perturb(drawn, np.random.default_rng(0))}
    return {name: (jax.tree.map(jnp.asarray, t), convert.params_from_numpy(t))
            for name, t in trees.items()}, jmodel, registry.build(CFG16)


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _close16(got, want):
    """Same dtypes as JAX's, and each output within the family's tier of its
    dtype: a bf16 output at the bf16 tier, an f32 one (logw, the state) at
    the f32 tier, so that a cast that rounds the decay or the state to bf16
    shows."""
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_allclose(_f32(g), _f32(w),
                                   **plans.RWKV_TOL[str(w.dtype)])


def _x16(B, S, seed):
    x, xp = _x(B, S, seed)
    return x.astype(jnp.bfloat16), xp.astype(jnp.bfloat16)


BF16_LAYERS = ["project", "step_tmix", "cmix"] + [
    f"tmix-{p}" for p in plans.RWKV_PLANS]


@pytest.mark.parametrize("layer", BF16_LAYERS)
def test_bf16_layers_match_jax(both16, layer):
    """Each layer of the bf16 model on the same bf16 inputs and f32 state as
    JAX's, at the family's bf16 tier: this holds every cast of the served
    model (mixes and decay LoRA in f32, r/k/v/g in bf16, logw and the state
    f32, the scan's out in v's dtype before the head-norm, cmix in bf16)
    against JAX's layer compiled whole."""
    jparams, params = both16[0]["perturbed"]
    part = "mlp" if layer == "cmix" else "mix"
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0][part])
    p = transformer._layer(params["blocks"][0][part], 0)
    S = 1 if layer == "step_tmix" else 20
    x, xp = _x16(2, S, seed=11)
    s = _state(2, seed=12)
    t = [convert.params_from_numpy(a) for a in (x, xp, s)]
    j = [jnp.asarray(a) for a in (x, xp, s)]
    # JAX's layer compiled as one computation, as its jitted steps and the
    # layer scan of its forward run it (XLA keeps f32 across some of the
    # layer's bf16 casts, and the port rounds where that graph does)
    if layer == "project":
        got = rwkv._project(p, CFG16, *t[:2])
        want = jax.jit(lambda q, *a: jax_rwkv._project(q, JCFG16, *a))(
            jp, *j[:2])
    elif layer == "step_tmix":
        got = rwkv.step_tmix(p, CFG16, *t)
        want = jax.jit(lambda q, *a: jax_rwkv.step_tmix(q, JCFG16, *a))(
            jp, *j)
    elif layer == "cmix":
        got = rwkv.apply_cmix(p, *t[:2])
        want = jax.jit(jax_rwkv.apply_cmix)(jp, *j[:2])
    else:
        plan = layer.removeprefix("tmix-")
        got = rwkv.apply_tmix(p, CFG16, *t, plan=plan)
        want = jax.jit(lambda q, *a: jax_rwkv._apply_tmix_local(
            q, JCFG16, *a, plan=plan))(jp, *j)
    _close16(got, want)


@pytest.mark.parametrize("name", ["sigmoid", "silu"])
def test_bf16_gate_gradients_equal_jax(name):
    """RWKV6's bf16 gates (``common.sigmoid``, ``silu``), forward and
    gradient, against ``jax.nn``'s and ``jax.grad``'s, over x from -100
    (where exp(-x) overflows to inf in bf16) to 100: finite and equal.
    XLA's CPU flushes subnormal results to zero and PyTorch's does not,
    so they are held to the least normal number, 2^-126, times max|x|
    (silu multiplies a subnormal sigmoid by x)."""
    x = np.array([-100, -89, -88, -20, -3.3, -0.7, 0, 0.4, 2.9, 17, 100],
                 np.float32)
    w = np.linspace(-1.5, 2.0, x.size).astype(np.float32)
    jfn = getattr(jax.nn, name)
    jx, jw = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    want_y = jfn(jx)
    want_g = jax.grad(lambda a: jnp.sum(
        jfn(a).astype(jnp.float32) * jw.astype(jnp.float32)))(jx)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    y = getattr(common, name)(tx)
    (g,) = torch.autograd.grad(
        (y.float() * torch.from_numpy(w).to(torch.bfloat16).float()).sum(),
        tx)
    assert y.dtype == g.dtype == torch.bfloat16
    assert torch.isfinite(g).all()
    for got, want in ((y, want_y), (g, want_g)):
        np.testing.assert_allclose(_f32(got.detach()), _f32(want), rtol=0,
                                   atol=2.0 ** -126 * np.abs(x).max())


def _close_at_scale(got, want, tol):
    """``|got - want| <= atol + rtol * max|want|`` over the array: the bf16
    tier at the array's own scale.  Two frameworks round bf16 differently
    between ops (XLA's CPU fusions keep f32 where PyTorch rounds each op),
    so a rounding step of a large entry can land on a near-zero one after a
    layer; JAX's own eager and jitted bf16 forwards differ that way."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    bound = tol["atol"] + tol["rtol"] * np.abs(w).max()
    assert np.abs(g - w).max() <= bound, (np.abs(g - w).max(), bound)


def test_bf16_model_matches_jax(both16):
    """The bf16 model as served (``drawn`` parameters), 2 layers: forward,
    prefill (logits, shift and wkv caches) and one decode step against
    JAX's.  The elementwise bf16 tier holds per layer (above); over the
    stack it holds at the array's scale.  With the bonus u perturbed, the
    first token's head-norm normalises one rank-one term r.(u*k) v whose
    dot product cancels, so bf16 rounding of r and k is amplified there —
    in JAX's bf16 model against its own f32 model as much as in the
    port's; the layer test covers u."""
    trees, jmodel, model = both16
    jparams, params = trees["drawn"]
    toks = _tokens(19)
    got, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    _close_at_scale(got, want, BF16_TOL)

    cache = model.init_cache(2, 64)
    jcache, _ = split(jmodel.init_cache(2, 64))
    pre = toks[:, :17]
    got, cache = model.prefill(params, cache,
                               {"tokens": torch.from_numpy(pre)})
    want, jcache = jmodel.prefill(jparams, jcache,
                                  {"tokens": jnp.asarray(pre)})
    _close_at_scale(got, want, BF16_TOL)
    for name, buf in cache["slots"][0].items():
        assert str(buf.dtype).removeprefix("torch.") == \
            str(jcache["slots"][0][name].dtype)
        _close_at_scale(buf, jcache["slots"][0][name], BF16_TOL)
    got, cache = model.decode_step(
        params, cache, {"tokens": torch.from_numpy(toks[:, 17])})
    want, jcache = jmodel.decode_step(
        jparams, jcache, {"tokens": jnp.asarray(toks[:, 17])})
    _close_at_scale(got, want, BF16_TOL)
