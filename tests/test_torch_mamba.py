"""The port's Mamba model (``repro_torch.models.mamba``, ``mlp``, the mamba
half of ``transformer``, ``steps``) against the JAX package on the CPU, at
the attention-free Jamba stack both packages build the same way,
``dataclasses.replace(CONFIG, n_heads=0, n_kv_heads=0, attn_every=0,
moe=None, n_layers=2)``, reduced (d_model 256, d_inner 512, d_state 8,
chunk 8, vocab 512, 2 layers of Mamba + SwiGLU MLP), in f32.

Parameters come from the JAX ``init_params`` through ``split`` and
``convert``, with the zero- and one-initialised conv bias, skip and norm
scales perturbed (the same numbers on both sides).  The port's scan runs
its default plan ``fused_scan`` (on the CPU the kernels' plain versions,
under autograd ``_MambaFn``'s) or the plain ``scan``; the JAX model runs
its own ``lax.scan``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import steps as jax_steps  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert, steps  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import jamba_1_5_large_398b as jamba  # noqa: E402
from repro_torch.core import plans  # noqa: E402
from repro_torch.data.lm import SyntheticLM  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.models import mamba, mlp, registry, transformer  # noqa: E402
from repro_torch.optim.adamw import (AdamW, tree_leaves,  # noqa: E402
                                     warmup_cosine)

FREE = dict(jamba.ATTENTION_FREE, n_layers=2)
CFG = dataclasses.replace(get_arch("jamba-1.5-large-398b"), **FREE).reduced()
JCFG = dataclasses.replace(jax_get_arch("jamba-1.5-large-398b"),
                           **FREE).reduced()
#: layer-level agreement of the same f32 math in two frameworks
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
#: tests/test_consistency.py's model-level tolerance
TOL = dict(rtol=3e-4, atol=3e-4)
GRAD_TOL = plans.MAMBA_GRAD_TOL["float32"]
PERTURB = {"conv_b", "d_skip", "scale"}


def _perturb(tree, rng, key=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng, key) for v in tree)
    a = np.asarray(tree)
    if key in PERTURB:
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


def _np_tree(cfg, seed=0, perturb=True):
    plain, _ = split(jax_registry.build(cfg).init(jax.random.PRNGKey(seed)))
    tree = jax.tree.map(np.asarray, plain)
    return _perturb(tree, np.random.default_rng(seed)) if perturb else tree


@pytest.fixture(scope="module")
def both():
    """(JAX params, the port's params, the JAX model, the port's), f32."""
    tree = _np_tree(JCFG)
    return (jax.tree.map(jnp.asarray, tree), convert.params_from_numpy(tree),
            jax_registry.build(JCFG), registry.build(CFG))


def _layer(jparams, params, part):
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0][part])
    return jp, transformer._layer(params["blocks"][0][part], 0)


def _rand(*shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol=LAYER_TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), **tol)


def test_config_is_the_jax_config():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert (mamba.d_inner(CFG), mamba.dt_rank(CFG), CFG.ssm.d_state) == \
        (jax_mamba.d_inner(JCFG), jax_mamba.dt_rank(JCFG), 8) == (512, 16, 8)
    full = get_arch("jamba-1.5-large-398b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_arch("jamba-1.5-large-398b"))


def test_init_params_has_the_jax_tree(both):
    jparams, _, _, model = both
    mine = model.init(torch.Generator().manual_seed(0))
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(mine)] == \
        [(tuple(t.shape), t.dtype) for t in tree_leaves(want)]
    mix = transformer._layer(mine["blocks"][0]["mix"], 0)
    assert torch.equal(mix["a_log"], torch.log(torch.arange(
        1, 9, dtype=torch.float32)).repeat(512, 1))
    dt = torch.nn.functional.softplus(mix["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def test_conv_causal_matches_jax(both):
    """Tap i reads position t - (dc-1-i): the carried window first."""
    jp, p = _layer(both[0], both[1], "mix")
    x, prev = _rand(2, 7, 512, seed=1), _rand(2, 3, 512, seed=2)
    want = jax_mamba._conv_causal(jp, jnp.asarray(x), jnp.asarray(prev))
    got = mamba._conv_causal(p, torch.from_numpy(x), torch.from_numpy(prev))
    _close([got], [want])


def test_ssm_params_match_jax(both):
    jp, p = _layer(both[0], both[1], "mix")
    xc = _rand(2, 7, 512, seed=3)
    want = jax_mamba._ssm_params(jp, JCFG, jnp.asarray(xc))
    got = mamba._ssm_params(p, CFG, torch.from_numpy(xc))
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, want)


@pytest.mark.parametrize("plan", list(plans.MAMBA_PLANS))
def test_scan_matches_jax_under_each_plan(both, plan, monkeypatch):
    monkeypatch.setattr(mamba, "SCAN_PLAN", plan)
    jp, p = _layer(both[0], both[1], "mix")
    xc, h0 = _rand(2, 11, 512, seed=4), _rand(2, 512, 8, seed=5, scale=0.3)
    dt, b, c = mamba._ssm_params(p, CFG, torch.from_numpy(xc))
    want = jax_mamba._scan(jp, jnp.asarray(xc), *(jnp.asarray(t.numpy())
                                                  for t in (dt, b, c)),
                           jnp.asarray(h0))
    got = mamba._scan(p, torch.from_numpy(xc), dt, b, c, torch.from_numpy(h0),
                      chunk=CFG.ssm.chunk)
    assert got[0].dtype == got[1].dtype == torch.float32
    _close(got, want)


def test_default_plan_is_the_kernel_plan():
    assert mamba.SCAN_PLAN == "fused_scan"


@pytest.mark.parametrize("S", [9, 1])
def test_apply_and_step_mamba_match_jax(both, S):
    """The full-sequence block and the one-token step (``step_mamba`` is
    ``apply_mamba`` at S=1, as in JAX): output, new conv window (the last
    dc-1 inputs before activation) and new state."""
    jp, p = _layer(both[0], both[1], "mix")
    x = _rand(2, S, CFG.d_model, seed=6)
    conv = _rand(2, CFG.ssm.d_conv - 1, 512, seed=7)
    h = _rand(2, 512, 8, seed=8, scale=0.3)
    jfn = jax_mamba.step_mamba if S == 1 else jax_mamba.apply_mamba
    fn = mamba.step_mamba if S == 1 else mamba.apply_mamba
    want = jfn(jp, JCFG, *map(jnp.asarray, (x, conv, h)))
    got = fn(p, CFG, *map(torch.from_numpy, (x, conv, h)))
    assert got[1].shape == (2, CFG.ssm.d_conv - 1, 512)
    _close(got, want)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_jax(act):
    cfg = dataclasses.replace(CFG, mlp_act=act)
    jcfg = dataclasses.replace(JCFG, mlp_act=act)
    jp, _ = split(jax_mlp.init_mlp(jax.random.PRNGKey(3), jcfg, jnp.float32))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    mine = mlp.init_mlp(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    x = _rand(2, 5, CFG.d_model, seed=9)
    want = jax_mlp.apply_mlp(jp, jnp.asarray(x), jcfg)
    got = mlp.apply_mlp(p, torch.from_numpy(x))
    _close([got], [want])


# ---------------------------------------------------------------------------
# the affine summary (tests/test_mamba_affine.py's twins)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def segment(both):
    _, p = _layer(both[0], both[1], "mix")
    p = dict(p, d_skip=torch.zeros(512))       # the raw scan
    xc = torch.from_numpy(_rand(2, 16, 512, seed=10, scale=0.5))
    dt = torch.nn.functional.softplus(torch.from_numpy(_rand(2, 16, 512,
                                                             seed=11)))
    b, c = (torch.from_numpy(_rand(2, 16, 8, seed=s)) for s in (12, 13))
    h0 = torch.from_numpy(_rand(2, 512, 8, seed=14, scale=0.3))
    return p, xc, dt, b, c, h0


def _scan(p, xc, dt, b, c, h0):
    return mamba._scan(p, xc, dt, b, c, h0, chunk=8)


def test_segment_chaining_equals_full_scan(segment):
    p, xc, dt, b, c, h0 = segment
    y, h = _scan(p, xc, dt, b, c, h0)
    y1, mid = _scan(p, xc[:, :8], dt[:, :8], b[:, :8], c[:, :8], h0)
    y2, end = _scan(p, xc[:, 8:], dt[:, 8:], b[:, 8:], c[:, 8:], mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(end, h, rtol=1e-5, atol=1e-5)


def test_affine_summary_identity(segment):
    """h_out(seg, h0) == D_seg * h0 + A_seg, and D_seg is JAX's."""
    p, xc, dt, b, c, h0 = segment
    _, a_seg = _scan(p, xc, dt, b, c, torch.zeros_like(h0))
    d_seg = mamba.scan_summary(p, dt, b)
    _, h = _scan(p, xc, dt, b, c, h0)
    torch.testing.assert_close(d_seg * h0 + a_seg, h, rtol=1e-5, atol=1e-5)
    want = jax_mamba.scan_summary({"a_log": jnp.asarray(p["a_log"].numpy())},
                                  jnp.asarray(dt.numpy()),
                                  jnp.asarray(b.numpy()))
    _close([d_seg], [want])


def test_affine_composition(segment):
    p, xc, dt, b, c, h0 = segment
    zero = torch.zeros_like(h0)
    halves = [(mamba.scan_summary(p, dt[:, sl], b[:, sl]),
               _scan(p, xc[:, sl], dt[:, sl], b[:, sl], c[:, sl], zero)[1])
              for sl in (slice(0, 8), slice(8, 16))]
    d, a = mamba.compose_affine(*halves[0], *halves[1])
    torch.testing.assert_close(d, mamba.scan_summary(p, dt, b), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(a, _scan(p, xc, dt, b, c, zero)[1],
                               rtol=1e-5, atol=1e-5)
    jd, ja = jax_mamba.compose_affine(*(jnp.asarray(t.numpy()) for t in (
        *halves[0], *halves[1])))
    _close([d, a], [jd, ja])


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------
def _toks(B, S, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("plan", list(plans.MAMBA_PLANS))
def test_forward_matches_jax(both, plan, monkeypatch):
    jparams, params, jmodel, model = both
    monkeypatch.setattr(mamba, "SCAN_PLAN", plan)
    toks = _toks(2, 21, seed=15)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and aux == {}
    _close([got], [want], TOL)


def test_prefill_and_decode_equal_forward(both):
    """Prefill S tokens, decode K more from the cache: the logits of each
    position equal the full forward's, and the cache holds JAX's states."""
    jparams, params, jmodel, model = both
    S, K = 13, 4
    toks = _toks(2, S + K, seed=16)
    full, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    cache = model.init_cache(2, S + K)
    first, cache = model.prefill(params, cache,
                                 {"tokens": torch.from_numpy(toks[:, :S])})
    torch.testing.assert_close(first[:, 0], full[:, S - 1], **TOL)
    jcache = jmodel.init_cache(2, S + K)
    _, jcache = jmodel.prefill(jparams, split(jcache)[0],
                               {"tokens": jnp.asarray(toks[:, :S])})
    for name in ("conv", "h"):
        _close([cache["slots"][0][name]], [jcache["slots"][0][name]], TOL)
    for t in range(K):
        logits, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, S + t])})
        torch.testing.assert_close(logits, full[:, S + t], **TOL)
    assert int(cache["pos"]) == S + K


def _port_params(tree):
    params = convert.params_from_numpy(tree)
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


def _jax_leaves(tree):
    return [t.float().numpy() for t in tree_leaves(
        convert.params_from_numpy(jax.tree.map(np.asarray, tree)))]


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's f32 ``loss_fn`` gradients on the perturbed tree (remat on)."""
    tree = _np_tree(JCFG)
    toks = _toks(2, 24, seed=17)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jax_steps.loss_fn(p, JCFG, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    return tree, toks, float(loss), _jax_leaves(grads)


@pytest.mark.parametrize("plan,remat", [("fused_scan", True),
                                        ("fused_scan", False),
                                        ("scan", True)])
def test_loss_fn_grads_match_jax(jax_grads, plan, remat, monkeypatch):
    """The port's ``loss_fn`` through ``fused_scan`` (``_MambaFn``: the
    trajectory forward and the hand-derived backward, plain on the CPU)
    and through ``scan`` (autograd of the plain recurrence), remat on and
    off, against ``jax.grad`` of JAX's, at MAMBA_GRAD_TOL f32."""
    tree, toks, jloss, want = jax_grads
    monkeypatch.setattr(mamba, "SCAN_PLAN", plan)
    params = _port_params(tree)
    loss, _ = steps.loss_fn(params, CFG, {"tokens": torch.from_numpy(toks)},
                            remat=remat)
    got = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_training_calls_each_kernel_as_jax_dispatches(jax_grads,
                                                      monkeypatch):
    """On the CPU the wrappers count no launch; counting their calls shows
    the plumbing the card's counts rest on: a step with remat is two K7t
    and one K7b a layer, without remat one and one; no K7."""
    tree, toks, _, _ = jax_grads
    calls = dict.fromkeys(("mamba_scan_traj", "mamba_scan_bwd",
                           "mamba_scan_plain"), 0)
    for name in calls:
        fn = getattr(ms, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ms, name, counted)
    L = CFG.n_layers
    for remat in (True, False):
        for k in calls:
            calls[k] = 0
        params = _port_params(tree)
        loss, _ = steps.loss_fn(params, CFG,
                                {"tokens": torch.from_numpy(toks)},
                                remat=remat)
        torch.autograd.grad(loss, tree_leaves(params))
        assert calls == {"mamba_scan_traj": (2 if remat else 1) * L,
                         "mamba_scan_bwd": L, "mamba_scan_plain": 0}


#: three AdamW steps against JAX's (tests/test_torch_lm_train.py's bands)
STEP_LOSS_TOL = dict(rtol=1e-4, atol=0)
STEP_GNORM_TOL = dict(rtol=1e-3, atol=0)


@pytest.mark.parametrize("plan", list(plans.MAMBA_PLANS))
def test_three_train_steps_match_jax(jax_grads, plan, monkeypatch):
    tree = jax_grads[0]
    monkeypatch.setattr(mamba, "SCAN_PLAN", plan)
    data = SyntheticLM(CFG.vocab, seed=0).batches(2, 16)
    batches = [next(data)["tokens"] for _ in range(3)]
    jopt = JaxAdamW(lr=jax_warmup_cosine(3e-3, 1, 3))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    opt = AdamW(lr=warmup_cosine(3e-3, 1, 3))
    params = _port_params(tree)
    state = opt.init(params)
    for toks in batches:
        jparams, jstate, jm = jax_steps.train_step(
            jopt, JCFG, jparams, jstate, {"tokens": jnp.asarray(toks)})
        params, state, m = steps.train_step(
            opt, CFG, params, state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **STEP_LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **STEP_GNORM_TOL)
    assert state["step"] == 3


# ---------------------------------------------------------------------------
# bf16 gradients: the dtype the full-width model trains in
# ---------------------------------------------------------------------------
CFG16 = dataclasses.replace(CFG, dtype="bfloat16")
JCFG16 = dataclasses.replace(JCFG, dtype="bfloat16")
#: the port's bf16 gradient error, relative to each leaf's max|f32 grad|,
#: may be this many times JAX's own bf16 error on the same leaf, plus one
#: bf16 step at that max (2^-8) for the leaves where JAX's error is near 0
BF16_GRAD_MULTIPLE = 2.0
BF16_STEP = 2.0 ** -8


def _bf16_errors(seed):
    """Per leaf, the bf16 gradient's max abs error against JAX's f32
    gradient, over max|f32 grad|: (the port's, JAX's)."""
    tree16 = _np_tree(JCFG16, seed=seed, perturb=False)
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree16)
    toks = _toks(2, 24, seed=100 + seed)

    def grads(cfg, tree):
        return _jax_leaves(jax.grad(lambda p: jax_steps.loss_fn(
            p, cfg, {"tokens": jnp.asarray(toks)})[0])(
                jax.tree.map(jnp.asarray, tree)))

    want, jax16 = grads(JCFG, tree32), grads(JCFG16, tree16)
    params = _port_params(tree16)
    loss, _ = steps.loss_fn(params, CFG16,
                            {"tokens": torch.from_numpy(toks)})
    mine = [g.float().numpy() for g in torch.autograd.grad(
        loss, tree_leaves(params))]

    def rel(got):
        return [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                for g, w in zip(got, want)]
    return rel(mine), rel(jax16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_grads_are_as_close_to_f32_as_jax_bf16(seed):
    """The bf16 stack's ``loss_fn`` gradients (as drawn by the JAX init)
    against JAX's f32 gradients of the same bf16 weights: per leaf, the
    port's error is at most BF16_GRAD_MULTIPLE times JAX's bf16 error plus
    one bf16 step (both relative to the leaf's max|f32 grad|)."""
    mine, theirs = _bf16_errors(seed)
    for i, (m, t) in enumerate(zip(mine, theirs)):
        assert m <= BF16_GRAD_MULTIPLE * t + BF16_STEP, (i, m, t)
