"""The LayerNorm archs trained: StableLM-2-12B and Command-R-35B through the
port's ``steps.loss_fn``/``train_step`` and ``launch/train.py`` against the
JAX package on the CPU.

Both at their reduced width (d_model 256, 2 layers, vocab 512) with their
training head shapes kept where ``reduced()`` would cut them to 4/2 x 64:
StableLM-shaped 4/2 query heads of 160 (a GQA group of 2, so that K8b's
partial-sum reduction runs at dh 160) and Command-R-shaped 8/1 of 128 (a
group of 8) with its tied head and rope theta 8e6.  The same
``dataclasses.replace`` on both sides; weights from JAX's ``init_params``
through ``convert``, the LayerNorm scales and biases and the QKV biases set
at random, the same numbers on both sides.  The port's attention runs its
plan ``flash_prefill``: under autograd ``_FlashPrefillFn``, which on the
CPU runs the plain versions of K8t and K8b (on the card: the kernels).
Held against JAX: ``loss_fn`` gradients with remat on and off, three AdamW
steps, the trainer's own 8 steps (``tests/torch_trainer.py``) and the bf16
gradient rule; on the port alone, the kernel calls of a step and the
entry point.  Tolerances are tests/test_torch_attn_train.py's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import steps as jax_steps  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.partitioning import split  # noqa: E402

import test_torch_attn_train as attn_tests  # noqa: E402
import torch_trainer  # noqa: E402
from repro_torch import kernels, steps  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_lm  # noqa: E402
from repro_torch.optim.adamw import (AdamW, tree_leaves,  # noqa: E402
                                     warmup_cosine)

#: the training head shapes at the reduced width
SHAPED = {"stablelm-12b": dict(n_heads=4, n_kv_heads=2, head_dim=160),
          "command-r-35b": dict(n_heads=8, n_kv_heads=1, head_dim=128)}
ARCHS = sorted(SHAPED)
PERTURB = {"scale", "bias", "bq", "bk", "bv"}
GRAD_TOL = attn_tests.GRAD_TOL
STEP_LOSS_TOL = attn_tests.STEP_LOSS_TOL
STEP_GNORM_TOL = attn_tests.STEP_GNORM_TOL
BF16_GRAD_MULTIPLE = attn_tests.BF16_GRAD_MULTIPLE
BF16_STEP = attn_tests.BF16_STEP


def _cfgs(name: str, dtype: str = "float32"):
    """(port config, JAX config): ``name`` reduced, its heads kept."""
    return tuple(dataclasses.replace(get(name).reduced(), dtype=dtype,
                                     **SHAPED[name])
                 for get in (get_arch, jax_get_arch))


def _perturb(tree, rng, key=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng, key) for v in tree)
    a = np.asarray(tree)
    if key in PERTURB:
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


def _np_tree(jcfg, seed=0):
    plain, _ = split(jax_registry.build(jcfg).init(jax.random.PRNGKey(seed)))
    return _perturb(jax.tree.map(np.asarray, plain),
                    np.random.default_rng(seed))


@pytest.fixture(scope="module", params=ARCHS)
def ln(request):
    """(config, JAX config, perturbed numpy params, tokens (2, 40))."""
    cfg, jcfg = _cfgs(request.param)
    return cfg, jcfg, _np_tree(jcfg), attn_tests._toks(cfg.vocab, 2, 40,
                                                       seed=1)


def test_the_training_shapes_are_kept(ln):
    cfg, jcfg, _, _ = ln
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.norm == "ln"
    group = cfg.n_heads // cfg.n_kv_heads
    assert (cfg.head_dim, group) in ((160, 2), (128, 8))
    assert cfg.tie_embeddings == (cfg.head_dim == 128)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_fn_grads_match_jax(ln, remat):
    """The port's ``loss_fn`` loss and every leaf's gradient against
    ``jax.value_and_grad`` of JAX's ``loss_fn``, remat on and off."""
    cfg, jcfg, tree, toks = ln
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)},
                                    remat=remat)[0]))(
        jax.tree.map(jnp.asarray, tree))
    params = attn_tests._port(tree)
    loss, _ = steps.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks)},
                            remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = attn_tests._jax_leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_three_train_steps_match_jax(ln):
    cfg, jcfg, tree, _ = ln
    data = SyntheticLM(cfg.vocab, seed=0).batches(2, 24)
    batches = [next(data)["tokens"] for _ in range(3)]
    jopt = JaxAdamW(lr=jax_warmup_cosine(3e-3, 1, 3))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jax.jit(lambda p, st, b: jax_steps.train_step(jopt, jcfg, p, st,
                                                           b))
    opt = AdamW(lr=warmup_cosine(3e-3, 1, 3))
    params = attn_tests._port(tree)
    state = opt.init(params)
    for toks in batches:
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {"tokens": jnp.asarray(toks)})
        params, state, m = steps.train_step(
            opt, cfg, params, state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **STEP_LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **STEP_GNORM_TOL)
    assert state["step"] == 3


@pytest.mark.parametrize("name", ARCHS)
def test_eight_trainer_steps_match_jax(name, monkeypatch):
    """The trainer's own schedule at ``--steps 8`` (warmup 8 // 10 = 0,
    lr 3e-3, AdamW), which T1 runs on the card: the port's
    ``launch.train.train`` from the JAX package's ``init_params`` against
    JAX's trainer loop, every step's loss and grad norm."""
    cfg, jcfg = _cfgs(name)
    theirs, mine = torch_trainer.run_both(jcfg, cfg, monkeypatch)
    assert len(theirs) == len(mine) == 8
    for t, m in zip(theirs, mine):
        np.testing.assert_allclose(m["loss"], t["loss"], **STEP_LOSS_TOL)
        np.testing.assert_allclose(m["grad_norm"], t["grad_norm"],
                                   **STEP_GNORM_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ARCHS)
def test_bf16_grads_are_as_close_to_f32_as_jax_bf16(name, seed):
    """The bf16 model's ``loss_fn`` gradients against JAX's f32 gradients
    of the same bf16 weights: per leaf, the port's error is at most
    BF16_GRAD_MULTIPLE times JAX's bf16 error plus one bf16 step (both
    relative to the leaf's max|f32 grad|)."""
    cfg, jcfg16 = _cfgs(name, "bfloat16")
    jcfg32 = dataclasses.replace(jcfg16, dtype="float32")
    plain, _ = split(jax_registry.build(jcfg16).init(
        jax.random.PRNGKey(seed)))
    tree16 = jax.tree.map(np.asarray, plain)
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree16)
    toks = attn_tests._toks(cfg.vocab, 2, 24, seed=100 + seed)

    def jax_grads(jcfg, tree):
        return attn_tests._jax_leaves(jax.jit(jax.grad(
            lambda p: jax_steps.loss_fn(
                p, jcfg, {"tokens": jnp.asarray(toks)})[0]))(
                    jax.tree.map(jnp.asarray, tree)))

    want, theirs = jax_grads(jcfg32, tree32), jax_grads(jcfg16, tree16)
    params = attn_tests._port(tree16)
    loss, _ = steps.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks)})
    mine = [g.float().numpy() for g in torch.autograd.grad(
        loss, tree_leaves(params))]
    for i, (m, t, w) in enumerate(zip(mine, theirs, want)):
        scale = max(float(np.abs(w).max()), 1e-30)
        e_m = float(np.abs(m - w).max()) / scale
        e_t = float(np.abs(t - w).max()) / scale
        assert e_m <= BF16_GRAD_MULTIPLE * e_t + BF16_STEP, (i, e_m, e_t)


def test_a_training_step_calls_k8t_twice_and_k8b_once_a_layer(ln):
    """A remat step (the trainer's) calls K8t twice per attention layer
    (the forward and its recompute), K8b once, and K8 never: counted
    through ``kernels.CALLS`` on the CPU, where the wrappers run their
    plain versions."""
    cfg, _, tree, toks = ln
    params = attn_tests._port(tree)
    names = ("flash_prefill", "flash_prefill_traj", "flash_prefill_bwd")
    before = {n: kernels.CALLS[n] for n in names}
    loss, _ = steps.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks)})
    torch.autograd.grad(loss, tree_leaves(params))
    calls = {n: kernels.CALLS[n] - before[n] for n in names}
    L = cfg.n_layers
    assert calls == {"flash_prefill": 0, "flash_prefill_traj": 2 * L,
                     "flash_prefill_bwd": L}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_trains_on_the_cpu(arch, capsys):
    report = train_lm.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--steps", "2", "--batch", "2", "--seq", "24",
                            "--log-every", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith(f"arch={arch}-reduced params=")
    assert out[-1].startswith("loss ") and " -> " in out[-1]
    assert len(report["losses"]) == 2
    assert all(np.isfinite(report["losses"] + report["grad_norms"]))
