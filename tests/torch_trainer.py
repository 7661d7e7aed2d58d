"""Both packages' trainers over the trainer's own schedule, for the tests
that hold the port's training curve to JAX's (tests/test_torch_lm_train.py,
tests/test_torch_mamba.py, tests/test_torch_moe_models.py).

``run_both(jcfg, cfg, ...)`` draws the weights with the JAX package's
``init_params`` (``PRNGKey(seed)``), then runs

* JAX: its trainer's loop (``launch/train.py``): AdamW on
  ``warmup_cosine(lr, steps // 10, steps)``, ``jax.jit`` of
  ``steps.train_step``, ``SyntheticLM(vocab, seed)`` batches;
* the port: its trainer itself (``launch.train.train`` on the CPU), fed the
  same weights through ``Model.init_annot`` (``torch_ranks.init_annot_from``).

At ``steps=8`` the warmup is ``8 // 10 = 0``: the schedule the card's
8-step runs train on.  ``run_from_jax_states`` holds each of those steps
alone, the port's step taken from JAX's state before it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro import steps as jax_steps
from repro.data.lm import SyntheticLM as JaxSyntheticLM
from repro.models import registry as jax_registry
from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.partitioning import split

import torch
import torch_ranks
from repro_torch import convert
from repro_torch import steps as steps_lib
from repro_torch.launch import train as train_lm
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamW, tree_leaves, warmup_cosine

#: the trainer's default learning rate (both packages' ``--lr``)
LR = 3e-3


def _init(jcfg, seed):
    """The JAX package's ``init_params`` (``PRNGKey(seed)``) as numpy."""
    plain, _ = split(jax_registry.build(jcfg).init(jax.random.PRNGKey(seed)))
    return jax.tree.map(np.asarray, plain)


def run_jax(jcfg, *, steps=8, batch=2, seq=24, seed=0, lr=LR, before=None):
    """JAX's metrics of each of ``steps`` trainer steps, as a list of dicts
    of floats; ``before(params, state, batch)``, if given, sees JAX's
    parameters, AdamW state and batch before each step."""
    np_tree = _init(jcfg, seed)
    opt = JaxAdamW(lr=jax_warmup_cosine(lr, steps // 10, steps))
    params = jax.tree.map(jnp.asarray, np_tree)
    state = opt.init(params)
    step_fn = jax.jit(functools.partial(jax_steps.train_step, opt, jcfg))
    it = JaxSyntheticLM(jcfg.vocab, seed=seed).batches(batch, seq)
    out = []
    for _ in range(steps):
        b = next(it)
        if before is not None:
            before(params, state, b)
        params, state, m = step_fn(params, state, {
            k: jnp.asarray(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


def run_from_jax_states(jcfg, cfg, *, steps=8, batch=2, seq=24, seed=0,
                        lr=LR):
    """(JAX's metrics, the port's) of each of ``steps`` trainer steps, each
    of the port's ``steps.train_step`` taken from JAX's parameters, AdamW
    moments and step count before it: every step's gradient and update
    held on its own, with none of the earlier steps' differences carried
    into it."""
    opt = AdamW(lr=warmup_cosine(lr, steps // 10, steps))
    mine = []

    def port_step(params, state, b):
        p = convert.params_from_numpy(jax.tree.map(np.asarray, params))
        for t in tree_leaves(p):
            t.requires_grad_()
        s = {k: convert.params_from_numpy(jax.tree.map(np.asarray, state[k]))
             for k in ("mu", "nu")}
        s["step"] = int(state["step"])
        _, _, m = steps_lib.train_step(
            opt, cfg, p, s, {k: torch.from_numpy(v) for k, v in b.items()})
        mine.append({k: float(v) for k, v in m.items()})

    theirs = run_jax(jcfg, steps=steps, batch=batch, seq=seq, seed=seed,
                     lr=lr, before=port_step)
    return theirs, mine


def run_both(jcfg, cfg, monkeypatch, *, steps=8, batch=2, seq=24,
             seed=0, lr=LR):
    """(JAX's metrics, the port's) of each of ``steps`` trainer steps, as
    two lists of dicts of floats."""
    theirs = run_jax(jcfg, steps=steps, batch=batch, seq=seq, seed=seed,
                     lr=lr)
    monkeypatch.setattr(registry.Model, "init_annot",
                        torch_ranks.init_annot_from(
                            {cfg.name: convert.params_from_numpy(
                                _init(jcfg, seed))}))
    report = train_lm.train(cfg, steps=steps, batch=batch, seq=seq, lr=lr,
                            seed=seed, device="cpu", log_every=1)
    return theirs, report["history"]
