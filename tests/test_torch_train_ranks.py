"""The trainer on several ranks (``launch/train.train`` inside a process
group: the JAX trainer's host mesh of several devices) against the JAX
package's.

The reduced Qwen2 and RWKV6 trained 3 AdamW steps of 4 x 32 tokens from
JAX's weights (``PRNGKey(0)``, converted by ``convert.py``) on 4 gloo CPU
ranks as (data=4, model=1) and (data=2, model=2): the parameters and the
AdamW moments DTensors placed by the default rules (embed over 'data',
FSDP-style), each rank cutting its batch shard from the same synthetic
stream.  Each step's loss and ``grad_norm`` are held, at the tolerances of
tests/test_torch_lm_train.py's ``test_three_train_steps_match_jax``, on
every step that JAX's own runs reproduce (``_held_steps``: all three for
Qwen2, the first for RWKV6 at this input), against ``jax.jit(train_step)``
on 4 forced host devices over the same meshes (in a subprocess, its ``jax.make_mesh`` wrapped to make ``Auto``
axes: jax 0.9's default ``Explicit`` axes refuse the JAX models'
sharding constraints; the JAX package is not edited), and against the
port's one-device trainer on the same weights and batches.  The ranks'
report: every rank prints JAX's ``arch= params= mesh=`` line, only rank 0
the step lines; the moments share their parameters' placements; the
checkpoint holds whole tensors, equal on every rank to the gathered
parameters.

Beside them, prefill and 3 decode steps on DTensors (``SERVE``) from JAX's
weights: every rank's logits against JAX's ``prefill_step`` and
``decode_step`` jitted over the same (data, model) host mesh on the same
tokens, and against the port's same steps on plain tensors.  The weights
reach the trainer as any draw would: ``Model.init_annot`` patched to give
them (``torch_ranks.init_annot_from``).  One 4-rank job
(``torch_ranks.run``) runs every check, beside the JAX subprocess; each
parametrised case reads one."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import torch_ranks  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train as train_lm  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ARCHS = ("qwen2-0.5b-reduced", "rwkv6-3b-reduced")
MODEL_AXES = (1, 2)
STEPS, BATCH, SEQ, LR = 3, 4, 32, 3e-3
#: tests/test_torch_lm_train.py's STEP_LOSS_TOL and STEP_GNORM_TOL
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
CASES = [(a, m) for a in ARCHS for m in MODEL_AXES]
#: prefill + decode on DTensors: attention with its heads and its cache's
#: sequence split over 'model', the seq-parallel RWKV6 prefill and its
#: decode, Mamba's channels and the expert-parallel MoE (the Jamba
#: hybrid), and the MoE's dense dispatch on (4, 1)
SERVE = [("qwen2-0.5b-reduced", (2, 2)), ("rwkv6-3b-reduced", (2, 2)),
         ("jamba-1.5-large-398b-reduced", (2, 2)),
         ("olmoe-1b-7b-reduced", (4, 1))]
#: the serving batch: 4 prompts of 16 tokens, 3 decode steps, a cache of
#: 32 slots; the port's prefill + decode tolerance
S_BATCH, S_PROMPT, S_DECODE, S_CACHE = 4, 16, 3, 32
SERVE_TOL = 3e-4
#: each rank's stacked serving logits, in the job's directory
SERVE_FILE = "serve-{arch}-{d}x{m}-rank{rank}.pt"

JAX_CODE = r'''
import functools, json, sys
import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def make_mesh(shape, axes, **kw):
    # jax 0.9 makes Explicit axes by default; the models' constraints
    # need Auto ones
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, axes, **kw)


jax.make_mesh = make_mesh

from repro import steps  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.data.lm import SyntheticLM  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.optim import AdamW, warmup_cosine  # noqa: E402
from repro.partitioning import (make_rules, split, tree_shardings,  # noqa
                                use_rules)
import numpy as np  # noqa: E402

CASES, SERVE, STEPS, BATCH, SEQ, LR, TOKS, S_CACHE, OUT = json.loads(
    sys.argv[1])
res = {}
# each arch also on one device (model_axis 0: no mesh), JAX's own spread
for arch, model_axis in CASES + [(a, 0) for a in dict(CASES)]:
    cfg = get_arch(arch)
    mesh = (make_host_mesh(model_axis=model_axis) if model_axis else
            jax.make_mesh((1, 1), ("data", "model"),
                          devices=jax.devices()[:1]))
    rules = make_rules(mesh)
    params, axes = split(registry.build(cfg).init(jax.random.PRNGKey(0)))
    opt = AdamW(lr=warmup_cosine(LR, STEPS // 10, STEPS))
    state = opt.init(params)
    params = jax.device_put(params, tree_shardings(axes, params, rules))
    step_fn = jax.jit(functools.partial(steps.train_step, opt, cfg),
                      donate_argnums=(0, 1))
    it = SyntheticLM(cfg.vocab, seed=0).batches(BATCH, SEQ)
    losses, norms = [], []
    with mesh, use_rules(rules):
        for _ in range(STEPS):
            batch = {k: jax.numpy.asarray(v) for k, v in next(it).items()}
            params, state, m = step_fn(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    res[f"{arch}/{model_axis or 'one'}"] = {
        "losses": losses, "grad_norms": norms, "mesh": dict(mesh.shape)}

# prefill, then decode steps, on the serving meshes: (B, vocab) logits a
# step, stacked
toks = np.load(TOKS)
serve = {}
for arch, shape in SERVE:
    cfg = get_arch(arch)
    model = registry.build(cfg)
    mesh = make_host_mesh(model_axis=shape[1])
    assert tuple(mesh.shape.values()) == tuple(shape), mesh.shape
    rules = make_rules(mesh)
    params, axes = split(model.init(jax.random.PRNGKey(0)))
    params = jax.device_put(params, tree_shardings(axes, params, rules))
    cache, c_axes = split(model.init_cache(len(toks[arch + "/prompt"]),
                                           S_CACHE))
    cache = jax.device_put(cache, tree_shardings(c_axes, cache, rules))
    prefill = jax.jit(functools.partial(steps.prefill_step, cfg))
    decode = jax.jit(functools.partial(steps.decode_step, cfg))
    with mesh, use_rules(rules):
        logits, cache = prefill(params, cache, {"tokens": jax.numpy.asarray(
            toks[arch + "/prompt"].astype(np.int32))})
        outs = [np.asarray(logits[:, 0])]
        for t in toks[arch + "/next"]:
            logits, cache = decode(params, cache, {
                "tokens": jax.numpy.asarray(t.astype(np.int32))})
            outs.append(np.asarray(logits))
    serve[f"{arch} {tuple(shape)}"] = np.stack(outs)
np.savez(OUT + ".serve.npz", **serve)
with open(OUT, "w") as f:
    json.dump(res, f)
'''

CODE = r'''
import contextlib, io
import numpy as np
import torch
from torch.distributed.tensor import DTensor
from repro_torch import partitioning as pt
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch
from repro_torch.launch import train as train_lm
from repro_torch.models import registry
from repro_torch.optim.adamw import tree_leaves, tree_map
from torch_ranks import init_annot_from

# JAX's weights in place of every draw
registry.Model.init_annot = init_annot_from(
    torch.load(f"{TMP}/init.pt", weights_only=True))
TOKS = np.load(f"{TMP}/serve_tokens.npz")
STEPS, BATCH, SEQ, LR = ''' + repr((STEPS, BATCH, SEQ, LR)) + r'''
S_CACHE, SERVE_TOL, SERVE_FILE = ''' + repr(
    (S_CACHE, SERVE_TOL, SERVE_FILE)) + r'''


def job(arch, model_axis):
    def run():
        buf = io.StringIO()
        ckpt_dir = f"{TMP}/ckpt-{arch}-{model_axis}"
        with contextlib.redirect_stdout(buf):
            rep = train_lm.train(get_arch(arch), steps=STEPS, batch=BATCH,
                                 seq=SEQ, lr=LR, seed=0, device="cpu",
                                 log_every=1, model_axis=model_axis,
                                 ckpt_dir=ckpt_dir, ckpt_every=STEPS)
        out = buf.getvalue().splitlines()
        assert out[0].startswith(f"arch={get_arch(arch).name} params="), out
        assert f"mesh={rep['mesh']}" in out[0], out[0]
        step_lines = [ln for ln in out if ln.startswith("{")]
        assert len(step_lines) == (STEPS if RANK == 0 else 0), out
        leaves = tree_leaves(rep["params"])
        assert all(isinstance(p, DTensor) for p in leaves)
        # the checkpoint rank 0 wrote: whole tensors, the gathered
        # parameters, on every rank
        whole = tree_map(pt.full_tensor, rep["params"])
        torch.distributed.barrier()
        saved = ckpt.restore(ckpt_dir, whole)
        for a, b in zip(tree_leaves(saved), tree_leaves(whole)):
            assert a.shape == b.shape and torch.equal(a, b)
        return {"losses": rep["losses"], "grad_norms": rep["grad_norms"],
                "mesh": rep["mesh"]}
    return run


def serve(arch, shape):
    """Prefill the prompts and decode 3 steps on DTensors over the mesh
    ``shape`` from JAX's weights; this rank's logits (gathered) go to a
    file the test holds against JAX's, and are held here against the same
    steps on plain tensors (every rank computes both) at the port's
    prefill + decode tolerance."""
    def run():
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models import transformer
        cfg = get_arch(arch)
        model = registry.build(cfg)
        params, axes = pt.split(model.init_annot(None))
        toks = torch.from_numpy(TOKS[arch + "/prompt"])
        nxt = torch.from_numpy(TOKS[arch + "/next"])
        B = toks.shape[0]
        want = []
        with torch.no_grad():
            cache = model.init_cache(B, S_CACHE)
            want.append(model.prefill(params, cache, {"tokens": toks})[0][:, 0])
            for t in nxt:
                want.append(model.decode_step(params, cache,
                                              {"tokens": t})[0])
        rules = pt.make_rules(mesh_lib.group_mesh(("data", "model"), shape,
                                                  "cpu"))
        put = lambda t, ax: pt.device_put(t, rules.sharding_for(ax, t.shape))
        dp = pt.device_put(params, pt.tree_shardings(axes, params, rules))
        c_vals, c_axes = pt.split(transformer.init_cache_annot(cfg, B,
                                                               S_CACHE))
        dc = pt.device_put(c_vals, pt.tree_shardings(c_axes, c_vals, rules))
        sax = "seq_model" if cfg.seq_shard else "seq"
        got = []
        with pt.use_rules(rules), torch.no_grad():
            got.append(model.prefill(dp, dc, {"tokens": put(
                toks, ("batch", sax))})[0][:, 0])
            for t in nxt:
                got.append(model.decode_step(dp, dc, {"tokens": put(
                    t, ("batch",))})[0])
        got = torch.stack([pt.full_tensor(g) for g in got])
        torch.save(got, f"{TMP}/" + SERVE_FILE.format(
            arch=arch, d=shape[0], m=shape[1], rank=RANK))
        want = torch.stack(want)
        torch.testing.assert_close(got, want, rtol=SERVE_TOL, atol=SERVE_TOL)
        return float((got - want).abs().max())
    return run



for arch, model_axis in ''' + repr(CASES) + r''':
    check(f"{arch}/{model_axis}", job(arch, model_axis))
for arch, shape in ''' + repr(SERVE) + r''':
    check(f"serve {arch} {shape}", serve(arch, tuple(shape)))
finish()
'''


def _init(arch: str) -> dict:
    """JAX's ``PRNGKey(0)`` weights of ``arch``, converted."""
    cfg = jax_get_arch(arch)
    p, _ = split(jax_registry.build(cfg).init(jax.random.PRNGKey(0)))
    return convert.params_from_numpy(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the ranks' results, the port's one device, the
    job's directory).  JAX's serving logits are under ``"serve"``."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    archs = sorted(set(ARCHS) | {a for a, _ in SERVE})
    inits = {get_arch(a).name: _init(a) for a in archs}
    torch.save(inits, tmp / "init.pt")
    rng = np.random.default_rng(1)
    toks = {}
    for arch, _ in SERVE:
        vocab = get_arch(arch).vocab
        toks[arch + "/prompt"] = rng.integers(0, vocab, (S_BATCH, S_PROMPT))
        toks[arch + "/next"] = rng.integers(0, vocab, (S_DECODE, S_BATCH))
    np.savez(tmp / "serve_tokens.npz", **toks)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    (tmp / "ref_jax.py").write_text(JAX_CODE, encoding="utf-8")
    # the training cases and the serving ones in two JAX processes, side
    # by side with the ranks
    outs = [tmp / "ref_jax_train.json", tmp / "ref_jax_serve.json"]
    logs = [open(str(o) + ".log", "w+") for o in outs]
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "ref_jax.py"),
         json.dumps([cases, serve, STEPS, BATCH, SEQ, LR,
                     str(tmp / "serve_tokens.npz"), S_CACHE, str(out)])],
        env=env, stdout=log, stderr=subprocess.STDOUT)
        for out, log, (cases, serve) in zip(outs, logs,
                                            ((CASES, []), ([], SERVE)))]
    try:
        ranks = torch_ranks.run(CODE, WORLD, tmp)
        for proc, log in zip(procs, logs):
            proc.wait(timeout=300)
            log.seek(0)
            assert proc.returncode == 0, log.read()[-4000:]
    finally:
        for proc, log in zip(procs, logs):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    one = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry.Model, "init_annot",
                   torch_ranks.init_annot_from(inits))
        for arch in ARCHS:
            one[arch] = train_lm.train(get_arch(arch), steps=STEPS,
                                       batch=BATCH, seq=SEQ, lr=LR, seed=0,
                                       device="cpu", log_every=1)
    jax_side = json.loads(outs[0].read_text())
    with np.load(str(outs[1]) + ".serve.npz") as z:
        jax_side["serve"] = {k: z[k] for k in z.files}
    return jax_side, ranks, one, tmp


def _held_steps(jax_side: dict, arch: str) -> int:
    """The steps whose losses and grad norms JAX itself reproduces: the
    leading steps on which its one-device run and its runs on the meshes
    agree within half the tolerances.  AdamW's first update moves every
    element by about lr whatever its gradient's size, so an element whose
    gradient is at the level of f32 rounding moves by +-lr with a sign the
    summation order picks; from the step where that shows in JAX's own
    runs (RWKV6's reduced width at 4 x 32 tokens: its step-2 gradient norm
    differs by percents between JAX's one-device and 4-device runs), the
    trajectory is no longer a reference at these tolerances, and those
    steps are printed, not held.  The count comes from JAX's runs alone,
    not from the runs a check compares."""
    one = jax_side[f"{arch}/one"]
    for step in range(STEPS):
        for m in MODEL_AXES:
            run = jax_side[f"{arch}/{m}"]
            for key, tol in (("losses", LOSS_RTOL),
                             ("grad_norms", GNORM_RTOL)):
                a, b = run[key][step], one[key][step]
                if abs(a - b) > tol / 2 * abs(b):
                    return step
    return STEPS


def _hold(got: dict, want: dict, n: int, what: str) -> None:
    print(f"{what}: losses {got['losses']} vs {want['losses']}, grad norms "
          f"{got['grad_norms']} vs {want['grad_norms']} (the first {n} "
          "steps held)")
    np.testing.assert_allclose(got["losses"][:n], want["losses"][:n],
                               rtol=LOSS_RTOL, atol=0, err_msg=what)
    np.testing.assert_allclose(got["grad_norms"][:n], want["grad_norms"][:n],
                               rtol=GNORM_RTOL, atol=0, err_msg=what)


@pytest.mark.parametrize("arch,model_axis", CASES)
def test_ranks_train_as_jax_and_one_device(runs, arch, model_axis):
    """Every rank's losses and grad norms against JAX's on the same mesh
    and against the port's one-device trainer, at the tolerances of
    ``test_three_train_steps_match_jax``, on the steps JAX reproduces
    (``_held_steps``: at least the first, the gradients themselves)."""
    jax_side, ranks, one, _ = runs
    name = f"{arch}/{model_axis}"
    torch_ranks.assert_held(ranks, name, WORLD)
    want = jax_side[name]
    assert want["mesh"] == {"data": WORLD // model_axis, "model": model_axis}
    n = _held_steps(jax_side, arch)
    assert n >= 1
    for rank, _, detail in ranks[name]:
        got = eval(detail)          # the check's repr'd return value
        assert got["mesh"] == want["mesh"]
        _hold(got, want, n, f"{name} rank {rank} vs JAX")
        _hold(got, one[arch], n, f"{name} rank {rank} vs one device")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_trainer_matches_jax(runs, arch):
    """The port's one-device trainer from JAX's weights against JAX's on
    one device: the reference the ranks meet, on the same steps."""
    jax_side, _, one, _ = runs
    _hold(one[arch], jax_side[f"{arch}/one"], _held_steps(jax_side, arch),
          f"{arch} one device vs JAX")
    assert one[arch]["mesh"] == {"data": 1, "model": 1}
    if arch.startswith("qwen2"):
        assert _held_steps(jax_side, arch) == STEPS


@pytest.mark.parametrize("arch,shape", SERVE)
def test_prefill_and_decode_on_ranks_match_one_device(runs, arch, shape):
    """Every rank's prefill and 3 decode steps on DTensors equal to the
    same steps on plain tensors within 3e-4 (``serve`` in the job)."""
    _, ranks, _, _ = runs
    torch_ranks.assert_held(ranks, f"serve {arch} {tuple(shape)}", WORLD)


@pytest.mark.parametrize("arch,shape", SERVE)
def test_prefill_and_decode_on_ranks_match_jax(runs, arch, shape):
    """Every rank's prefill and 3 decode steps on DTensors against JAX's
    ``prefill_step`` and ``decode_step`` jitted over the same host mesh,
    from the same weights and tokens, within 3e-4."""
    jax_side, ranks, _, tmp = runs
    torch_ranks.assert_held(ranks, f"serve {arch} {tuple(shape)}", WORLD)
    want = jax_side["serve"][f"{arch} {tuple(shape)}"]
    assert want.shape == (S_DECODE + 1, S_BATCH, get_arch(arch).vocab)
    for rank in range(WORLD):
        got = torch.load(tmp / SERVE_FILE.format(
            arch=arch, d=shape[0], m=shape[1], rank=rank)).numpy()
        print(f"{arch} {shape} rank {rank}: max |port - JAX| "
              f"{np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=SERVE_TOL,
                                   atol=SERVE_TOL,
                                   err_msg=f"rank {rank} vs JAX")


def test_trainer_places_batches_of_any_rank(monkeypatch):
    """The trainer places each batch input by its own rank: the vision
    front's (B, n_vis, vis_dim) patch embeddings beside its (B, S) tokens,
    as a caller's stream (``chip_smoke.py``'s fronts training) gives
    them, on the one-device mesh."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import registry

    cfg = get_arch("internvl2-1b-reduced")

    class Stream:
        def __init__(self, vocab, seed=0):
            self.gen = torch.Generator().manual_seed(seed + 1)

        def batches(self, batch, seq):
            shape = ShapeConfig("fronts", seq, batch, "train")
            while True:
                yield {k: v.numpy() for k, v in registry.make_batch(
                    cfg, shape, self.gen).items()}

    monkeypatch.setattr(train_lm, "SyntheticLM", Stream)
    rep = train_lm.train(cfg, steps=1, batch=2, seq=cfg.n_vis_tokens + 8,
                         device="cpu", log_every=1)
    assert len(rep["losses"]) == 1 and np.isfinite(rep["losses"][0])
