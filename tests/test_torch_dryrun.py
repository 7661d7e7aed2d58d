"""The port's production-mesh dry run (``launch/dryrun.py``) and its
accounting (``analysis.count_pallas_grid_steps``, ``ici_seconds``, the
collective term of ``Roofline``) against the JAX package's.

Two subprocesses, started together, compute the two sides:
  * the port's, as rank 0 of a ``fake`` process group of 256 or 512 ranks
    (``dryrun.start_group``): every argument of every case placed on the
    production mesh by ``dryrun.build_case`` (its DTensor placements and
    its rank-0 shard), and ``dryrun.run_case`` of the reduced cases (one
    step traced on meta DTensors);
  * JAX's, with 512 forced host devices and ``jax.make_mesh`` wrapped to
    make ``Auto`` axes: jax 0.9's ``make_mesh`` makes ``Explicit`` axes by
    default, under which ``with_sharding_constraint`` refuses the JAX
    models' constraints ("can only refer to Auto axes"), and the JAX dry
    run was written for Auto axes.  The wrap lives in the subprocess; the
    JAX package is not edited.  It resolves the same shardings as its
    ``build_case`` (``sharding.spec``, ``sharding.shard_shape``) and
    lowers and compiles the reduced cases
    (``memory_analysis().argument_size_in_bytes``, the HLO's
    ``collective_bytes``, ``jax.eval_shape`` of the step).

Every arch x input shape on pod1 and one case a family on pod2 hold the
port's PartitionSpecs and rank-0 shard shapes equal to JAX's, and
``params``, ``analytic`` and ``model_flops`` equal; the reduced cases
hold ``argument_bytes`` and the step's output shapes and dtypes equal, and
print the collective bytes beside JAX's HLO ones (XLA chooses its own
collectives, so they are not held equal).  In this process: the grid-step
twin against JAX's ``count_pallas_grid_steps`` on JAX's own cases
(tests/test_plan_equivalence.py's T and chunk sweep, doubled in training;
tests/test_mamba_scan.py's grid), and ``ici_seconds``' ring multipliers
against JAX's at 16 shards."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import analysis as jax_analysis  # noqa: E402
from repro.core import plans as jax_plans  # noqa: E402
from repro.kernels import mamba_scan as jax_ms  # noqa: E402

from repro_torch import analysis  # noqa: E402
from repro_torch.configs import ARCHS, INPUT_SHAPES  # noqa: E402
from repro_torch.core import plans  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: one case a family on the (2, 16, 16) mesh
POD2 = [("rwkv6-3b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
        ("olmoe-1b-7b", "prefill_32k"), ("jamba-1.5-large-398b", "long_500k"),
        ("internvl2-1b", "train_4k"), ("musicgen-large", "prefill_32k")]
FULL = [(a, s, "pod1") for a in ARCHS for s in INPUT_SHAPES] + [
    (a, s, "pod2") for a, s in POD2]
#: reduced archs JAX lowers and compiles on the (16, 16) mesh
COMPILED = [("qwen2-0.5b-reduced", "decode_32k"),
            ("rwkv6-3b-reduced", "train_4k"),
            ("olmoe-1b-7b-reduced", "prefill_32k")]

COMMON = r'''
import json, sys
FULL, COMPILED, OUT = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \
    sys.argv[3]


def key(arch, shape, mesh):
    return f"{arch}__{shape}__{mesh}"


def spec_json(entries):
    out = [list(e) if isinstance(e, tuple) else e for e in entries]
    while out and out[-1] is None:
        out.pop()
    return out
'''

JAX_CODE = COMMON + r'''
import jax
from jax.sharding import AxisType, NamedSharding

_make_mesh = jax.make_mesh


def make_mesh(shape, axes, **kw):
    # jax 0.9 makes Explicit axes by default; the JAX dry run needs Auto
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, axes, **kw)


jax.make_mesh = make_mesh

from repro import analysis, partitioning  # noqa: E402
from repro.configs import get_arch, get_shape  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models import registry, transformer  # noqa: E402
from repro.partitioning import make_rules, tree_shardings  # noqa: E402


def layout(shardings, values, tag, out):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    for (path, sh), v in zip(flat, jax.tree_util.tree_leaves(values)):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[f"{tag}/{name}"] = [spec_json(sh.spec),
                                list(sh.shard_shape(v.shape))]


res = {}
for arch, shape_name, mesh_name in FULL:
    shape = get_shape(shape_name)
    cfg = registry.config_for_shape(get_arch(arch), shape)
    mesh = make_production_mesh(multi_pod=mesh_name == "pod2")
    rules = make_rules(mesh, {"embed": ()} if shape.kind == "decode"
                       else None)
    out = {}
    params, axes = transformer.abstract_params(cfg)
    layout(tree_shardings(axes, params, rules), params, "params", out)
    specs = registry.input_specs(cfg, shape)
    b_axes = dryrun._batch_axes(cfg, shape, specs)
    layout({k: rules.sharding_for(b_axes[k], s.shape)
            for k, s in specs.items()}, specs, "batch", out)
    if shape.kind != "train":
        cache, c_axes = transformer.abstract_cache(
            cfg, shape.global_batch, shape.seq_len)
        layout(tree_shardings(c_axes, cache, rules), cache, "cache", out)
    res[key(arch, shape_name, mesh_name)] = {
        "layout": out, "params": list(analysis.param_counts(cfg)),
        "analytic": analysis.analytic_costs(cfg, shape),
        "model_flops": analysis.model_flops(cfg, shape)}
for arch, shape_name in COMPILED:
    jitted, args, (cfg, shape, mesh, rules, meta) = dryrun.build_case(
        arch, shape_name, False)
    with mesh, partitioning.use_rules(rules):
        compiled = jitted.lower(*args).compile()
        outs = jax.eval_shape(jitted, *args)
    shapes = outs[2] if shape.kind == "train" else {"logits": outs[0]}
    res[key(arch, shape_name, "pod1")] = {
        "argument_bytes":
            int(compiled.memory_analysis().argument_size_in_bytes),
        "collective_bytes": analysis.collective_bytes(compiled.as_text()),
        "outputs": {k: [list(v.shape), str(v.dtype)]
                    for k, v in sorted(shapes.items())}}
with open(OUT, "w") as f:
    json.dump(res, f)
'''

PORT_CODE = COMMON + r'''
import torch
from repro_torch.launch import dryrun
from repro_torch.optim.adamw import tree_leaves

torch.set_num_threads(1)


def paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def spec_of(t):
    """The PartitionSpec a DTensor's placements realise."""
    names = [[] for _ in range(t.dim())]
    for axis, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            names[pl.dim].append(axis)
    return spec_json([None if not n else n[0] if len(n) == 1 else tuple(n)
                      for n in names])


res = {}
for arch, shape_name, mesh_name in FULL:
    dryrun.start_group(512 if mesh_name == "pod2" else 256)
    _, args, (cfg, shape, mesh, rules, meta) = dryrun.build_case(
        arch, shape_name, mesh_name == "pod2", device="cpu")
    params, second, batch = args
    out = {}
    trees = [("params", params), ("batch", batch)]
    if shape.kind != "train":
        trees.append(("cache", second))
    for tag, tree in trees:
        for name, t in paths(tree):
            out[f"{tag}/{name}"] = [spec_of(t), list(t.to_local().shape)]
    moments = shape.kind != "train" or all(
        list(m.placements) == list(p.placements)
        and m.to_local().shape == p.to_local().shape
        for p, mu, nu in zip(tree_leaves(params), tree_leaves(second["mu"]),
                             tree_leaves(second["nu"])) for m in (mu, nu))
    acc = dryrun.accounting(cfg, shape, meta["n_chips"])
    res[key(arch, shape_name, mesh_name)] = {
        "layout": out, "params": list(acc["params"]),
        "analytic": acc["analytic"],
        "model_flops": acc["roofline"]["model_flops"],
        "moments_placed_as_params": moments}
for arch, shape_name in COMPILED:
    rec = dryrun.run_case(arch, shape_name, False, OUT + ".records",
                          device="cpu")
    res[key(arch, shape_name, "pod1")] = {
        k: rec[k] for k in ("argument_bytes", "collective_bytes", "outputs",
                            "launches", "grid_steps", "roofline",
                            "cost_analysis_hlo", "memory_analysis",
                            "trace_s")}
with open(OUT, "w") as f:
    json.dump(res, f)
'''


def _start(code: str, tmp: Path, name: str, env: dict):
    script = tmp / f"{name}.py"
    script.write_text(code, encoding="utf-8")
    out = tmp / f"{name}.json"
    log = open(tmp / f"{name}.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, str(script), json.dumps(FULL), json.dumps(COMPILED),
         str(out)], env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, out, log


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's results, the port's), keyed ``arch__shape__mesh``."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    runs = [_start(JAX_CODE, tmp, "side_jax", dict(
                env, XLA_FLAGS="--xla_force_host_platform_device_count=512")),
            _start(PORT_CODE, tmp, "side_port", env)]
    results = []
    try:
        for proc, out, log in runs:
            proc.wait(timeout=600)
            log.seek(0)
            assert proc.returncode == 0, log.read()[-4000:]
            results.append(json.loads(out.read_text()))
    finally:
        for proc, _, log in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return tuple(results)


def _key(case) -> str:
    return "__".join(case)


@pytest.mark.parametrize("case", FULL, ids=_key)
def test_every_argument_placed_as_jax_places_it(sides, case):
    """Each parameter, batch input and cache leaf: the PartitionSpec its
    DTensor placements realise and its rank-0 shard shape, equal to JAX's
    ``sharding.spec`` and ``sharding.shard_shape``."""
    jax_side, port_side = sides
    want = jax_side[_key(case)]["layout"]
    got = port_side[_key(case)]["layout"]
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad
    assert port_side[_key(case)]["moments_placed_as_params"]


@pytest.mark.parametrize("case", FULL, ids=_key)
def test_accounting_equals_jax(sides, case):
    jax_side, port_side = sides
    j, p = jax_side[_key(case)], port_side[_key(case)]
    assert p["params"] == j["params"]
    assert p["analytic"] == j["analytic"]
    assert p["model_flops"] == j["model_flops"]


@pytest.mark.parametrize("case", COMPILED, ids=_key)
def test_traced_step_matches_jax_compiled(sides, case):
    """A reduced case traced on meta DTensors: each argument's bytes on
    this rank summed equal to XLA's ``argument_size_in_bytes``, and the
    step's outputs (a training step's metrics, a prefill or decode step's
    logits) shaped and typed as ``jax.eval_shape`` gives them.  The
    collectives are printed beside the HLO's, not held to them."""
    jax_side, port_side = sides
    k = _key(case + ("pod1",))
    j, p = jax_side[k], port_side[k]
    print(f"{k}: collective bytes a rank, port {p['collective_bytes']}, "
          f"JAX's HLO {j['collective_bytes']}")
    assert p["argument_bytes"] == j["argument_bytes"]
    assert p["memory_analysis"] == {
        "argument_size_in_bytes": j["argument_bytes"]}
    want = {"metrics": j["outputs"]} if "train" in k else j["outputs"]
    assert p["outputs"] == want
    assert p["cost_analysis_hlo"] is None
    r = p["roofline"]
    assert r["t_collective_s"] > 0 and r["collective_bytes"] == \
        p["collective_bytes"]
    assert r["t_collective_s"] == analysis.ici_seconds(p["collective_bytes"])


# ---------------------------------------------------------------------------
# The grid-step twin on JAX's own cases
# ---------------------------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("T,chunk", [(24, 8), (23, 8), (24, 4)])
def test_rwkv_grid_steps_equal_jax(T, chunk):
    """tests/test_plan_equivalence.py's sweep: BH * ceil(T/C) forward grid
    steps through the kernel plan, twice that for a gradient."""
    B, H = 2, 2
    case = jax_plans.Case(f"T{T}c{chunk}", (B, T, H, 8, 8, chunk))
    args, _ = jax_plans.get_family("rwkv6").make_inputs(case, "float32")
    jfn = jax_plans.RWKV_PLANS["chunked_scan"]

    def jloss(*a):
        out, s = jfn(*a, chunk=chunk)
        return jnp.sum(out.astype(jnp.float32)) + jnp.sum(s)
    want_fwd = jax_analysis.count_pallas_grid_steps(
        jax.make_jaxpr(lambda *a: jfn(*a, chunk=chunk))(*args))
    want_train = jax_analysis.count_pallas_grid_steps(
        jax.make_jaxpr(jax.value_and_grad(jloss, argnums=(0,)))(*args))
    assert want_fwd == B * H * math.ceil(T / chunk)

    targs = [_t(a) for a in args]
    fn = plans.RWKV_PLANS["chunked_scan"]
    got_fwd = analysis.count_pallas_grid_steps(fn, *targs, chunk=chunk)
    r = targs[0].clone().requires_grad_()

    def step():
        out, s = fn(r, *targs[1:], chunk=chunk)
        torch.autograd.grad(out.float().sum() + s.sum(), [r])
    got_train = analysis.count_pallas_grid_steps(step)
    assert (got_fwd, got_train) == (want_fwd, want_train)


def test_mamba_grid_steps_equal_jax():
    """tests/test_mamba_scan.py's grid: (ceil(B/bm), ceil(T/C))."""
    key = jax.random.split(jax.random.PRNGKey(0), 6)
    B, T, di, ds = 3, 61, 16, 4
    args = (jax.random.normal(key[0], (B, T, di)),
            jax.nn.softplus(jax.random.normal(key[1], (B, T, di))),
            jax.random.normal(key[2], (B, T, ds)),
            jax.random.normal(key[3], (B, T, ds)),
            -jnp.exp(jax.random.normal(key[4], (di, ds))),
            jax.random.normal(key[5], (B, di, ds)) * 0.3)
    want = jax_analysis.count_pallas_grid_steps(jax.make_jaxpr(
        lambda *a: jax_ms.mamba_scan(*a, chunk=8, block_b=2))(*args))
    got = analysis.count_pallas_grid_steps(
        ms.mamba_scan, *(_t(a) for a in args), chunk=8, block_b=2)
    assert got == want == 2 * 8


def test_ici_seconds_rings_as_jax():
    """JAX's ring multipliers at 16 shards, priced at the port's own rate
    (one NDR port a GPU: a 16-way ring leaves the node), and at NVLink
    within a node of 8."""
    coll = {"all-gather": 1 << 20, "reduce-scatter": 3 << 20,
            "all-reduce": 5 << 20, "all-to-all": 7 << 20,
            "collective-permute": 11 << 20}
    ring = jax_analysis.ici_seconds(coll) * jax_analysis.ICI_BW
    assert analysis.ici_seconds(coll) * analysis.NDR_BYTES_PER_S == \
        pytest.approx(ring, rel=1e-12)
    f8 = 7 / 8
    want8 = (f8 * (1 + 3 + 2 * 5 + 7 / 2) + 11) * (1 << 20)
    assert analysis.ici_seconds(coll, 8) * analysis.NVLINK_BYTES_PER_S == \
        pytest.approx(want8, rel=1e-12)
    roof = analysis.Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes=coll)
    assert roof.t_collective == analysis.ici_seconds(coll)
    assert roof.dominant == "collective"
    assert roof.to_dict()["collective_bytes"] == coll
