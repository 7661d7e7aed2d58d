"""Logical-axis partitioning (``partitioning.py``) and meshes
(``launch/mesh.py``) against the JAX package: the cases of its
tests/test_partitioning.py on the port, the annotated initialisers' axes
for every architecture leaf for leaf, the specs at full width on the 1 x
1, (16, 16) and (2, 16, 16) meshes, DTensor placements, ``constrain`` on
one device and beyond it, and the trainer inside ``use_rules``."""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro import partitioning as jpt  # noqa: E402
from repro import steps as jax_steps  # noqa: E402
from repro.core import lstm as jax_lstm  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import partitioning as pt  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.configs.mobirnn_lstm import CONFIG as LSTM  # noqa: E402
from repro_torch.core import lstm  # noqa: E402
from repro_torch.data.lm import SyntheticLM  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import train as train_lm  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

P = pt.PartitionSpec
NAMES = sorted(ARCHS)


def _fake_mesh(data=16, model=16, pod=None):
    """Mesh object with arbitrary logical sizes for rule resolution tests
    (never used to place data) — the JAX test's stand-in, unchanged."""
    class FakeMesh:
        def __init__(self):
            names = (("pod", "data", "model") if pod else ("data", "model"))
            sizes = ((pod, data, model) if pod else (data, model))
            self.shape = dict(zip(names, sizes))
    return FakeMesh()


def rules(**kw):
    return pt.AxisRules(rules=pt.DEFAULT_RULES, mesh=_fake_mesh(**kw))


# --- tests/test_partitioning.py on the port --------------------------------
def test_basic_resolution():
    r = rules()
    assert r.spec_for(("embed", "mlp"), (1024, 4096)) == P("data", "model")
    assert r.spec_for(("batch", "seq"), (256, 4096)) == P("data")


def test_divisibility_fallback():
    r = rules()
    # 14 heads cannot shard over a 16-way model axis -> replicated
    assert r.spec_for(("embed", "heads", None), (896, 14, 64)) == P("data")
    # but d_ff = 4864 = 16*304 still shards
    assert r.spec_for(("embed", "mlp"), (896, 4864)) == P("data", "model")


def test_multi_axis_batch():
    r = rules(pod=2)
    assert r.spec_for(("batch", "seq"), (256, 128)) == P(("pod", "data"))
    # batch=1 (long_500k): falls back to replicated
    assert r.spec_for(("batch", "seq"), (1, 128)) == P()


def test_no_double_use_of_mesh_axis():
    r = rules()
    spec = r.spec_for(("layers", "batch", "cache_seq", "kv_heads", None),
                      (4, 128, 32768, 16, 128))
    assert spec == P(None, "data", "model")


def test_partial_multi_axis_divisibility():
    r = rules(pod=2)
    assert r.spec_for(("batch",), (32,)) == P(("pod", "data"))
    assert r.spec_for(("batch",), (16,)) == P("pod")


def test_constrain_is_noop_outside_context():
    x = torch.ones(4, 4)
    assert pt.constrain(x, ("batch", None)) is x


def test_annot_roundtrip_through_the_meta_device():
    def init(device):
        return {"w": pt.Annot(torch.zeros((4, 8), device=device),
                              ("embed", "mlp"))}

    vals, axes = pt.split(init("meta"))
    assert vals["w"].shape == (4, 8) and vals["w"].is_meta
    assert axes["w"] == ("embed", "mlp")


def test_annot_rank_mismatch_raises():
    with pytest.raises(ValueError):
        pt.Annot(torch.zeros((4, 8)), ("embed",))


@pytest.mark.parametrize("parts", [("data", "model"), ("data", None),
                                   (("pod", "data"),), (("data",), None),
                                   ([("model")], "data"), (None,), ()])
def test_partition_spec_equals_jax_as_a_tuple(parts):
    assert tuple(P(*parts)) == tuple(JP(*parts))


@pytest.mark.parametrize("pod", [None, 2])
@pytest.mark.parametrize("axes,shape", [
    (("embed", "mlp"), (896, 4864)), (("batch", "seq"), (256, 4096)),
    (("batch", "seq"), (16, 4096)), (("embed", "heads", None), (896, 14, 64)),
    (("layers", "batch", "cache_seq", "kv_heads", None),
     (4, 128, 32768, 16, 128)), (("vocab", "embed"), (151936, 896)),
    (("experts", None, "mlp"), (64, 2048, 1024)), ((), ())])
def test_spec_for_equals_jax(pod, axes, shape):
    mine = rules(pod=pod).spec_for(axes, shape)
    theirs = jpt.AxisRules(rules=jpt.DEFAULT_RULES,
                           mesh=_fake_mesh(pod=pod)).spec_for(axes, shape)
    assert tuple(mine) == tuple(theirs)


# --- placements, constrain and meshes --------------------------------------
def test_placements_of_a_multi_axis_batch_on_a_pod_mesh():
    from torch.distributed.tensor import Replicate, Shard
    r = rules(pod=2)
    batch = r.sharding_for(("batch", "seq", None), (256, 128, 896))
    assert batch.spec == P(("pod", "data"))
    assert batch.placements() == [Shard(0), Shard(0), Replicate()]
    w = r.sharding_for(("embed", "mlp"), (1024, 4096))
    assert w.placements() == [Replicate(), Shard(0), Shard(1)]
    assert r.sharding_for(("batch",), (1,)).placements() == [Replicate()] * 3


def test_constrain_is_the_identity_on_one_device():
    mesh = mesh_lib.make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    x = torch.randn(2, 3, 4)
    with pt.use_rules(pt.make_rules(mesh)) as r:
        assert pt.constrain(x, ("batch", "seq", None)) is x
        assert r.spec_for(("batch", "seq", None), x.shape) == P("data")
        with pytest.raises(ValueError, match="rank"):
            pt.constrain(x, ("batch", None))
    assert not pt._ACTIVE_RULES


@pytest.mark.parametrize("kw", [dict(data=2, model=1), dict(data=16, model=16),
                                dict(pod=2)])
def test_constrain_raises_beyond_one_device(kw):
    """Outside a process group: a plain tensor is refused by ``constrain``
    (it must not stay replicated), and ``device_put`` finds no
    DeviceMesh to place on.  tests/test_torch_collectives.py places and
    constrains DTensors inside one."""
    x = torch.ones(4, 4)
    with pt.use_rules(rules(**kw)):
        with pytest.raises(TypeError, match="plain Tensor on a mesh of"):
            pt.constrain(x, ("batch", None))
    shardings = pt.tree_shardings({"x": ("batch", None)}, {"x": x},
                                  rules(**kw))
    with pytest.raises(RuntimeError, match="holds no DeviceMesh"):
        pt.device_put({"x": x}, shardings)


def test_production_meshes():
    with pytest.raises(AssertionError):
        mesh_lib.make_production_mesh(data=16, model=8)
    with pytest.raises(RuntimeError, match=r"needs 256 devices, found 1"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match=r"needs 512 devices"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
    m = mesh_lib.abstract_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.devices is None
    m = mesh_lib.abstract_production_mesh(multi_pod=True, data=32, model=8)
    assert m.shape == {"pod": 2, "data": 32, "model": 8} and m.size == 512


# --- axes trees, leaf for leaf ---------------------------------------------
def _lists(tree):
    """A tree with its containers as dicts and lists; an axes tuple (of
    names and Nones, ``()`` too) or a PartitionSpec (either package's) as
    a tuple leaf."""
    if isinstance(tree, (JP, P)):
        return ("spec",) + tuple(tree)
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and all(isinstance(e, (str, type(None)))
                                       for e in tree):
        return tree
    if isinstance(tree, (list, tuple)):
        return [_lists(v) for v in tree]
    return tree


@pytest.mark.parametrize("name", NAMES)
def test_param_axes_equal_jax(name):
    cfg = get_arch(name + "-reduced")
    mine = pt.split(registry.build(cfg).init_annot(
        torch.Generator().manual_seed(0)))[1]
    theirs = jpt.split(jax_registry.build(jax_configs.get_arch(
        name + "-reduced")).init(jax.random.PRNGKey(0)))[1]
    assert _lists(mine) == _lists(theirs)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_cache_axes_equal_jax(name, quant):
    kw = dict(dtype="bfloat16", kv_quant=quant)
    cfg = dataclasses.replace(get_arch(name + "-reduced"), **kw)
    jcfg = dataclasses.replace(jax_configs.get_arch(name + "-reduced"), **kw)
    mine = pt.split(transformer.init_cache_annot(cfg, 2, 16))
    theirs = jpt.split(jax_transformer.init_cache(jcfg, 2, 16))
    assert _lists(mine[1]) == _lists(theirs[1])
    for m, t in zip(tree_leaves(mine[0]), jax.tree.leaves(theirs[0])):
        assert tuple(m.shape) == t.shape and str(m.dtype) == f"torch.{t.dtype}"
    lane = pt.split(transformer.init_cache_annot(cfg, 2, 16,
                                                 per_lane_pos=True))
    assert lane[1]["pos"] == ("batch",) and lane[0]["pos"].shape == (2,)


def test_plain_entry_points_are_the_annotated_draw():
    cfg = get_arch("qwen2-0.5b-reduced")
    model = registry.build(cfg)
    plain = model.init(torch.Generator().manual_seed(3))
    annot = pt.split(model.init_annot(torch.Generator().manual_seed(3)))[0]
    pairs = list(zip(tree_leaves(plain), tree_leaves(annot)))
    assert len(pairs) == len(tree_leaves(plain))
    assert all(torch.equal(a, b) for a, b in pairs)
    cache = model.init_cache(2, 8, per_lane_pos=True)
    assert cache["pos"].shape == (2,) and not any(
        t.any() for t in tree_leaves(cache))


def test_lstm_axes_equal_jax():
    mine = lstm.init_params_annot(torch.Generator().manual_seed(0), LSTM)
    theirs = jax_lstm.init_params(jax.random.PRNGKey(0),
                                  jax_configs.MOBIRNN_LSTM)
    assert _lists(pt.split(mine)[1]) == _lists(jpt.split(theirs)[1])
    plain = lstm.init_params(torch.Generator().manual_seed(0), LSTM)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(plain), tree_leaves(pt.split(mine)[0])))


# --- full width: abstract trees and their specs ----------------------------
MESHES = {"1x1": dict(data=1, model=1), "16x16": dict(),
          "2x16x16": dict(pod=2)}


@pytest.mark.parametrize("name", NAMES)
def test_full_width_specs_equal_jax(name):
    """Jamba-1.5-Large (398 B) and Command-R-35B included: meta tensors,
    nothing allocated or drawn."""
    model = registry.build(name)
    jmodel = jax_registry.build(name)
    trees = {"params": (model.abstract_params(), jmodel.abstract_params()),
             "cache": (model.abstract_cache(128, 32768),
                       jmodel.abstract_cache(128, 32768))}
    for what, ((vals, axes), (jvals, jaxes)) in trees.items():
        assert all(t.is_meta for t in tree_leaves(vals))
        assert _lists(axes) == _lists(jaxes), what
        for label, kw in MESHES.items():
            mine = pt.tree_specs(axes, vals, rules(**kw))
            theirs = jpt.tree_specs(jaxes, jvals, jpt.AxisRules(
                rules=jpt.DEFAULT_RULES, mesh=_fake_mesh(**kw)))
            assert _lists(mine) == _lists(theirs), (what, label)
    host = pt.make_rules(mesh_lib.make_host_mesh(device="cpu"))
    vals, axes = trees["params"][0]
    shardings = pt.tree_shardings(axes, vals, host)
    assert all(s.mesh.size == 1 for s in jax.tree.leaves(
        shardings, is_leaf=lambda s: isinstance(s, pt.NamedSharding)))
    assert pt.param_count(vals) == sum(
        int(np.prod(v.shape)) for v in jax.tree.leaves(trees["params"][1][0]))
    assert pt.bytes_of(vals) == jpt.bytes_of(trees["params"][1][0])


# --- the trainer inside use_rules ------------------------------------------
def test_train_main_runs_inside_the_rules_on_the_host_mesh(capsys,
                                                           monkeypatch):
    argv = ["--device", "cpu", "--arch", "rwkv6-3b", "--reduced",
            "--steps", "2", "--batch", "2",
            "--seq", "24", "--log-every", "1"]
    report = train_lm.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("arch=rwkv6-3b-reduced params=")
    assert f"params={report['n_params']:,} mesh={{'data': 1, 'model': 1}} " \
           "device=cpu" in out[0]
    cfg = get_arch("rwkv6-3b-reduced")
    entered = []
    monkeypatch.setattr(train_lm, "use_rules",
                        lambda rules: entered.append(rules) or
                        contextlib.nullcontext())
    outside = train_lm.train(cfg, steps=2, batch=2, seq=24, device="cpu")
    assert [r.mesh.shape for r in entered] == [{"data": 1, "model": 1}]
    assert report["losses"] == outside["losses"]
    assert report["grad_norms"] == outside["grad_norms"]

    # the JAX trainer's step on the same drawn weights and tokens
    jcfg = jax_configs.get_arch("rwkv6-3b-reduced")
    drawn = registry.build(cfg).init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, convert.params_to_numpy(drawn))
    jopt = JaxAdamW(lr=jax_warmup_cosine(3e-3, 0, 2))
    jstate = jopt.init(jparams)
    it = SyntheticLM(cfg.vocab, seed=0).batches(2, 24)
    for step in range(2):
        toks = next(it)["tokens"]
        jparams, jstate, m = jax_steps.train_step(
            jopt, jcfg, jparams, jstate, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(report["losses"][step], float(m["loss"]),
                                   rtol=1e-4, atol=0)
        np.testing.assert_allclose(report["grad_norms"][step],
                                   float(m["grad_norm"]), rtol=1e-3, atol=0)
