"""The port's checkpoints (``repro_torch.checkpoint``) and the trainer's
``--ckpt-dir``/``--ckpt-every`` on the CPU, against the JAX package's
``checkpoint/ckpt.py``: the same file names and npz keys, bf16 leaves as
their raw 2-byte bits, files crossing both ways."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint import ckpt as jax_ckpt  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.mobirnn_lstm import LSTMConfig as JaxConfig  # noqa: E402
from repro.core import lstm as jax_lstm  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.partitioning import split  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train as train_lm  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(width[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def _trees_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(_bits_equal(x, y)
                                      for x, y in zip(la, lb))


def _tree(gen):
    return {"w": torch.randn(3, 4, generator=gen),
            "blocks": [{"a": torch.randn(2, generator=gen).to(torch.bfloat16),
                        "n": torch.arange(5, dtype=torch.int32)},
                       {"a": torch.randn(2, generator=gen).to(torch.bfloat16),
                        "n": torch.arange(3, dtype=torch.int64)}],
            "flag": torch.tensor([True, False])}


def test_round_trip_of_f32_bf16_and_int_leaves(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = _tree(gen)
    tree["w"][0, 0] = float("nan")
    tree["blocks"][0]["a"][1] = -0.0
    d = str(tmp_path)
    path = ckpt.save(d, 7, tree, {"arch": "toy"})
    assert os.path.basename(path) == "ckpt_00000007.npz"
    assert json.load(open(os.path.join(d, "ckpt_00000007.json"))) == \
        {"step": 7, "arch": "toy"}
    assert sorted(os.listdir(d)) == ["ckpt_00000007.json",
                                     "ckpt_00000007.npz"]
    template = tree_map(torch.zeros_like, tree)
    got = ckpt.restore(d, template)
    assert _trees_equal(got, tree)
    assert isinstance(got["blocks"], list)
    with np.load(path) as data:
        assert sorted(data.files) == ["blocks/0/a", "blocks/0/n",
                                      "blocks/1/a", "blocks/1/n", "flag",
                                      "w"]
        raw = data["blocks/0/a"]
        assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
        np.testing.assert_array_equal(
            raw.view(np.int16), tree["blocks"][0]["a"].view(torch.int16))


def test_restore_takes_the_templates_dtype_and_the_latest_step(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, {"w": torch.zeros(2)})
    ckpt.save(d, 2, {"w": torch.tensor([1.5, -2.0])})
    ckpt.save(d, 10, {"w": torch.tensor([3.0, 4.0])})
    assert ckpt.latest_step(d) == 10
    got = ckpt.restore(d, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].tolist() == [3.0, 4.0]
    assert ckpt.restore(d, {"w": torch.zeros(2)}, step=2)["w"].tolist() == \
        [1.5, -2.0]


def test_missing_leaf_and_shape_mismatch_raise_as_jax(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"a": torch.zeros(2, 3), "blocks": [torch.zeros(4)]})
    with pytest.raises(KeyError, match="checkpoint missing leaf b"):
        ckpt.restore(d, {"a": torch.zeros(2, 3), "b": torch.zeros(1)})
    with pytest.raises(ValueError,
                       match=r"shape mismatch at blocks/0: ckpt \(4,\) vs "
                             r"template \(5,\)"):
        ckpt.restore(d, {"a": torch.zeros(2, 3), "blocks": [torch.zeros(5)]})


def _jax_qwen_bf16():
    jcfg = dataclasses.replace(jax_get_arch("qwen2-0.5b-reduced"),
                               dtype="bfloat16")
    plain, _ = split(jax_registry.build(jcfg).init(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(get_arch("qwen2-0.5b-reduced"),
                              dtype="bfloat16")
    return plain, cfg


def _jax_lstm_f32():
    jparams = jax_lstm.init_params(jax.random.PRNGKey(1), JaxConfig())
    plain, _ = split(jparams)
    return plain


def test_jax_checkpoints_restore_in_the_port_bit_for_bit(tmp_path):
    """JAX's ``ckpt.save`` of the reduced Qwen2 in bf16 and of the f32 LSTM
    restores in the port bit-equal to ``convert.params_from_numpy`` of the
    same trees (JAX's own ``restore`` cannot cast the bf16 leaves back)."""
    plain, cfg = _jax_qwen_bf16()
    d = str(tmp_path / "qwen")
    jax_ckpt.save(d, 3, plain, {"arch": cfg.name})
    template = registry.build(cfg).init(torch.Generator().manual_seed(5))
    want = convert.params_from_numpy(jax.tree.map(np.asarray, plain))
    got = ckpt.restore(d, template)
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(got))
    assert _trees_equal(got, want)
    with pytest.raises(ValueError, match="No cast function"):
        jax_ckpt.restore(d, plain)

    lstm_plain = _jax_lstm_f32()
    d = str(tmp_path / "lstm")
    jax_ckpt.save(d, 1, lstm_plain)
    want = convert.params_from_numpy(jax.tree.map(np.asarray, lstm_plain))
    got = ckpt.restore(d, tree_map(torch.zeros_like, want))
    assert _trees_equal(got, want)


def test_port_f32_checkpoint_restores_through_jax(tmp_path):
    lstm_plain = _jax_lstm_f32()
    params = convert.params_from_numpy(jax.tree.map(np.asarray, lstm_plain))
    params["layers"][0]["w"] = params["layers"][0]["w"] * 3.0 + 1.0
    d = str(tmp_path)
    ckpt.save(d, 4, params)
    got = jax_ckpt.restore(d, lstm_plain)
    want = convert.params_to_numpy(params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


def test_both_packages_write_identical_keys_and_bf16_bytes(tmp_path):
    plain, _ = _jax_qwen_bf16()
    jax_ckpt.save(str(tmp_path / "jax"), 1, plain)
    ckpt.save(str(tmp_path / "port"), 1, convert.params_from_numpy(
        jax.tree.map(np.asarray, plain)))
    name = "ckpt_00000001.npz"
    with np.load(tmp_path / "jax" / name) as theirs, \
            np.load(tmp_path / "port" / name) as mine:
        assert sorted(theirs.files) == sorted(mine.files)
        assert any(k.startswith("blocks/0/") for k in mine.files)
        n_bf16 = 0
        for key in mine.files:
            a, b = theirs[key], mine[key]
            assert a.shape == b.shape and a.dtype.itemsize == \
                b.dtype.itemsize, key
            assert a.tobytes() == b.tobytes(), key
            n_bf16 += b.dtype.kind == "V"
        assert n_bf16 > 0


def test_train_entry_point_saves_every_ckpt_every_steps(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    report = train_lm.main(["--device", "cpu", "--reduced", "--arch",
                            "qwen2-0.5b", "--steps", "4", "--batch", "2",
                            "--seq", "16", "--ckpt-every", "2",
                            "--ckpt-dir", d])
    assert sorted(os.listdir(d)) == [
        "ckpt_00000002.json", "ckpt_00000002.npz", "ckpt_00000004.json",
        "ckpt_00000004.npz"]
    assert json.load(open(os.path.join(d, "ckpt_00000004.json"))) == \
        {"step": 4, "arch": "qwen2-0.5b-reduced"}
    params = report["params"]
    template = tree_map(lambda p: torch.zeros_like(p.detach()), params)
    got = ckpt.restore(d, template)
    assert _trees_equal(got, tree_map(lambda p: p.detach(), params))
    step2 = ckpt.restore(d, template, step=2)
    assert not _trees_equal(step2, got)
    assert "loss " in capsys.readouterr().out
