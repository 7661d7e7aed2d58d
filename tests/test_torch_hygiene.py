"""The port stands alone: no module of ``src/repro_torch``, no line of
``chip_smoke.py`` and no ``examples/*_torch.py`` imports jax, jaxlib or the
JAX package ``repro``, and
every kernel is a CUDA source of the port built with a plain C interface."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_repro_imports(path):
    bad = [n for n in _imported_modules(path)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_the_whole_port():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    assert {"core/lstm.py", "kernels/lstm_cell.py", "kernels/lstm_seq.py",
            "launch/classify.py", "models/rwkv.py", "kernels/wkv6.py",
            "serving/engine.py", "launch/serve.py", "launch/train.py",
            "data/lm.py", "steps.py", "optim/adamw.py",
            "kernels/mamba_scan.py", "models/mamba.py", "models/mlp.py",
            "configs/jamba_1_5_large_398b.py", "kernels/flash_prefill.py",
            "kernels/decode_attn.py", "models/attention.py",
            "configs/qwen2_0_5b.py", "configs/yi_9b.py", "models/moe.py",
            "configs/olmoe_1b_7b.py", "configs/qwen3_moe_30b_a3b.py",
            "configs/internvl2_1b.py", "configs/musicgen_large.py",
            "models/registry.py", "partitioning.py", "launch/mesh.py",
            "core/factorization.py", "launch/dryrun.py"} <= names
    assert ROOT / "examples" / "dryrun_one_torch.py" in FILES
    assert _imported_modules(ROOT / "tests" / "test_torch_plans.py").count(
        "repro.partitioning") == 1    # the scanner does see such imports


def test_kernels_are_cuda_sources_with_a_c_interface():
    from repro_torch.kernels import _build
    assert {"mamba_scan", "mamba_scan_bwd", "flash_prefill",
            "decode_attn"} <= set(_build.SOURCES)
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text(encoding="utf-8")
        assert 'extern "C"' in src and f"{name}_error_string" in src
        assert "torch/extension.h" not in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_directory_is_ignored_by_git():
    from repro_torch.kernels import _build
    lines = (ROOT / ".gitignore").read_text(encoding="utf-8").splitlines()
    assert f"{_build.BUILD_DIR.name}/" in lines
    assert _build.BUILD_DIR.parent == ROOT


@pytest.mark.parametrize("name", ["analysis.py", "obs/profile.py",
                                  "obs/trace.py", "checkpoint/__init__.py",
                                  "checkpoint/ckpt.py", "core/plans.py",
                                  "core/scheduler.py", "core/tiling.py"])
def test_the_analysis_half_is_scanned_and_stands_alone(name):
    """The modules of the analysis and profiler half are among the files
    the scan reads, and import neither jax nor the JAX package."""
    path = PORT / name
    assert path in FILES
    assert not [n for n in _imported_modules(path)
                if n.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("name", ["partitioning.py", "launch/mesh.py",
                                  "core/factorization.py"])
def test_the_partitioning_half_is_scanned_and_stands_alone(name):
    """The cost model, the partitioning rules and the meshes are among the
    files the scan reads, and import neither jax nor the JAX package."""
    path = PORT / name
    assert path in FILES
    assert not [n for n in _imported_modules(path)
                if n.split(".")[0] in FORBIDDEN]


def _process_group_calls(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    return [f"{path.relative_to(ROOT)}:{node.lineno}"
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", ""))
            == "init_process_group"]


def test_nothing_starts_a_process_group():
    """No import starts a process group, and of the port's modules and
    examples only two entry points call ``init_process_group``: the dry
    run (``launch/dryrun.start_group``: a ``fake`` group in one process,
    which sends nothing) and the trainer (``launch/train._join_group``:
    the group ``torchrun``'s environment describes, only when it names
    several ranks).  Any other mesh of more than one device runs over a
    group its caller starts (a test, ``chip_smoke.py``'s D2 and D3).
    ``chip_smoke.py`` starts them."""
    calls = {path.relative_to(ROOT).as_posix() for path in FILES
             if path != ROOT / "chip_smoke.py"
             and _process_group_calls(path)}
    assert calls == {"src/repro_torch/launch/dryrun.py",
                     "src/repro_torch/launch/train.py"}, calls
    assert _process_group_calls(ROOT / "chip_smoke.py")
