"""The port stands alone: no module of ``src/repro_torch`` and no line of
``chip_smoke.py`` imports jax, jaxlib or the JAX package ``repro``, and
every kernel is a CUDA source of the port built with a plain C interface."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
            "configs/qwen2_0_5b.py", "configs/yi_9b.py"} <= names
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
