"""The K8b variant tool (``python -m repro_torch.obs.variants``) on the CPU:
each variant's replacements still match ``csrc/flash_prefill_bwd.cu``
exactly once, so that the tool builds what it says.  Building, holding
and timing the variants needs the card."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import variants  # noqa: E402


@pytest.mark.parametrize("name", list(variants.VARIANTS))
def test_each_variant_patches_the_source_where_it_says(name):
    src = (_build.CSRC / "flash_prefill_bwd.cu").read_text()
    out = variants.patched(name)
    for old, new in variants.VARIANTS[name]:
        assert src.count(old) == 1
        assert out.count(new) == 1 and old not in out
    if not variants.VARIANTS[name]:
        assert out == src


def test_it_needs_the_card():
    with pytest.raises(SystemExit, match="no CUDA device"):
        variants.main([])
