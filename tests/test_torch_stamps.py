"""The phase-stamp tool (``python -m repro_torch.obs.stamps``) on the CPU:
how it instruments each kernel source it stamps.  Building and running the
stamped copies needs the card."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import stamps  # noqa: E402


@pytest.mark.parametrize("name", ["lstm_cell", "decode_attn", "wkv6",
                                  "wkv6_bwd", "mamba_scan", "mamba_scan_bwd",
                                  "lstm_seq_bwd"])
def test_a_stamp_after_each_barrier_and_at_each_kernel_end(name):
    text = (_build.CSRC / f"{name}.cu").read_text()
    out, sites = stamps.instrument(text)
    lines = out.splitlines()
    kernels = text.count("__global__")
    # the barriers inside a __global__ body (a __device__ helper's are not
    # stamped: its callers' phases cover them)
    barriers, depth, inside = [], 0, False
    for n, line in enumerate(text.splitlines(), 1):
        if "__global__" in line:
            inside, depth = True, None
        if inside:
            if depth is None and "{" in line:
                depth = 0
            if depth is not None:
                depth += line.count("{") - line.count("}")
                if stamps.is_barrier(line):
                    barriers.append(n)
                if depth == 0:
                    inside = False
    ends = [s for s in sites if s[1] == "end of kernel"]
    assert len(ends) == kernels
    assert [s[0] for s in sites if s[1] != "end of kernel"] == barriers
    assert len(sites) <= stamps.MAX_SITES
    # each site's stamp is in the source once, in order, right after its
    # barrier (or right before the body's closing brace)
    at = [i for i, line in enumerate(lines) if line.startswith("PHASE_STAMP(")]
    assert [lines[i] for i in at] == [f"PHASE_STAMP({k});"
                                      for k in range(len(sites))]
    for i, (_, label) in zip(at, sites):
        if label == "end of kernel":
            assert lines[i + 1].startswith("}")
        else:
            assert stamps.is_barrier(lines[i - 1])
    assert out.count("long long stamp_prev_ = clock64();") == kernels
    assert "stamps_read" in out and "g_hits" in out


def test_every_kernel_the_tool_stamps_has_a_main_path_shape():
    assert set(stamps.KERNELS) == {"wkv6", "lstm_cell", "decode_attn",
                                   "mamba_scan", "mamba_scan_bwd",
                                   "lstm_seq_bwd"}
    assert stamps.SOURCES["mamba_scan_bwd"] == ("mamba_scan",
                                                "mamba_scan_bwd")
    # the forward's choice stamps its own source alone: no K7b build
    assert "mamba_scan" not in stamps.SOURCES
    assert stamps.MAMBA_SHAPE == (4, 512, 16384, 16)
    assert stamps.LSTM_BWD_SHAPE == (64, 128, 2, 32)
    assert all(len(s) == 3 for s in stamps.CELL_SHAPES)
    assert [s[0] for s in stamps.DECODE_SHAPES] == ["qwen2-0.5b", "yi-9b"]
