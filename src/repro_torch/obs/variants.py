"""Variants of K8b's tensor-core kernels side by side on the card: the block
shapes and tilings that ``csrc/flash_prefill_bwd.cu`` chose between, each a
patched copy of the source, held against the plain version and timed in
turns, so that a choice can be measured again.

    PYTHONPATH=src python -m repro_torch.obs.variants [--rounds 3]

Each variant of ``VARIANTS`` is the source with a few lines replaced (a
replacement must match the source exactly once), built with
``kernels/_build.py``'s nvcc flags into ``build/variants/<variant>/`` and
installed in place of the real ``flash_prefill_bwd`` library; the budget
table prices each variant's ring depth (``STAGES``).  Printed: ptxas's
registers and spills of each variant's tensor-core instances; for each
round (the variants' order alternating), each variant's largest error
against ``flash_prefill_bwd_plain(round_p=True)`` over max|grad| at every
shape of ``SHAPES`` and ``HELD``, whether two runs gave the same bits, and
its device time a call in a CUDA graph at each shape of ``SHAPES`` (bf16,
random inputs from seed 0); the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_prefill as fp
from repro_torch.obs import stamps

#: variant -> (source line, its replacement) pairs
VARIANTS = {
    "as built": (),
    # dh 128's dK/dV as two warpgroups sharing 64 keys, one summing dv and
    # the other dk (nine warps: 168 registers a thread)
    "split at 128": ((
        "constexpr bool tc_dkv_split(int dhp) { return dhp > 128; }",
        "constexpr bool tc_dkv_split(int dhp) { return dhp >= 128; }"),),
    # three dQ blocks an SM at padded width 64 (128 registers a thread)
    "dQ 3 blocks at 64": ((
        "  return 2 * (tc_smem_bytes(true, dhp) + 1024) <= 233472 ? 2 : 1;",
        "  return dhp == 64 ? 3\n"
        "                   : 2 * (tc_smem_bytes(true, dhp) + 1024) <= "
        "233472 ? 2 : 1;"),),
    "3 stages": (("constexpr int kTcStages = 2;",
                  "constexpr int kTcStages = 3;"),),
}
#: the streamed tiles of each variant's ring (``BWD_TC_STAGES`` otherwise)
STAGES = {"3 stages": 3}
#: timed and held: (B, S, Hq, Hkv, dh, window), the training heads of
#: Qwen2-0.5B, OLMoE-1B-7B and Yi-9B
SHAPES = {"qwen2-0.5b": (4, 512, 14, 2, 64, 0),
          "olmoe-1b-7b": (4, 512, 16, 16, 128, 0),
          "yi-9b": (4, 512, 32, 4, 128, 0)}
#: held only: a ragged S with a window, and dh 160 (the split instance)
HELD = {"ragged, window": (2, 300, 8, 2, 64, 40),
        "dh 160": (1, 200, 4, 2, 160, 0)}
SEED = 0


def patched(name: str) -> str:
    """``csrc/flash_prefill_bwd.cu`` with variant ``name``'s replacements."""
    text = (_build.CSRC / "flash_prefill_bwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in the "
                               "source exactly once")
        text = text.replace(old, new)
    return text


def build() -> dict[str, ctypes.CDLL]:
    """Every variant built at once, one nvcc each; prints ptxas's registers
    and spills of their tensor-core instances."""
    procs = {}
    for name in VARIANTS:
        d = _build.BUILD_DIR / "variants" / re.sub(r"\W+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_prefill_bwd.cu").write_text(patched(name))
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        so = d / "flash_prefill_bwd.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-o",
               str(so), str(d / "flash_prefill_bwd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        entry = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "_tc" in entry and ("registers" in line or "spill" in line):
                kernel = re.search(r"(flash_prefill_bwd_d\w*_tc)ILi(\d+)E",
                                   entry)
                print(f"[build] {name}: {kernel.group(1)}<{kernel.group(2)}>"
                      f": {line.strip()}")
        lib = ctypes.CDLL(str(so))
        lib.flash_prefill_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_prefill_bwd_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("variants: no CUDA device")
    libs = build()
    gen = torch.Generator().manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)

    cases = {}
    for label, (B, S, Hq, Hkv, dh, w) in {**SHAPES, **HELD}.items():
        q, k, v = rnd(B, S, Hq, dh), rnd(B, S, Hkv, dh), rnd(B, S, Hkv, dh)
        o, lse = fp.flash_prefill_traj(q, k, v, window=w)
        args_ = (q, k, v, o, lse, rnd(B, S, Hq, dh))
        cases[label] = (args_, w, fp.flash_prefill_bwd_plain(
            *args_, window=w, round_p=True))
    real_lib = _build.load("flash_prefill_bwd")
    stages = fp.BWD_TC_STAGES
    names = list(VARIANTS)
    try:
        for r in range(args.rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                _build._LIBS["flash_prefill_bwd"] = libs[name]
                fp.BWD_TC_STAGES = STAGES.get(name, stages)
                said = []
                for label, (args_, w, want) in cases.items():
                    got = fp.flash_prefill_bwd(*args_, window=w)
                    again = fp.flash_prefill_bwd(*args_, window=w)
                    err = max(float((a.float() - b.float()).abs().max())
                              / float(b.float().abs().max())
                              for a, b in zip(got, want))
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    said.append(f"{label} err {err:.2e}"
                                + ("" if same else " (runs differ)"))
                    if label in SHAPES:
                        ms = stamps.graph_ms(
                            lambda a=args_, w=w: fp.flash_prefill_bwd(
                                *a, window=w), 10)
                        said.append(f"{label} {ms:.4f} ms")
                print(f"[variants] round {r} {name}: " + ", ".join(said))
    finally:
        _build._LIBS["flash_prefill_bwd"] = real_lib
        fp.BWD_TC_STAGES = stages
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
