"""Build a kernel source of ``src/repro_torch/kernels/csrc`` with g++ against
the mock CUDA runtime in ``tests/cuda_mock/`` and load it with ctypes, so
that a test can run the kernel's control flow on the CPU (one std::thread
per CUDA thread) and hold it against its plain version.

``rewrite`` turns the two constructs g++ cannot read into calls of the
mock: each launch ``k<<<grid, block, smem, stream>>>(args);`` becomes
``cuda_mock::launch(grid, block, smem, [&] { k(args); });`` and each
``extern __shared__ T name[];`` a pointer to the block's dynamic shared
memory.  ``build`` compiles the rewritten copy into ``out_dir`` once per
source text and returns the loaded library, or None where the host has no
g++ (the tests that need it then say so)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

MOCK = Path(__file__).resolve().parent / "cuda_mock"
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
FLAGS = ("-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-shared",
         "-fPIC", "-w")


def _split_top(text: str) -> list[str]:
    """``text`` split at the commas outside any bracket."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur).strip())
    return parts


def rewrite(text: str) -> str:
    """The source with its launches and dynamic shared memory in the
    mock's terms."""
    text = re.sub(
        r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)"
        r"\[\];",
        r"\1* \2 = reinterpret_cast<\1*>(cuda_mock::dyn_smem);", text)
    out, pos = [], 0
    while True:
        start = text.find("<<<", pos)
        if start < 0:
            out.append(text[pos:])
            return "".join(out)
        # the kernel's name (with its template arguments) before <<<
        name_start = start
        while text[name_start - 1].isspace():
            name_start -= 1
        name_end = name_start
        depth = 0
        while name_start > 0:
            ch = text[name_start - 1]
            if ch == ">":
                depth += 1
            elif ch == "<":
                depth -= 1
            elif depth == 0 and not (ch.isalnum() or ch in "_:"):
                break
            name_start -= 1
        kernel = text[name_start:name_end]
        close = text.index(">>>", start)
        config = _split_top(text[start + 3:close])
        args_open = text.index("(", close)
        depth, i = 0, args_open
        while True:
            if text[i] == "(":
                depth += 1
            elif text[i] == ")":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        args = text[args_open + 1:i]
        end = text.index(";", i)
        out.append(text[pos:name_start])
        out.append(f"cuda_mock::launch(dim3({config[0]}), dim3({config[1]}), "
                   f"(size_t)({config[2] if len(config) > 2 else 0}), [&] {{ "
                   f"{kernel}({args}); }});")
        pos = end + 1


def build(name: str, out_dir: Path) -> ctypes.CDLL | None:
    """``csrc/<name>.cu`` built against the mock into ``out_dir`` (None
    without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    text = rewrite((CSRC / f"{name}.cu").read_text())
    key = hashlib.sha256(text.encode() + b"".join(
        p.read_bytes() for p in sorted(MOCK.glob("*.h")))
        + b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    ).hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{name}-{key}.so"
    if not lib.exists():
        # per-process names, then an atomic rename: parallel test workers
        # may build the same source at once
        src = out_dir / f"{name}-{key}.{os.getpid()}.cpp"
        src.write_text(text)
        tmp = out_dir / f"{name}-{key}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [gxx, *FLAGS, f"-I{MOCK}", f"-I{CSRC}", "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on the mock build of {name}.cu:"
                               f"\n{proc.stderr[-4000:]}")
        tmp.replace(lib)
        src.unlink()
    return ctypes.CDLL(str(lib))
