"""Build the CUDA C++ kernels under ``kernels/csrc`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by hand
with nvcc into its own shared library, then loaded with ctypes — no PyTorch
headers, so a build takes seconds rather than minutes.  Libraries land in
``build/`` at the repo root, keyed by a hash of the source, the headers
beside it (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads.  ``build_all`` starts
one nvcc per source, all at once, so a cold build costs the slowest file.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a nonzero code into an exception, because a refused launch
(too many threads, too much shared memory) never runs and a later
``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("lstm_cell", "lstm_seq", "lstm_seq_bwd")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of nvcc under the CUDA toolkit PyTorch was pointed at."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "kernels cannot be built")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build_all(names: tuple[str, ...] = SOURCES, ptxas_info: bool = False
              ) -> dict[str, str]:
    """Compile every source in ``names`` that is not built yet, one nvcc
    per source, all started together.  Returns nvcc's output per source
    built (with ``ptxas_info``, each kernel's registers and shared memory).
    Raises RuntimeError with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas=-v",) if ptxas_info else ()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, out)          # atomic: a racing loader sees all or none
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            err_fn = getattr(lib, f"{name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
