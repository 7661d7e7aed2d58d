"""Phase stamps and instruction counts of the RWKV6 chunked-scan kernels on
the card: where a launch of K6 (``wkv6``), K6t (``wkv6_traj``) or K6b
(``wkv6_bwd``) spends its cycles.

    PYTHONPATH=src python -m repro_torch.obs.stamps [--dtype float32] [--sass]

Each kernel source is copied with a ``clock64()`` stamp after every
``__syncthreads()`` of its ``__global__`` body: thread 0 of each block adds
the cycles since its previous stamp to a per-(block, barrier) counter, so
barrier k's counter holds the time of the phase that ends at it, the wait
for the block's slowest warp included.  The copy is built with the same
nvcc flags as ``kernels/_build.py`` (into ``build/stamps/``), loaded in
place of the real library, and driven once through the public wrapper after
a warm-up launch, at the RWKV6-3B training shape (160 batch-head rows of
64 x 64 heads, T = 512, C = 32; random inputs from seed 0), bf16 IO unless
``--dtype float32``.  Printed per barrier: its line in the source, the
nearest phase comment above it, the mean cycles per chunk over the blocks,
and its share.  The stamps add a few instructions per
phase; the launch's time with and without them is printed beside them.

``--sass`` also disassembles the real build (``cuobjdump -sass``) and
prints, per kernel instance, the count of the instructions that bound
these kernels: FFMA/FMUL/FADD, LDS/STS, MUFU.EX2, SHFL, BAR, LDG/STG and
LDGSTS (cp.async).
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import wkv6 as wkv6_k

#: the shape the kernels are stamped at: batch-head rows, steps, head
#: widths, chunk, and the seed of the random inputs
BH, T, DK, DV, CHUNK, SEED = 160, 512, 64, 64, 32, 0
MAX_SITES = 64
MAX_BLOCKS = 4096
PRELUDE = f"""
__device__ unsigned long long g_stamp[{MAX_BLOCKS} * {MAX_SITES}];
#define PHASE_STAMP(site)                                              \\
  do {{                                                                \\
    if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{              \\
      const long long now_ = clock64();                                \\
      g_stamp[blockIdx.x * {MAX_SITES} + (site)] += now_ - stamp_prev_; \\
      stamp_prev_ = now_;                                              \\
    }}                                                                 \\
  }} while (0)
"""
EPILOGUE = f"""
extern "C" int stamps_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}}
extern "C" int stamps_reset() {{
  static unsigned long long zero[{MAX_BLOCKS} * {MAX_SITES}];
  return (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(g_stamp));
}}
"""


def instrument(text: str) -> tuple[str, list[tuple[int, str]]]:
    """The source with a stamp after each barrier of each ``__global__``
    body, and per stamp site its 1-based source line and label (the
    nearest ``// (`` phase comment above it, else the barrier's own
    line)."""
    lines = text.splitlines()
    out, sites = [], []
    depth, in_kernel, pending_global = 0, False, False
    label = ""
    for n, line in enumerate(lines, 1):
        stripped = line.strip()
        if stripped.startswith("// (") or stripped.startswith("// ---"):
            label = stripped.lstrip("/ -")
        if "__global__" in line:
            pending_global = True
        opening = False
        if pending_global and "{" in line:
            pending_global, in_kernel, depth, opening = False, True, 0, True
            label = ""
        if in_kernel:
            depth += line.count("{") - line.count("}")
        out.append(line)
        if opening:
            out.append("  long long stamp_prev_ = clock64();")
        if in_kernel and "__syncthreads();" in line:
            out.append(f"PHASE_STAMP({len(sites)});")
            sites.append((n, label or stripped))
        if in_kernel and depth == 0 and not opening:
            in_kernel = False
    if len(sites) > MAX_SITES:
        raise ValueError(f"{len(sites)} barriers, at most {MAX_SITES}")
    body = "\n".join(out)
    first = body.index("namespace {") if "namespace {" in body else 0
    return body[:first] + PRELUDE + body[first:] + EPILOGUE, sites


def build_stamped(name: str) -> tuple[ctypes.CDLL, list[tuple[int, str]]]:
    """Build ``csrc/<name>.cu`` with its stamps into ``build/stamps``."""
    text, sites = instrument((_build.CSRC / f"{name}.cu").read_text())
    work = _build.BUILD_DIR / "stamps"
    work.mkdir(parents=True, exist_ok=True)
    src = work / f"{name}.cu"
    src.write_text(text)
    lib_path = work / f"{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
           str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the stamped {name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib, sites


def event_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def report(name: str, fn, lib, sites, n_blocks: int, n_chunks: int,
           clock_hz: float) -> None:
    """Run ``fn`` once with ``lib`` stamping and print the phase table."""
    lib.stamps_reset()
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * MAX_SITES))()
    err = lib.stamps_read(buf)
    if err:
        raise RuntimeError(f"reading the stamps of {name} failed: {err}")
    per_site = [0.0] * len(sites)
    blocks = min(n_blocks, MAX_BLOCKS)
    for b in range(blocks):
        for s in range(len(sites)):
            per_site[s] += buf[b * MAX_SITES + s]
    total = sum(per_site) or 1.0
    print(f"[stamps] {name}: cycles per chunk, mean over {blocks} blocks "
          f"and {n_chunks} chunks ({clock_hz / 1e6:.0f} MHz max SM clock)")
    for (line, label), cyc in zip(sites, per_site):
        c = cyc / blocks / max(1, n_chunks)
        print(f"[stamps] {name}  line {line:4d}  {c:10.1f} cycles "
              f"{c / clock_hz * 1e6:8.3f} us  {cyc / total:6.1%}  {label}")
    c = total / blocks / max(1, n_chunks)
    print(f"[stamps] {name}  all phases {c:10.1f} cycles "
          f"{c / clock_hz * 1e6:8.3f} us a chunk")


SASS_OPS = ("FFMA", "FMUL", "FADD", "LDS", "STS", "MUFU.EX2", "SHFL", "BAR",
            "LDG", "STG", "LDGSTS")


def sass_counts(name: str) -> None:
    """Count the bounding instructions of each kernel in the real build."""
    lib = _build.library_path(name)
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"[sass] {name}: cuobjdump failed: {proc.stderr.strip()}")
        return
    kernel, counts = None, collections.OrderedDict()
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            counts[kernel] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9.]+)",
                      line)
        if kernel and m:
            op = m.group(1)
            for key in SASS_OPS:
                if op == key or op.startswith(key + "."):
                    counts[kernel][key] += 1
    for kernel, c in counts.items():
        print(f"[sass] {name} {kernel}: "
              + ", ".join(f"{k} {c[k]}" for k in SASS_OPS))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("stamps: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    dtype = getattr(torch, args.dtype)
    dk, dv, C = DK, DV, CHUNK

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    r, k = rnd(BH, T, dk).to(dtype), rnd(BH, T, dk).to(dtype)
    v = rnd(BH, T, dv).to(dtype)
    logw = -torch.exp(rnd(BH, T, dk))
    u, s0 = rnd(BH, dk), rnd(BH, dk, dv, scale=0.3)
    dout, dsf = rnd(BH, T, dv).to(dtype), rnd(BH, dk, dv)
    _, s_fin, traj = wkv6_k.wkv6_traj(r, k, v, logw, u, s0, chunk=C)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    clock_hz = float(clock.stdout.split()[0]) * 1e6
    runs = {
        "wkv6": lambda: wkv6_k.wkv6(r, k, v, logw, u, s0, chunk=C),
        "wkv6_traj": lambda: wkv6_k.wkv6_traj(r, k, v, logw, u, s0,
                                              chunk=C),
        "wkv6_bwd": lambda: wkv6_k.wkv6_bwd(r, k, v, logw, u, traj, s_fin,
                                            dout, dsf, chunk=C)}
    unstamped_ms = {name: event_ms(fn) for name, fn in runs.items()}
    stamped = {src: build_stamped(src) for src in ("wkv6", "wkv6_bwd")}
    real_load = _build.load
    _build.load = lambda name: stamped[name][0] if name in stamped \
        else real_load(name)
    try:
        print(f"[stamps] BH={BH} T={T} {dk}x{dv} C={C} {args.dtype}")
        for name, fn in runs.items():
            src = "wkv6_bwd" if name == "wkv6_bwd" else "wkv6"
            lib, sites = stamped[src]
            ms = event_ms(fn)
            print(f"[stamps] {name}: {unstamped_ms[name]:.4f} ms a launch, "
                  f"{ms:.4f} ms with the stamps")
            report(name, fn, lib, sites, BH, -(-T // C), clock_hz)
    finally:
        _build.load = real_load
    if args.sass:
        for src in ("wkv6", "wkv6_bwd"):
            sass_counts(src)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
