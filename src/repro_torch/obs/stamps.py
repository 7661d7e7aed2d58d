"""Phase stamps, instruction counts and times of a kernel on the card:
where a launch of the RWKV6 chunked scans (K6 ``wkv6``, K6t ``wkv6_traj``,
K6b ``wkv6_bwd``), the fused LSTM cell (K1 ``lstm_cell``) or the decode
attention (K9 ``decode_attn``) spends its cycles.

    PYTHONPATH=src python -m repro_torch.obs.stamps [--kernel wkv6]
        [--dtype float32] [--sass]

Each kernel source is copied with a ``clock64()`` stamp after every
``__syncthreads()`` of its ``__global__`` body and one before the body's
closing brace: thread 0 of each block adds the cycles since its previous
stamp to a per-(block, site) counter and counts its passes, so site k's
counter holds the time of the phase that ends there, the wait for the
block's slowest warp included.  The adds are fire-and-forget atomics
(RED): a read-modify-write of the counter would stall the stamping warp
for a round trip to memory at every site and charge it to the next
phase.  The copy is built with the same nvcc flags
as ``kernels/_build.py`` (into ``build/stamps/``), loaded in place of the
real library, and driven once through the public wrapper after a warm-up
launch at the kernel's main-path shapes, random inputs from seed 0:

- ``wkv6``: the RWKV6-3B training shape, 160 batch-head rows of 64 x 64
  heads, T = 512, C = 32; bf16 IO unless ``--dtype float32``;
- ``lstm_cell``: the paper's cell, 2 x 32 at B = 1 (a served window) and
  B = 64 (a training batch), and 2 x 64 at B = 1, f32;
- ``decode_attn``: Qwen2-0.5B's and Yi-9B's served decode step, B = 4 over
  517 cache slots at length 508; bf16 unless ``--dtype float32``.

Printed per site: its line in the source, the nearest phase comment above
it, the mean cycles a pass, the passes a block (over the blocks that reach
it) and its share of the cycles.  The stamps add a few instructions per
phase; the launch's time with and without them is printed beside them.
For ``lstm_cell`` and ``decode_attn`` the kernel's time back to back and in
a CUDA graph (device time alone) is printed beside one PyTorch call of the
same function (``nn.LSTMCell``; SDPA with a length mask), and the bound.

``--sass`` also disassembles the real build (``cuobjdump -sass``) and
prints, per kernel instance, the count of the instructions that bound
these kernels: FFMA/FMUL/FADD, LDS/STS, MUFU.EX2, SHFL, BAR, LDG/STG,
LDGSTS (cp.async) and ATOMG/RED; ptxas's registers and spills of every
instance are printed from the build.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build

#: the shape the RWKV6 kernels are stamped at: batch-head rows, steps,
#: head widths, chunk, and the seed of the random inputs
BH, T, DK, DV, CHUNK, SEED = 160, 512, 64, 64, 32, 0
#: K1's main-path shapes (B, D, H): a served window's layer 1, a training
#: batch's, and the 2 x 64 stack that fused_seq routes to fused_cell
CELL_SHAPES = ((1, 32, 32), (64, 32, 32), (1, 64, 64))
#: K9's served decode shapes: (model, Hq, Hkv, dk) at B = 4 over S = 517
#: cache slots, every row at length 508
DECODE_SHAPES = (("qwen2-0.5b", 14, 2, 64), ("yi-9b", 32, 4, 128))
DECODE_B, DECODE_S, DECODE_LEN = 4, 517, 508
HBM_BYTES_PER_S = 3.35e12
MAX_SITES = 64
MAX_BLOCKS = 4096
PRELUDE = f"""
__device__ unsigned long long g_stamp[{MAX_BLOCKS} * {MAX_SITES}];
__device__ unsigned long long g_hits[{MAX_BLOCKS} * {MAX_SITES}];
#define PHASE_STAMP(site)                                              \\
  do {{                                                                \\
    const unsigned blk_ = blockIdx.x + gridDim.x * (blockIdx.y +       \\
                          gridDim.y * blockIdx.z);                     \\
    if (threadIdx.x == 0 && threadIdx.y == 0 && blk_ < {MAX_BLOCKS}) {{ \\
      const long long now_ = clock64();                                \\
      atomicAdd(&g_stamp[blk_ * {MAX_SITES} + (site)],                 \\
                (unsigned long long)(now_ - stamp_prev_));             \\
      atomicAdd(&g_hits[blk_ * {MAX_SITES} + (site)], 1ULL);           \\
      stamp_prev_ = now_;                                              \\
    }}                                                                 \\
  }} while (0)
"""
EPILOGUE = f"""
extern "C" int stamps_read(unsigned long long* cycles,
                           unsigned long long* hits) {{
  const int e = (int)cudaMemcpyFromSymbol(cycles, g_stamp, sizeof(g_stamp));
  return e ? e : (int)cudaMemcpyFromSymbol(hits, g_hits, sizeof(g_hits));
}}
extern "C" int stamps_reset() {{
  static unsigned long long zero[{MAX_BLOCKS} * {MAX_SITES}];
  const int e = (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(g_stamp));
  return e ? e : (int)cudaMemcpyToSymbol(g_hits, zero, sizeof(g_hits));
}}
"""


def instrument(text: str) -> tuple[str, list[tuple[int, str]]]:
    """The source with a stamp after each barrier of each ``__global__``
    body and one before the body's closing brace, and per stamp site its
    1-based source line and label (the nearest ``// (`` phase comment
    above it, else the barrier's own line; "end of kernel" for the
    closing site)."""
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
        closing = in_kernel and depth == 0 and not opening
        if closing:
            out.append(f"PHASE_STAMP({len(sites)});")
            sites.append((n, "end of kernel"))
            in_kernel = False
        out.append(line)
        if opening:
            out.append("  long long stamp_prev_ = clock64();")
        if in_kernel and "__syncthreads();" in line:
            out.append(f"PHASE_STAMP({len(sites)});")
            sites.append((n, label or stripped))
    if len(sites) > MAX_SITES:
        raise ValueError(f"{len(sites)} stamp sites, at most {MAX_SITES}")
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


def event_ms(fn, iters: int = 10, repeats: int = 1) -> float:
    """CUDA-event time per call of ``iters`` back-to-back calls after a
    warm-up call; the median of ``repeats`` such runs."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def graph_ms(fn, calls: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, its replay timed (median of 5 runs of 5 replays); the host's
    per-call work (the wrapper, the launch) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return event_ms(graph.replay, 5, repeats=5) / calls


def report(name: str, fn, lib, sites, clock_hz: float) -> None:
    """Run ``fn`` once with ``lib`` stamping and print the phase table."""
    lib.stamps_reset()
    fn()
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * (MAX_BLOCKS * MAX_SITES))()
    hits = (ctypes.c_ulonglong * (MAX_BLOCKS * MAX_SITES))()
    err = lib.stamps_read(cycles, hits)
    if err:
        raise RuntimeError(f"reading the stamps of {name} failed: {err}")
    per_site = [0.0] * len(sites)
    passes = [0] * len(sites)
    reached = [0] * len(sites)
    blocks = set()
    for b in range(MAX_BLOCKS):
        for s in range(len(sites)):
            n = hits[b * MAX_SITES + s]
            if n:
                per_site[s] += cycles[b * MAX_SITES + s]
                passes[s] += n
                reached[s] += 1
                blocks.add(b)
    total = sum(per_site) or 1.0
    print(f"[stamps] {name}: mean cycles a pass over the blocks that reach "
          f"each site ({len(blocks)} blocks stamped; {clock_hz / 1e6:.0f} "
          "MHz max SM clock)")
    for (line, label), cyc, n, r in zip(sites, per_site, passes, reached):
        c = cyc / max(1, n)
        print(f"[stamps] {name}  line {line:4d}  {c:10.1f} cycles "
              f"{c / clock_hz * 1e6:8.3f} us  x {n / max(1, r):6.2f} a block"
              f"  {cyc / total:6.1%}  {label}")
    c = total / max(1, len(blocks))
    print(f"[stamps] {name}  all sites {c:10.1f} cycles "
          f"{c / clock_hz * 1e6:8.3f} us a block")


SASS_OPS = ("FFMA", "FMUL", "FADD", "LDS", "STS", "MUFU.EX2", "SHFL", "BAR",
            "LDG", "STG", "LDGSTS", "ATOMG", "RED")


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


def wkv6_runs(dtype, rnd) -> dict:
    """K6, K6t and K6b at the RWKV6-3B training shape: name -> (call,
    source)."""
    from repro_torch.kernels import wkv6 as wkv6_k
    dk, dv, C = DK, DV, CHUNK
    r, k = rnd(BH, T, dk).to(dtype), rnd(BH, T, dk).to(dtype)
    v = rnd(BH, T, dv).to(dtype)
    logw = -torch.exp(rnd(BH, T, dk))
    u, s0 = rnd(BH, dk), rnd(BH, dk, dv, scale=0.3)
    dout, dsf = rnd(BH, T, dv).to(dtype), rnd(BH, dk, dv)
    _, s_fin, traj = wkv6_k.wkv6_traj(r, k, v, logw, u, s0, chunk=C)
    print(f"[stamps] BH={BH} T={T} {dk}x{dv} C={C} {dtype}")
    return {
        "wkv6": (lambda: wkv6_k.wkv6(r, k, v, logw, u, s0, chunk=C),
                 "wkv6"),
        "wkv6_traj": (lambda: wkv6_k.wkv6_traj(r, k, v, logw, u, s0,
                                               chunk=C), "wkv6"),
        "wkv6_bwd": (lambda: wkv6_k.wkv6_bwd(r, k, v, logw, u, traj, s_fin,
                                             dout, dsf, chunk=C),
                     "wkv6_bwd")}


def lstm_cell_runs(dtype, rnd) -> dict:
    """K1 at ``CELL_SHAPES``, each timed beside ``nn.LSTMCell`` with the
    same weights (back to back and in a CUDA graph) and its bound."""
    from repro_torch.kernels import lstm_cell as cell_k
    runs = {}
    for B, D, H in CELL_SHAPES:
        w = rnd(D + H, 4 * H, scale=(D + H) ** -0.5)
        b = rnd(4 * H, scale=0.1)
        x, c, h = rnd(B, D), rnd(B, H), rnd(B, H)
        lib = torch.nn.LSTMCell(D, H).cuda().requires_grad_(False)
        lib.weight_ih.copy_(w[:D].T)
        lib.weight_hh.copy_(w[D:].T)
        lib.bias_ih.copy_(b)
        lib.bias_hh.zero_()

        def kernel(w=w, b=b, x=x, c=c, h=h):
            return cell_k.lstm_cell(w, b, x, c, h)

        def library(lib=lib, x=x, c=c, h=h):
            return lib(x, (h, c))

        torch.testing.assert_close(library()[1], kernel()[0], rtol=2e-5,
                                   atol=2e-5)
        nbytes = 4 * (w.numel() + b.numel() + B * D + 4 * B * H)
        print(f"[time] lstm_cell B={B} D={D} H={H} f32: kernel "
              f"{event_ms(kernel, 200, 5):.4f} ms back to back, "
              f"{graph_ms(kernel):.4f} ms in a CUDA graph; nn.LSTMCell "
              f"{event_ms(library, 200, 5):.4f} ms, {graph_ms(library):.4f}"
              f" ms in a graph; bound {nbytes / HBM_BYTES_PER_S * 1e3:.3e} "
              "ms (bytes)")
        runs[f"lstm_cell B={B} D={D} H={H}"] = (kernel, "lstm_cell")
    return runs


def decode_attn_runs(dtype, rnd) -> dict:
    """K9 at ``DECODE_SHAPES``, each timed beside SDPA with a length mask
    (back to back and in a CUDA graph) and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attn as da
    runs = {}
    B, S, n = DECODE_B, DECODE_S, DECODE_LEN
    io = torch.finfo(dtype).bits // 8
    for model, Hq, Hkv, dk in DECODE_SHAPES:
        q = rnd(B, Hq, dk).to(dtype)
        kc, vc = rnd(B, S, Hkv, dk).to(dtype), rnd(B, S, Hkv, dk).to(dtype)
        lens = torch.full((B,), n, dtype=torch.int32, device=q.device)
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        mask = (torch.arange(S, device=q.device)[None, :]
                < lens[:, None])[:, None, None, :]

        def kernel(q=q, kc=kc, vc=vc, lens=lens):
            return da.decode_attn(q, kc, vc, lens)

        def library(q=q, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)

        torch.testing.assert_close(library()[:, :, 0].float(),
                                   kernel().float(), rtol=3e-2, atol=3e-2)
        nbytes = io * (2 * B * n * Hkv * dk + 2 * B * Hq * dk)
        print(f"[time] decode_attn {model} B={B} {Hq}/{Hkv} x {dk} over {S} "
              f"slots, length {n}, {dtype}: kernel "
              f"{event_ms(kernel, 50, 5):.4f} ms back to back, "
              f"{graph_ms(kernel):.4f} ms in a CUDA graph; SDPA with a "
              f"length mask {event_ms(library, 50, 5):.4f} ms, "
              f"{graph_ms(library):.4f} ms in a graph; bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.3e} ms (bytes)")
        runs[f"decode_attn {model}"] = (kernel, "decode_attn")
    return runs


KERNELS = {"wkv6": wkv6_runs, "lstm_cell": lstm_cell_runs,
           "decode_attn": decode_attn_runs}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="wkv6", choices=tuple(KERNELS))
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"),
                    help="IO dtype of wkv6 and decode_attn (lstm_cell is "
                    "f32 only)")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("stamps: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    dtype = getattr(torch, args.dtype)
    if args.kernel == "lstm_cell":
        dtype = torch.float32

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    clock_hz = float(clock.stdout.split()[0]) * 1e6
    sources = sorted({"wkv6": ("wkv6", "wkv6_bwd")}.get(
        args.kernel, (args.kernel,)))
    logs = _build.build_all(tuple(sources), ptxas_info=True)
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {entry}: {line.strip()}")
    runs = KERNELS[args.kernel](dtype, rnd)
    unstamped_ms = {name: event_ms(fn) for name, (fn, _) in runs.items()}
    stamped = {src: build_stamped(src) for src in sources}
    real_load = _build.load
    _build.load = lambda name: stamped[name][0] if name in stamped \
        else real_load(name)
    try:
        for name, (fn, src) in runs.items():
            lib, sites = stamped[src]
            ms = event_ms(fn)
            print(f"[stamps] {name}: {unstamped_ms[name]:.4f} ms a launch, "
                  f"{ms:.4f} ms with the stamps")
            report(name, fn, lib, sites, clock_hz)
    finally:
        _build.load = real_load
    if args.sass:
        for src in sources:
            sass_counts(src)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
