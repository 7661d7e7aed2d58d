"""Phase stamps, instruction counts and times of a kernel on the card:
where a launch of the RWKV6 chunked scans (K6 ``wkv6``, K6t ``wkv6_traj``,
K6b ``wkv6_bwd``), the fused LSTM cell (K1 ``lstm_cell``), the decode
attention (K9 ``decode_attn``), the Mamba selective scans (K7 and K7t under
``mamba_scan``, and K7b too under ``mamba_scan_bwd``), the stacked-LSTM
forward (K2 and K2t under ``lstm_seq``) or its backward (K3 and K3-q8 under
``lstm_seq_bwd``), and their split homes (``lstm_seq_split``,
``lstm_seq_bwd_split``), spends its cycles.

    PYTHONPATH=src python -m repro_torch.obs.stamps [--kernel wkv6]
        [--dtype float32] [--sass] [--no-stamps]

Each kernel source is copied with a ``clock64()`` stamp after every
barrier of its ``__global__`` body (``__syncthreads()``, a named
barrier, ``lstm_gates::bar_sync``, or the split kernels' grid barrier,
``lstm_gates::grid_sync``) and one before the body's closing
brace: thread 0 of each block adds the cycles since its previous
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
  B = 64 (a training batch), and 2 x 64 at B = 1, f32, and bf16 beside it
  unless ``--dtype float32``;
- ``lstm_seq``: the paper's 2 x 32 stack at T = 128, K2 at B = 1 and K2t
  at B = 64 (each at its table's tiling), f32, and bf16 beside it unless
  ``--dtype float32``, with bf16's 2 x 64 K2 at B = 1;
- ``decode_attn``: Qwen2-0.5B's and Yi-9B's served decode step, B = 4 over
  517 cache slots at length 508; bf16 unless ``--dtype float32``;
- ``mamba_scan``: the attention-free Jamba-1.5-Large scan at full width,
  B = 4 x T = 512, d_inner 16384, d_state 16: K7 at the serving table's
  tiling (a prefill, and the one-step decode at T = 1) and K7t at the
  training table's, each first held against its plain version, with the
  kernels' blocks an SM; stamps ``mamba_scan.cu`` alone, so it builds no
  K7b; x bf16 unless ``--dtype float32``;
- ``mamba_scan_bwd``: the same, then K7b at the training table's tiling;
  x and dy bf16 unless ``--dtype float32``;
- ``lstm_seq_bwd``: the paper's 2 x 32 stack trained at batch 64, T = 128:
  K3 (f32) and K3-q8 at the backward table's tiling, and their bf16
  instances beside them unless ``--dtype float32``;
- ``lstm_seq_split``, ``lstm_seq_bwd_split``: the split home at the top of
  the paper's Fig 5, ``SPLIT_SHAPES`` (3 x 256 and 3 x 128, T = 128), f32:
  K2 at B = 1 and K2t at B = 64, or K3 at B = 64 and B = 1, each at its
  table's split tiling (G co-resident blocks a tile).

Printed per site: its line in the source, the nearest phase comment above
it, the mean cycles a pass, the passes a block (over the blocks that reach
it) and its share of the cycles.  The stamps add a few instructions per
phase; the launch's time with and without them is printed beside them.
For ``lstm_cell`` and ``decode_attn`` the kernel's time back to back and in
a CUDA graph (device time alone) is printed beside one PyTorch call of the
same function (``nn.LSTMCell``; SDPA with a length mask), and the bound;
for ``mamba_scan``, ``mamba_scan_bwd`` and ``lstm_seq_bwd`` each launch's
time back to back and in a CUDA graph.

``--no-stamps`` prints the times alone (no stamped copy is built), for
comparing two trees in one call.  ``--sass`` also disassembles the real
build (``cuobjdump -sass``) and
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
#: the Jamba scan's training and serving shape: B, T, d_inner, d_state,
#: and the config's chunk (configs/jamba_1_5_large_398b.py)
MAMBA_SHAPE, MAMBA_CHUNK = (4, 512, 16384, 16), 64
#: the HAR training backward: batch, T, layers, hidden (P = H)
LSTM_BWD_SHAPE = (64, 128, 2, 32)
#: the split home's stamped shapes: T, layers, hidden (P = H)
SPLIT_SHAPES = ((128, 3, 256), (128, 3, 128))
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


def is_barrier(line: str) -> bool:
    """Whether a source line is a block, named or grid barrier the stamps
    follow."""
    return ("__syncthreads();" in line or "bar_sync(" in line
            or "grid_sync(" in line)


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
        if in_kernel and is_barrier(line):
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


def _dtypes(dtype) -> tuple:
    """f32, and ``dtype`` beside it when it is another."""
    return (torch.float32,) if dtype == torch.float32 else (torch.float32,
                                                            dtype)


def lstm_cell_runs(dtype, rnd) -> dict:
    """K1 at ``CELL_SHAPES``, f32 and ``dtype``, each timed beside
    ``nn.LSTMCell`` with the same weights in the same dtype (back to back
    and in a CUDA graph) and its bound."""
    from repro_torch.kernels import lstm_cell as cell_k
    runs = {}
    for B, D, H in CELL_SHAPES:
        ops32 = (rnd(D + H, 4 * H, scale=(D + H) ** -0.5),
                 rnd(4 * H, scale=0.1), rnd(B, D), rnd(B, H), rnd(B, H))
        for dt in _dtypes(dtype):
            w, b, x, c, h = (t.to(dt) for t in ops32)
            lib = torch.nn.LSTMCell(D, H).cuda().requires_grad_(False)
            lib.weight_ih.copy_(w[:D].T)
            lib.weight_hh.copy_(w[D:].T)
            lib.bias_ih.copy_(b)
            lib.bias_hh.zero_()
            lib = lib.to(dt)

            def kernel(w=w, b=b, x=x, c=c, h=h):
                return cell_k.lstm_cell(w, b, x, c, h)

            def library(lib=lib, x=x, c=c, h=h):
                return lib(x, (h, c))

            want = cell_k.lstm_cell_plain(w, b, x, c, h)
            torch.testing.assert_close(kernel()[0].float(), want[0].float(),
                                       rtol=2e-5, atol=2e-5 if dt ==
                                       torch.float32 else 2.0 ** -7)
            name = str(dt).split(".")[1]
            nbytes = w.element_size() * (w.numel() + b.numel() + B * D
                                         + 4 * B * H)
            print(f"[time] lstm_cell B={B} D={D} H={H} {name}: kernel "
                  f"{event_ms(kernel, 200, 5):.4f} ms back to back, "
                  f"{graph_ms(kernel):.4f} ms in a CUDA graph; nn.LSTMCell "
                  f"{event_ms(library, 200, 5):.4f} ms, "
                  f"{graph_ms(library):.4f} ms in a graph; bound "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:.3e} ms (bytes)")
            runs[f"lstm_cell B={B} D={D} H={H} {name}"] = (kernel,
                                                           "lstm_cell")
    return runs


def lstm_seq_runs(dtype, rnd) -> dict:
    """K2 at B = 1 and K2t at B = 64 (the paper's 2 x 32 stack, T = 128,
    each at its table's tiling), f32 and ``dtype``, each held to its plain
    version and timed back to back and in a CUDA graph; and bf16's 2 x 64
    K2 at B = 1, which f32 cannot run in one block (f32 runs it on the
    split home)."""
    from repro_torch.kernels import lstm_seq as seq_k
    from repro_torch.kernels import ref
    T_, L, H = 128, 2, 32
    runs = {}
    shapes = [(1, H, False), (64, H, True)]
    if dtype != torch.float32:
        shapes.append((1, 64, False))
    for B, Hs, traj in shapes:
        ops32 = (rnd(L, 2 * Hs, 4 * Hs, scale=(2 * Hs) ** -0.5),
                 rnd(L, 4 * Hs, scale=0.1), rnd(B, T_, Hs))
        for dt in _dtypes(dtype):
            w, b, x = (t.to(dt) for t in ops32)
            kw = seq_k._bytes(w, x)
            mode = "bwd" if traj else "fwd"
            tiles = seq_k.choose_batch_block(B, T_, L, Hs, Hs, mode=mode,
                                             **kw)
            if tiles is None:
                continue
            name = (f"lstm_seq{'_traj' if traj else ''} B={B} {L}x{Hs} "
                    f"{str(dt).split('.')[1]} tiles {tuple(tiles)}")
            got = seq_k._launch(w, b, x, tiles.block_b, tiles.time_chunk,
                                traj, n_blocks=tiles.n_blocks)
            want = ref.lstm_seq_traj(w, b, x)
            for g, r in zip(got, want):
                torch.testing.assert_close(
                    g.float(), r.float(), rtol=2e-5,
                    atol=2e-5 if g.dtype == torch.float32 else 2.0 ** -7)
            fn = (lambda w=w, b=b, x=x, t=tiles, tr=traj: seq_k._launch(
                w, b, x, t.block_b, t.time_chunk, tr, n_blocks=t.n_blocks))
            timed(name, fn)
            runs[name] = (fn, "lstm_seq")
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


def timed(name: str, fn) -> None:
    """Print ``fn``'s time back to back and in a CUDA graph."""
    print(f"[time] {name}: {event_ms(fn, 20, 5):.4f} ms back to back, "
          f"{graph_ms(fn):.4f} ms in a CUDA graph")


def _mamba_inputs(dtype, rnd):
    """Jamba's scan inputs at ``MAMBA_SHAPE`` and both tables' tilings."""
    from repro_torch.kernels import mamba_scan as ms
    B, T_, di, ds = MAMBA_SHAPE
    sv = ms.choose_blocks(T_, di, ds, target=MAMBA_CHUNK)
    tr = ms.choose_blocks(T_, di, ds, target=MAMBA_CHUNK, mode="bwd")
    x = rnd(B, T_, di).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, T_, di))
    b, c = rnd(B, T_, ds), rnd(B, T_, ds)
    a, h0 = -torch.exp(rnd(di, ds)), rnd(B, di, ds, scale=0.3)
    print(f"[stamps] B={B} T={T_} d_inner {di} d_state {ds} {dtype}: "
          f"serving {sv}, training {tr}")
    return (x, dt, b, c, a, h0), sv, tr


def mamba_fwd_runs(dtype, rnd, inputs=None) -> dict:
    """K7 (a prefill and a T = 1 decode at the serving tiling) and K7t (at
    the training tiling) at Jamba's width: each held against its plain
    version (y at MAMBA_TOL of its dtype, the states at f32's), K7t's y and
    state bit-equal to K7's, the one-phase T = 1 path bit-equal to the
    general path where the tree has both; each kernel's blocks an SM (the
    occupancy calculator, where the tree has the call); each launch timed
    back to back and in a CUDA graph."""
    from repro_torch.core import plans
    from repro_torch.kernels import mamba_scan as ms
    args, sv, tr = inputs or _mamba_inputs(dtype, rnd)
    # a decode step's inputs are whole tensors of one step, as the model
    # hands them over (no copy kernel of a strided view is timed)
    one = tuple(t[:, :1].contiguous() for t in args[:4]) + args[4:]
    tol, name = plans.MAMBA_TOL, str(dtype).split(".")[1]

    def hold(got, want, what):
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   **tol[name], msg=f"{what} y")
        torch.testing.assert_close(got[1], want[1], **tol["float32"],
                                   msg=f"{what} state")

    k7 = ms.mamba_scan(*args, chunk=sv.chunk, di_tile=sv.di_tile)
    hold(k7, ms.mamba_scan_plain(*args, sv.chunk), "K7 prefill")
    k7t = ms.mamba_scan_traj(*args, chunk=tr.chunk, di_tile=tr.di_tile)
    plain_t = ms.mamba_scan_traj_plain(*args, tr.chunk)
    hold(k7t, plain_t, "K7t")
    torch.testing.assert_close(k7t[2], plain_t[2], **tol["float32"])
    if not (torch.equal(k7t[0], k7[0]) and torch.equal(k7t[1], k7[1])):
        raise RuntimeError("K7t's y or state differs from K7's")
    dec = ms.mamba_scan(*one, chunk=1, di_tile=sv.di_tile)
    hold(dec, ms.mamba_scan_plain(*one, 1), "K7 decode")
    checks = "K7, K7t and the T=1 decode vs plain at MAMBA_TOL; K7t = K7"
    # trees before the one-phase path lack these calls; the script runs
    # on them too, to compare a parent and a change in one call
    if hasattr(ms, "fwd_blocks_per_sm"):
        gen = ms._launch_fwd(*one, 1, 1, sv.di_tile, traj=False,
                             one_phase=False)
        if not all(torch.equal(g, d) for g, d in zip(gen, dec)):
            raise RuntimeError("the one-phase T=1 path differs from the "
                               "general path")
        checks += "; T=1 one-phase = general path"
        T_, ds = args[0].shape[1], args[2].shape[-1]
        occ = [ms.fwd_blocks_per_sm(dtype, T, ds, C, tile, traj)
               for T, C, tile, traj in ((T_, sv.chunk, sv.di_tile, False),
                                        (1, 1, sv.di_tile, False),
                                        (T_, tr.chunk, tr.di_tile, True))]
        print(f"[occupancy] blocks an SM: K7 prefill {occ[0]} of "
              f"{sv.di_tile} threads, decode {occ[1]} (one-phase), K7t "
              f"{occ[2]} of {tr.di_tile}")
    print(f"[check] {checks} ({dtype})")
    runs = {
        f"mamba_scan (K7) prefill C={sv.chunk}": (
            lambda: ms.mamba_scan(*args, chunk=sv.chunk, di_tile=sv.di_tile),
            "mamba_scan"),
        "mamba_scan (K7) decode T=1": (
            lambda: ms.mamba_scan(*one, chunk=1, di_tile=sv.di_tile),
            "mamba_scan"),
        f"mamba_scan_traj (K7t) C={tr.chunk}": (
            lambda: ms.mamba_scan_traj(*args, chunk=tr.chunk,
                                       di_tile=tr.di_tile), "mamba_scan")}
    for name_, (fn, _) in runs.items():
        timed(name_, fn)
    return runs


def mamba_runs(dtype, rnd) -> dict:
    """``mamba_fwd_runs``, then K7b at the training tiling, timed back to
    back and in a CUDA graph."""
    from repro_torch.kernels import mamba_scan as ms
    inputs = _mamba_inputs(dtype, rnd)
    runs = mamba_fwd_runs(dtype, rnd, inputs)
    args, _, tr = inputs
    B, T_, di = args[0].shape
    ds = args[2].shape[-1]
    _, _, traj = ms.mamba_scan_traj(*args, chunk=tr.chunk,
                                    di_tile=tr.di_tile)
    dy, dhf = rnd(B, T_, di).to(dtype), rnd(B, di, ds)
    name = f"mamba_scan_bwd (K7b) C={tr.chunk}"
    runs[name] = (lambda: ms.mamba_scan_bwd(*args[:5], traj, dy, dhf,
                                            chunk=tr.chunk,
                                            di_tile=tr.di_tile),
                  "mamba_scan_bwd")
    timed(name, runs[name][0])
    return runs


def lstm_bwd_runs(dtype, rnd) -> dict:
    """K3 and K3-q8 at the HAR training shape and the backward table's
    tiling, each timed back to back and in a CUDA graph."""
    from repro_torch.kernels import lstm_seq as seq_k
    from repro_torch.kernels import lstm_seq_bwd as bwd_k
    from repro_torch.kernels import ref
    B, T_, L, H = LSTM_BWD_SHAPE
    w = rnd(L, 2 * H, 4 * H, scale=(2 * H) ** -0.5)
    b, x = rnd(L, 4 * H, scale=0.1), rnd(B, T_, H)
    dc, dh = rnd(L, B, H), rnd(L, B, H)
    tiles = seq_k.choose_batch_block(B, T_, L, H, H, mode="bwd")
    kw = dict(block_b=tiles.block_b, time_chunk=tiles.time_chunk)
    _, _, ct, ht = seq_k.lstm_seq_traj(w, b, x, **kw)
    wq, s = ref.quantize_q8(w)
    qt = seq_k.choose_batch_block(B, T_, L, H, H, mode="bwd",
                                  quantized=True)
    qkw = dict(block_b=qt.block_b, time_chunk=qt.time_chunk)
    _, _, cq, hq = seq_k.lstm_seq_q8_traj(wq, s, b, x, **qkw)
    print(f"[stamps] B={B} T={T_} {L} x {H}: f32 tiles {tuple(tiles)}, q8 "
          f"tiles {tuple(qt)}")
    runs = {
        "lstm_seq_bwd (K3) f32": (
            lambda: bwd_k.lstm_seq_bwd(w, b, x, ct, ht, dc, dh, **kw),
            "lstm_seq_bwd"),
        "lstm_seq_bwd_q8 (K3-q8)": (
            lambda: bwd_k.lstm_seq_bwd_q8(wq, s, b, x, cq, hq, dc, dh,
                                          **qkw), "lstm_seq_bwd")}
    if dtype != torch.float32:
        # the bf16 instances on the same values rounded, at the same tiles
        # (the register home's ring and wavefront do not depend on dtype)
        w16, b16, x16, dc16, dh16 = (t.to(dtype) for t in (w, b, x, dc, dh))
        _, _, c16, h16 = seq_k.lstm_seq_traj(w16, b16, x16, **kw)
        _, _, cq16, hq16 = seq_k.lstm_seq_q8_traj(wq, s, b, x16, **qkw)
        runs["lstm_seq_bwd (K3) bf16"] = (
            lambda: bwd_k.lstm_seq_bwd(w16, b16, x16, c16, h16, dc16, dh16,
                                       **kw), "lstm_seq_bwd")
        runs["lstm_seq_bwd_q8 (K3-q8) bf16 x"] = (
            lambda: bwd_k.lstm_seq_bwd_q8(wq, s, b, x16, cq16, hq16, dc16,
                                          dh16, **qkw), "lstm_seq_bwd")
    for name, (fn, _) in runs.items():
        timed(name, fn)
    return runs


def lstm_split_runs(dtype, rnd, bwd: bool = False) -> dict:
    """The split home at ``SPLIT_SHAPES`` in f32: K2 at B = 1 and K2t at
    B = 64 (``bwd``: K3 at B = 64 and B = 1), each at its table's tiling
    and held to its plain version, timed back to back and in a CUDA
    graph."""
    from repro_torch.kernels import lstm_seq as seq_k
    from repro_torch.kernels import lstm_seq_bwd as bwd_k
    from repro_torch.kernels import ref
    runs = {}
    for T_, L, H in SPLIT_SHAPES:
        w = rnd(L, 2 * H, 4 * H, scale=(2 * H) ** -0.5)
        b = rnd(L, 4 * H, scale=0.1)
        for B, traj in ((1, False), (64, True)) if not bwd else \
                ((64, True), (1, True)):
            x = rnd(B, T_, H)
            t = seq_k.choose_batch_block(B, T_, L, H, H,
                                         mode="bwd" if traj else "fwd")
            kw = dict(block_b=t.block_b, n_blocks=t.n_blocks)
            name = (f"{'lstm_seq_bwd' if bwd else 'lstm_seq'}"
                    f"{'_traj' if traj and not bwd else ''} B={B} {L}x{H} "
                    f"tiles {tuple(t)}")
            if not bwd:
                got = seq_k._launch(w, b, x, t.block_b, None, traj,
                                    n_blocks=t.n_blocks)
                want = ref.lstm_seq_traj(w, b, x)
                for g, r in zip(got, want):
                    torch.testing.assert_close(g, r, rtol=2e-5, atol=2e-5)
                fn = (lambda w=w, b=b, x=x, t=t, tr=traj: seq_k._launch(
                    w, b, x, t.block_b, None, tr, n_blocks=t.n_blocks))
                runs[name] = (fn, "lstm_seq")
            else:
                _, _, ct, ht = seq_k.lstm_seq_traj(w, b, x, **kw)
                dc, dh = rnd(L, B, H), rnd(L, B, H)
                got = bwd_k.lstm_seq_bwd(w, b, x, ct, ht, dc, dh, **kw)
                want = bwd_k.lstm_seq_bwd_plain(w, b, x, ct, ht, dc, dh)
                for g, r in zip(got, want):
                    e = float((g - r).abs().max())
                    assert e <= 2e-4 * max(1.0, float(r.abs().max())), e
                fn = (lambda w=w, b=b, x=x, ct=ct, ht=ht, dc=dc, dh=dh,
                      kw=kw: bwd_k.lstm_seq_bwd(w, b, x, ct, ht, dc, dh,
                                                **kw))
                runs[name] = (fn, "lstm_seq_bwd")
            timed(name, fn)
    return runs


KERNELS = {"wkv6": wkv6_runs, "lstm_cell": lstm_cell_runs,
           "decode_attn": decode_attn_runs, "mamba_scan": mamba_fwd_runs,
           "mamba_scan_bwd": mamba_runs, "lstm_seq": lstm_seq_runs,
           "lstm_seq_bwd": lstm_bwd_runs, "lstm_seq_split": lstm_split_runs,
           "lstm_seq_bwd_split": lambda dtype, rnd: lstm_split_runs(
               dtype, rnd, bwd=True)}
#: the sources each choice stamps (by default the choice's own)
SOURCES = {"wkv6": ("wkv6", "wkv6_bwd"),
           "mamba_scan_bwd": ("mamba_scan", "mamba_scan_bwd"),
           "lstm_seq_split": ("lstm_seq",),
           "lstm_seq_bwd_split": ("lstm_seq_bwd",)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="wkv6", choices=tuple(KERNELS))
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"),
                    help="IO dtype of wkv6, decode_attn, mamba_scan and "
                    "mamba_scan_bwd; the LSTM kernels run f32 and, for "
                    "bfloat16, their bf16 instances beside it")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--no-stamps", action="store_true",
                    help="print the times alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("stamps: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    dtype = getattr(torch, args.dtype)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    clock_hz = float(clock.stdout.split()[0]) * 1e6
    sources = sorted(SOURCES.get(args.kernel, (args.kernel,)))
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
    stamped = {} if args.no_stamps else {
        src: build_stamped(src) for src in sources}
    real_load = _build.load
    _build.load = lambda name: stamped[name][0] if name in stamped \
        else real_load(name)
    try:
        for name, (fn, src) in runs.items():
            if src not in stamped:
                continue
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
