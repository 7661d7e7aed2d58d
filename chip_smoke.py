#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Builds the hand-written kernels of the serving and training paths from
``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) into ``build/``, holds each
kernel, f32 and int8 instances, against its plain PyTorch version on the
card (the backward also against torch autograd of the oracle), serves the
paper's HAR classifier (2 layers x 32 hidden, T=128) through the port's
entry point ``repro_torch.launch.classify`` with all five plans, and at
2 x 64 through the int8 plan, and trains it at batch 64 through
``repro_torch.launch.train_har`` with ``fused_seq`` and with the int8 plan
``fused_seq_q8``, each path with the launch counters set to 0 just before
and read just after and the plain versions of the sequence kernels armed to
raise on CUDA tensors; checks each plan against ``sequential`` under its own
policy, that a ``fused_seq`` and a ``fused_seq_q8`` training step is two
launches at any T, and times each kernel beside its plain version, one
PyTorch library call computing the same function, and the least time the
card could take for the work.

Float32 matrix products and cuDNN run without TF32 here
(``allow_tf32 = False`` for both), so the plain versions and the library
calls are true f32 references.

Exits nonzero if there is no CUDA device, if the port's sources are not
beside this script, or if any check fails.  Its last lines are the card's
name and power limit (from nvidia-smi), one JSON object with every kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

#: The JAX package's f32 tolerance for LSTM plans and kernels (LSTM_TOL).
TOL = dict(rtol=2e-5, atol=2e-5)
#: Its f32 tolerance for LSTM gradients (LSTM_GRAD_TOL): the backward sums
#: over T steps and the batch in another order than autograd does.
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
#: The int8 kernels against the dequantize oracle ``ref.lstm_seq_q8``
#: (Q8_ORACLE_TOL of the JAX package's tests): the kernels fold the scale
#: after the products, the oracle multiplies it into the weights first.
Q8_ORACLE_TOL = dict(rtol=1e-4, atol=1e-5)
#: Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores — the kernels use CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
REPO = Path(__file__).resolve().parent


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def close(got: torch.Tensor, want: torch.Tensor, what: str,
          tol: dict = TOL) -> float:
    """Assert agreement at ``tol``; return the max abs error."""
    torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


def reset_counts(*wrappers) -> None:
    for fn in wrappers:
        fn.launches = 0


def time_ms(fn, iters: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of CUDA-event time per call of ``iters``
    back-to-back calls, after a warmup."""
    for _ in range(3):
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


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    """Least time in ms for the work, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def instance(mangled: str) -> str:
    """The template arguments of a mangled kernel name, e.g.
    ``<16,512,int8>`` for ``lstm_seq_bwd_kernel<16, 512, int8_t>`` (a bool
    argument prints 0 or 1)."""
    args = re.search(r"I((?:L[ib]\d+E)+)([af]?)E", mangled)
    if not args:
        return ""
    vals = re.findall(r"L[ib](\d+)E", args.group(1))
    if args.group(2):
        vals.append({"a": "int8", "f": "f32"}[args.group(2)])
    return "<" + ",".join(vals) + ">"


def randn(*shape, gen, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).cuda()


@contextlib.contextmanager
def tripwires(*where):
    """Arm each ``(module, name)`` plain version to raise when a CUDA
    tensor reaches it: inside, every CUDA call must launch its kernel."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in where]

    def armed(name, fn):
        def call(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise RuntimeError(f"a CUDA tensor reached the plain version "
                                   f"{name}")
            return fn(*args, **kwargs)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, armed(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)   # progress survives a kill
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    src = REPO / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(src))

    from repro_torch.configs.mobirnn_lstm import LSTMConfig
    from repro_torch.core import lstm, plans
    from repro_torch.kernels import _build
    from repro_torch.kernels import lstm_cell as cell_k
    from repro_torch.kernels import lstm_seq as seq_k
    from repro_torch.kernels import lstm_seq_bwd as bwd_k
    from repro_torch.kernels import ref
    from repro_torch.launch import classify, train_har
    from repro_torch.obs import trace as trace_lib
    from repro_torch.data import har
    from repro_torch.optim.adamw import AdamW, tree_leaves, warmup_cosine

    counted = (cell_k.lstm_cell, seq_k.lstm_seq, seq_k.lstm_seq_traj,
               bwd_k.lstm_seq_bwd, seq_k.lstm_seq_q8, seq_k.lstm_seq_q8_traj,
               bwd_k.lstm_seq_bwd_q8)

    def counts() -> dict:
        return {fn.__name__: fn.launches for fn in counted}

    def only(**launched) -> dict:
        """The counts of a run that launched ``launched`` and nothing
        else."""
        return {fn.__name__: launched.get(fn.__name__, 0) for fn in counted}

    # the plain versions a sequence-kernel wrapper would take for CPU
    # tensors; armed around the main paths, where none may see CUDA ones
    plain_versions = ((seq_k, "lstm_seq_plain"), (seq_k, "lstm_seq_q8_plain"),
                      (seq_k, "lstm_seq_q8_traj_plain"),
                      (bwd_k, "lstm_seq_bwd_plain"), (ref, "lstm_seq"),
                      (ref, "lstm_seq_traj"))
    lstm_family = plans.get_family("lstm")

    def policy(plan: str) -> dict:
        """The plan's own tolerance against ``sequential``: LSTM_TOL, or
        Q8_BAND for the int8 plan."""
        return lstm_family.tol(plan, "float32")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    # --- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(ptxas_info=True)
    print(f"[build] {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        kernel = ""                   # the instance ptxas is reporting on
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = instance(entry.group(1))
            elif "registers" in line or "smem" in line or "spill" in line:
                print(f"[build] {name}{kernel}: {line.strip()}")

    gen = torch.Generator().manual_seed(1234)
    errs = {fn.__name__: 0.0 for fn in counted}

    # --- 2. K1 against its plain version -----------------------------------
    for B, D, H in [(1, 9, 32), (1, 32, 32), (64, 9, 32), (64, 32, 32),
                    (5, 9, 20)]:
        w = randn(D + H, 4 * H, gen=gen, scale=(D + H) ** -0.5)
        b = randn(4 * H, gen=gen, scale=0.1)
        xs = randn(B, 3, D, gen=gen)
        x = xs[:, 1]                        # a strided row, as plans pass it
        c = randn(B, H, gen=gen)
        h = randn(B, H, gen=gen)
        got = cell_k.lstm_cell(w, b, x, c, h)
        want = cell_k.lstm_cell_plain(w, b, x, c, h)
        err = max(close(g, r, f"lstm_cell B={B} D={D} H={H}")
                  for g, r in zip(got, want))
        errs["lstm_cell"] = max(errs["lstm_cell"], err)
        print(f"[K1] lstm_cell B={B} D={D} H={H}: max abs err {err:.3e}")

    # --- 3. K2 against its plain version -----------------------------------
    def seq_case(L, P, H, B, T):
        w = randn(L, P + H, 4 * H, gen=gen, scale=(P + H) ** -0.5)
        b = randn(L, 4 * H, gen=gen, scale=0.1)
        x = randn(B, T, P, gen=gen)
        return w, b, x

    cases = [("2x32 T=128 B=1", (2, 32, 32, 1, 128), {}),
             ("2x32 T=128 B=64", (2, 32, 32, 64, 128), {}),
             ("P>H hidden 8 input 9", (2, 9, 8, 3, 20), {}),
             ("batch tail B=37 tile 16 tc=8 T=50", (2, 32, 32, 37, 50),
              dict(block_b=16, time_chunk=8))]
    for label, shape, kw in cases:
        w, b, x = seq_case(*shape)
        got = seq_k.lstm_seq(w, b, x, **kw)
        want = seq_k.lstm_seq_plain(w, b, x)
        err = max(close(g, r, f"lstm_seq {label}")
                  for g, r in zip(got, want))
        errs["lstm_seq"] = max(errs["lstm_seq"], err)
        print(f"[K2] lstm_seq {label}: max abs err {err:.3e}")

    for B, block_b, T, chunks in [(1, 1, 128, (1, 128, 48)),
                                  (64, 4, 128, (1, 128, 48)),
                                  (37, 16, 50, (1, 50, 8))]:
        w, b, x = seq_case(2, 32, 32, B, T)
        outs = [seq_k.lstm_seq(w, b, x, block_b=block_b, time_chunk=tc)
                for tc in chunks]
        for tc, (c_k, h_k) in zip(chunks[1:], outs[1:]):
            check(torch.equal(c_k, outs[0][0]) and torch.equal(h_k, outs[0][1]),
                  f"lstm_seq B={B} T={T} time_chunk={tc} differs from tc=1")
        print(f"[K2] bit-identical across time_chunk {chunks} "
              f"(B={B}, block_b={block_b}, T={T})")

    # --- 3b. K2t: the trajectory launch against its plain version -----------
    for label, shape, kw in cases:
        w, b, x = seq_case(*shape)
        got = seq_k.lstm_seq_traj(w, b, x, **kw)
        want = ref.lstm_seq_traj(w, b, x)
        err = max(close(g, r, f"lstm_seq_traj {label}")
                  for g, r in zip(got, want))
        errs["lstm_seq_traj"] = max(errs["lstm_seq_traj"], err)
        c_p, h_p = seq_k.lstm_seq(w, b, x, **kw)
        check(torch.equal(got[0], c_p) and torch.equal(got[1], h_p),
              f"lstm_seq_traj {label}: final (c, h) differ from the plain "
              "launch")
        print(f"[K2t] lstm_seq_traj {label}: max abs err {err:.3e}; final "
              "(c, h) equal to the plain launch")
    for B, block_b, T, chunks in [(1, 1, 128, (1, 128, 48)),
                                  (64, 4, 128, (1, 128, 48)),
                                  (37, 16, 50, (1, 50, 8))]:
        w, b, x = seq_case(2, 32, 32, B, T)
        outs = [seq_k.lstm_seq_traj(w, b, x, block_b=block_b, time_chunk=tc)
                for tc in chunks]
        for tc, out in zip(chunks[1:], outs[1:]):
            check(all(torch.equal(g, r) for g, r in zip(out, outs[0])),
                  f"lstm_seq_traj B={B} T={T} time_chunk={tc} differs from "
                  "tc=1")
        print(f"[K2t] trajectories bit-identical across time_chunk {chunks} "
              f"(B={B}, block_b={block_b}, T={T})")

    # --- 3c. K3/K4b: the backward against its plain version and autograd ----
    def bwd_case(L, P, H, B, T):
        w, b, x = seq_case(L, P, H, B, T)
        return w, b, x, randn(L, B, H, gen=gen), randn(L, B, H, gen=gen)

    def autograd_ref(w, b, x, dc, dh):
        ins = [t.clone().requires_grad_() for t in (w, b, x)]
        return torch.autograd.grad(ref.lstm_seq(*ins), ins, (dc, dh))

    def bwd_run(w, b, x, dc, dh, block_b, tc):
        _, _, ct, ht = seq_k.lstm_seq_traj(w, b, x, block_b=block_b,
                                           time_chunk=tc)
        return bwd_k.lstm_seq_bwd(w, b, x, ct, ht, dc, dh, block_b=block_b,
                                  time_chunk=tc), (ct, ht)

    # a 16-row tile leaves room for 2-step windows only (168 KiB before any)
    bwd_cases = [("2x32 T=128 B=1", (2, 32, 32, 1, 128), None),
                 ("2x32 T=128 B=64", (2, 32, 32, 64, 128), None),
                 ("P>H hidden 8 input 9", (2, 9, 8, 3, 20), None),
                 ("batch tail B=37 tile 16 tc=2 T=50", (2, 32, 32, 37, 50),
                  (16, 2))]
    for label, shape, tiles in bwd_cases:
        w, b, x, dc, dh = bwd_case(*shape)
        L, P, H, B, T = shape
        tiles = tiles or tuple(seq_k.choose_batch_block(B, T, L, P, H,
                                                        mode="bwd"))
        got, (ct, ht) = bwd_run(w, b, x, dc, dh, *tiles)
        plain = bwd_k.lstm_seq_bwd_plain(w, b, x, ct, ht, dc, dh)
        auto = autograd_ref(w, b, x, dc, dh)
        err = max(close(g, r, f"lstm_seq_bwd {label} vs {what}", GRAD_TOL)
                  for want, what in ((plain, "plain"), (auto, "autograd"))
                  for g, r in zip(got, want))
        errs["lstm_seq_bwd"] = max(errs["lstm_seq_bwd"], err)
        again, _ = bwd_run(w, b, x, dc, dh, *tiles)
        check(all(torch.equal(g, r) for g, r in zip(got, again)),
              f"lstm_seq_bwd {label}: two identical calls differ")
        print(f"[K3] lstm_seq_bwd {label} tiles {tiles}: max abs err "
              f"{err:.3e} vs plain and autograd; two calls bit-identical")
    for B, block_b, T, chunks in [(1, 1, 128, (None, 1, 48, 32)),
                                  (64, 1, 128, (None, 1, 48)),
                                  (37, 8, 50, (1, 3, 4))]:
        w, b, x, dc, dh = bwd_case(2, 32, 32, B, T)
        outs = [bwd_run(w, b, x, dc, dh, block_b, tc)[0] for tc in chunks]
        for tc, out in zip(chunks[1:], outs[1:]):
            check(all(torch.equal(g, r) for g, r in zip(out, outs[0])),
                  f"lstm_seq_bwd B={B} T={T} time_chunk={tc} differs from "
                  f"{chunks[0]}")
        print(f"[K3] gradients bit-identical across time_chunk {chunks} "
              f"(B={B}, block_b={block_b}, T={T})")
    # 64 tiles draw the stream's ticket launch after launch; a second
    # stream draws its own
    w, b, x, dc, dh = bwd_case(2, 32, 32, 64, 128)
    base, (ct, ht) = bwd_run(w, b, x, dc, dh, 1, None)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs = [bwd_k.lstm_seq_bwd(w, b, x, ct, ht, dc, dh, block_b=1)
                for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    check(all(torch.equal(g, r) for out in outs for g, r in zip(out, base)),
          "lstm_seq_bwd on a second stream differs from the first")
    print("[K3] 3 more launches of 64 tiles on a second stream: "
          "bit-identical")
    w, b, x, dc, dh = bwd_case(2, 32, 32, 37, 50)
    base, _ = bwd_run(w, b, x, dc, dh, 1, 2)
    for block_b in (2, 4, 8, 16):
        got, _ = bwd_run(w, b, x, dc, dh, block_b, 2)
        for g, r in zip(got, base):
            close(g, r, f"lstm_seq_bwd block_b={block_b} vs 1", GRAD_TOL)
    print("[K3] batch tiles 1, 2, 4, 8, 16 agree (B=37, T=50, tc=2)")

    # --- 3d. the int8 instances (K5, K2t-q8, K3-q8) ------------------------
    q8_cases = cases + [("2x64 T=128 B=1", (2, 64, 64, 1, 128), {}),
                        ("3x64 T=128 B=1", (3, 64, 64, 1, 128), {}),
                        ("2x96 T=128 B=1", (2, 96, 96, 1, 128), {})]
    for label, shape, kw in q8_cases:
        w, b, x = seq_case(*shape)
        wq, s = ref.quantize_q8(w)
        got = seq_k.lstm_seq_q8(w, b, x, **kw)
        err = max(close(g, r, f"lstm_seq_q8 {label}")
                  for g, r in zip(got, seq_k.lstm_seq_q8_plain(wq, s, b, x)))
        oracle = max(close(g, r, f"lstm_seq_q8 {label} vs ref.lstm_seq_q8",
                           Q8_ORACLE_TOL)
                     for g, r in zip(got, ref.lstm_seq_q8(wq, s, b, x)))
        errs["lstm_seq_q8"] = max(errs["lstm_seq_q8"], err)
        traj = seq_k.lstm_seq_q8_traj(wq, s, b, x, **kw)
        terr = max(close(g, r, f"lstm_seq_q8_traj {label}") for g, r in zip(
            traj, seq_k.lstm_seq_q8_traj_plain(wq, s, b, x)))
        errs["lstm_seq_q8_traj"] = max(errs["lstm_seq_q8_traj"], terr)
        check(torch.equal(traj[0], got[0]) and torch.equal(traj[1], got[1]),
              f"lstm_seq_q8_traj {label}: final (c, h) differ from the "
              "plain q8 launch")
        print(f"[K5] lstm_seq_q8 {label}: max abs err {err:.3e} vs its plain"
              f" version, {oracle:.3e} vs ref.lstm_seq_q8; trajectory launch"
              f" {terr:.3e}, final (c, h) equal to the plain launch")
    # (a 16-row tile of T=50 has room for 24-step chunks, not 48)
    for B, block_b, T, chunks in [(1, 1, 128, (None, 1, 8, 48)),
                                  (64, 4, 128, (None, 1, 8, 48)),
                                  (37, 16, 50, (None, 1, 8, 24))]:
        w, b, x = seq_case(2, 32, 32, B, T)
        wq, s = ref.quantize_q8(w)
        outs = [seq_k.lstm_seq_q8_traj(wq, s, b, x, block_b=block_b,
                                       time_chunk=tc)
                for tc in chunks + chunks[:1]]       # and a second run
        check(all(torch.equal(g, r) for out in outs[1:]
                  for g, r in zip(out, outs[0])),
              f"lstm_seq_q8_traj B={B} T={T}: time_chunk {chunks} or a "
              "second run differ")
        plain = [seq_k.lstm_seq_q8(w, b, x, block_b=block_b, time_chunk=tc)
                 for tc in chunks]
        check(all(torch.equal(g, r) for out in plain[1:]
                  for g, r in zip(out, plain[0])),
              f"lstm_seq_q8 B={B} T={T}: time_chunk {chunks} differ")
        print(f"[K5] q8 forward and trajectories bit-identical across "
              f"time_chunk {chunks} and two runs (B={B}, block_b={block_b}, "
              f"T={T})")

    def q8_bwd_run(w, b, x, dc, dh, block_b, tc):
        wq, s = ref.quantize_q8(w)
        _, _, ct, ht = seq_k.lstm_seq_q8_traj(wq, s, b, x, block_b=block_b,
                                              time_chunk=tc)
        return bwd_k.lstm_seq_bwd_q8(wq, s, b, x, ct, ht, dc, dh,
                                     block_b=block_b, time_chunk=tc), \
            (wq, s, ct, ht)

    def ste_autograd(w, b, x, dc, dh):
        """autograd of the oracle over straight-through int8 weights."""
        ins = [t.clone().requires_grad_() for t in (w, b, x)]
        return torch.autograd.grad(ref.lstm_seq(
            ref.quantize_dequantize_ste(ins[0]), ins[1], ins[2]), ins,
            (dc, dh))

    for label, shape, tiles in bwd_cases:
        w, b, x, dc, dh = bwd_case(*shape)
        L, P, H, B, T = shape
        tiles = tiles or tuple(seq_k.choose_batch_block(
            B, T, L, P, H, mode="bwd", quantized=True))
        got, (wq, s, ct, ht) = q8_bwd_run(w, b, x, dc, dh, *tiles)
        plain = bwd_k.lstm_seq_bwd_plain(wq, b, x, ct, ht, dc, dh, scales=s)
        err = max(close(g, r, f"lstm_seq_bwd_q8 {label} vs {what}", GRAD_TOL)
                  for want, what in ((plain, "plain"),
                                     (ste_autograd(w, b, x, dc, dh),
                                      "autograd over STE weights"))
                  for g, r in zip(got, want))
        errs["lstm_seq_bwd_q8"] = max(errs["lstm_seq_bwd_q8"], err)
        again, _ = q8_bwd_run(w, b, x, dc, dh, *tiles)
        check(all(torch.equal(g, r) for g, r in zip(got, again)),
              f"lstm_seq_bwd_q8 {label}: two identical calls differ")
        print(f"[K3-q8] lstm_seq_bwd_q8 {label} tiles {tiles}: max abs err "
              f"{err:.3e} vs plain and autograd over STE weights (dw, db, "
              "dx); two calls bit-identical")
    for B, block_b, T, chunks in [(1, 1, 128, (None, 1, 8, 48)),
                                  (64, 1, 128, (None, 1, 48)),
                                  (37, 8, 50, (1, 3, 8))]:
        w, b, x, dc, dh = bwd_case(2, 32, 32, B, T)
        outs = [q8_bwd_run(w, b, x, dc, dh, block_b, tc)[0] for tc in chunks]
        for tc, out in zip(chunks[1:], outs[1:]):
            check(all(torch.equal(g, r) for g, r in zip(out, outs[0])),
                  f"lstm_seq_bwd_q8 B={B} T={T} time_chunk={tc} differs "
                  f"from {chunks[0]}")
        print(f"[K3-q8] gradients bit-identical across time_chunk {chunks} "
              f"(B={B}, block_b={block_b}, T={T})")
    w, b, x, dc, dh = bwd_case(2, 32, 32, 37, 50)
    base, _ = q8_bwd_run(w, b, x, dc, dh, 1, 2)
    for block_b in (2, 4, 8, 16):
        got, _ = q8_bwd_run(w, b, x, dc, dh, block_b, 2)
        for g, r in zip(got, base):
            close(g, r, f"lstm_seq_bwd_q8 block_b={block_b} vs 1", GRAD_TOL)
    print("[K3-q8] batch tiles 1, 2, 4, 8, 16 agree (B=37, T=50, tc=2)")

    cfg = LSTMConfig()
    T, L = cfg.seq_len, cfg.n_layers
    model = lstm.LSTMClassifier(
        cfg, generator=torch.Generator().manual_seed(0)).to(device)
    params = model.params()
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        reset_counts(*counted)
        with torch.inference_mode():
            x1 = randn(1, T, cfg.input_dim, gen=gen)
            routed = lstm.forward_fused_seq(params, x1, cfg, smem_budget=1024)
            want = lstm.forward_sequential(params, x1, cfg)
    finally:
        trace_lib.set_tracer(old)
    events = [r for r in sink.records if r["name"] == "plan/dispatch"]
    check(len(events) == 1
          and events[0]["attrs"].get("fallback") == "fused_cell",
          f"tiny budget should route to fused_cell with an event: {events}")
    check(counts() == only(lstm_cell=T * L),
          f"routed forward launched {counts()}")
    close(routed, want, "fused_seq routed to fused_cell")
    print(f"[K2] 1 KiB budget: routed to fused_cell ({T * L} cell launches, "
          "0 sequence launches) with plan/dispatch fallback=fused_cell")

    # --- 4. the serving path, counted -------------------------------------
    reset_counts(*counted)
    with tripwires(*plain_versions):
        served = classify.main(["--device", "cuda", "--requests", "32",
                                "--plan", "auto", "--seed", "0"])
    launches = counts()
    print(f"[slice] serving path launches: {launches}")
    for name in ("lstm_cell", "lstm_seq", "lstm_seq_q8"):
        check(launches[name] > 0, f"{name} was not launched serving")
    check(all(launches[n] == 0 for n in ("lstm_seq_traj", "lstm_seq_bwd",
                                         "lstm_seq_q8_traj",
                                         "lstm_seq_bwd_q8")),
          "serving launched a training kernel")
    check(served["logits"].shape == (32, cfg.n_classes)
          and bool(torch.isfinite(served["logits"]).all()),
          "served logits are not finite (32, 6)")

    def har_windows(n: int) -> torch.Tensor:
        return torch.tensor(har.make_har(n_train=1, n_test=n, seed=0)[1].x,
                            device=device)

    with torch.inference_mode():
        asked = har_windows(32)              # the windows classify served
        close(served["logits"], torch.cat([lstm.forward_sequential(
            params, asked[j:j + 1], cfg) for j in range(32)]),
            f"served through {served['served']} vs sequential",
            policy(served["served"]))
        windows = har_windows(64)
        ref_single = torch.cat([lstm.forward_sequential(
            params, windows[j:j + 1], cfg) for j in range(32)])
        ref_batch = lstm.forward_sequential(params, windows, cfg)
        for name, fwd in lstm.FORWARD_PLANS.items():
            single = torch.cat([fwd(params, windows[j:j + 1], cfg)
                                for j in range(32)])
            batch = fwd(params, windows, cfg)
            e1 = close(single, ref_single, f"{name} single-window",
                       policy(name))
            e2 = close(batch, ref_batch, f"{name} batch of 64", policy(name))
            print(f"[slice] {name}: 32 single + batch of 64 agree with "
                  f"sequential at {policy(name)} (max abs err "
                  f"{max(e1, e2):.3e})")
        for B in (1, 64):
            for fwd, want in ((lstm.forward_fused_seq, only(lstm_seq=1)),
                              (lstm.forward_fused_seq_q8,
                               only(lstm_seq_q8=1)),
                              (lstm.forward_fused_kernel,
                               only(lstm_cell=T * L))):
                reset_counts(*counted)
                fwd(params, windows[:B], cfg)
                check(counts() == want, f"{fwd.__name__} B={B}: {counts()}")
        print(f"[slice] launches per forward: fused_seq 1, fused_seq_q8 1, "
              f"fused_cell {T * L} (T x L) at B=1 and B=64")
    print(f"[slice] scheduler chose {served['chosen']}")

    # 2 x 64: the f32 stack fits no block, the int8 one does
    wide64 = cfg.with_complexity(64, 2)
    served64 = {}
    for plan in ("fused_seq_q8", "fused_seq"):
        sink = trace_lib.ListSink()
        old = trace_lib.set_tracer(trace_lib.Tracer(sink))
        try:
            reset_counts(*counted)
            with tripwires(*plain_versions):
                served64[plan] = classify.main(
                    ["--device", "cuda", "--requests", "16", "--plan", plan,
                     "--hidden", "64", "--seed", "0"])
            got = counts()
        finally:
            trace_lib.set_tracer(old)
        events = [r["attrs"] for r in sink.records
                  if r["name"] == "plan/dispatch"]
        calls = 2 * (1 + 16)        # warmup + 16 timed, twice (table, answer)
        if plan == "fused_seq_q8":
            check(got == only(lstm_seq_q8=calls) and all(
                "fallback" not in e for e in events),
                  f"2 x 64 fused_seq_q8: {got}, {events[:1]}")
        else:
            check(got == only(lstm_cell=calls * T * L) and all(
                e.get("fallback") == "fused_cell" for e in events),
                  f"2 x 64 fused_seq: {got}, {events[:1]}")
    p64 = lstm.LSTMClassifier(
        wide64, generator=torch.Generator().manual_seed(0)).to(device).params()
    with torch.inference_mode():
        asked64 = har_windows(16)
        want64 = torch.cat([lstm.forward_sequential(
            p64, asked64[j:j + 1], wide64) for j in range(16)])
    for plan, out in served64.items():
        close(out["logits"], want64, f"2 x 64 served through {plan}",
              policy(plan))
    print(f"[slice] 2 x 64, B=1: fused_seq_q8 1 q8 launch a request (p50 "
          f"{served64['fused_seq_q8']['table']['fused_seq_q8']['p50_ms']:.3f}"
          f" ms); fused_seq routed to fused_cell, {T * L} launches (p50 "
          f"{served64['fused_seq']['table']['fused_seq']['p50_ms']:.3f} ms)"
          ", each within its policy of sequential")

    # --- 4b. the training paths, counted ------------------------------------
    train_args = ["--device", "cuda", "--batch", "64", "--steps", "20",
                  "--n-train", "512", "--n-test", "256", "--latency-cases",
                  "0", "--seed", "0"]
    runs, train_launches = {}, {}
    for plan in ("fused_seq", "fused_seq_q8"):
        sink = trace_lib.ListSink()
        old = trace_lib.set_tracer(trace_lib.Tracer(sink))
        try:
            reset_counts(*counted)
            with tripwires(*plain_versions):
                runs[plan] = train_har.main(train_args + ["--plan", plan])
            train_launches[plan] = counts()
        finally:
            trace_lib.set_tracer(old)
        print(f"[train] {plan} training path launches: "
              f"{train_launches[plan]}")
        losses = runs[plan]["losses"]
        suffix = "_q8" if plan == "fused_seq_q8" else ""
        # 20 steps of two launches; train_har's two test-accuracy checks
        # (after step 1 and at the end) are one inference forward each
        check(train_launches[plan] == only(
            **{f"lstm_seq{suffix}_traj": 20, f"lstm_seq_bwd{suffix}": 20,
               f"lstm_seq{suffix}": 2}) and len(losses) == 20,
              f"20 {plan} steps launched {train_launches[plan]}")
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"{plan} losses not finite or not falling: {losses}")
        events = [r["attrs"] for r in sink.records
                  if r["name"] == "plan/dispatch" and r["attrs"]["train"]]
        check(len(events) == 20 and all(
            "fallback" not in e and e["bwd_block_b"] >= 1
            and e["plan"] == plan for e in events),
              f"a {plan} training call left its kernels: {events}")
        step_tiles = {(e["bwd_block_b"], e["bwd_time_chunk"])
                      for e in events if e["batch"] == 64}
        print(f"[train] {plan} losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"backward tiling {step_tiles} (no oracle)")
    trained, losses = runs["fused_seq"], runs["fused_seq"]["losses"]
    sequential = train_har.main(train_args + ["--plan", "sequential"])
    for i in range(3):
        check(math.isclose(losses[i], sequential["losses"][i],
                           rel_tol=GRAD_TOL["rtol"],
                           abs_tol=GRAD_TOL["atol"]),
              f"step {i + 1}: fused_seq loss {losses[i]} vs sequential "
              f"{sequential['losses'][i]}")
    print(f"[train] first 3 losses agree with sequential: {losses[:3]} vs "
          f"{sequential['losses'][:3]}")

    def ste_forward(p, x, cfg_):
        """sequential over straight-through int8 weights of the stacked
        layout: the q8 plan's training reference."""
        w, b, P = seq_k.stack_params(p["layers"], cfg_.hidden)
        _, h = ref.lstm_seq(ref.quantize_dequantize_ste(w), b,
                            seq_k.pad_input(x, P))
        return h[-1] @ p["head"]["w"] + p["head"]["b"]

    # train_har's first 3 steps (its data, batches, schedule) over STE
    train_set, _ = har.make_har(512, 256, seed=0)
    p_ste = lstm.LSTMClassifier(
        cfg, generator=torch.Generator().manual_seed(0)).to(device).params()
    opt = AdamW(lr=warmup_cosine(3e-3, 20 // 10, 20), weight_decay=0.0)
    state, batches = opt.init(p_ste), har.batches(train_set, 64, seed=0)
    q8_losses = runs["fused_seq_q8"]["losses"]
    for i in range(3):
        bx, by = next(batches)
        state, loss, _ = train_har.train_step(
            p_ste, state, torch.from_numpy(bx).to(device),
            torch.from_numpy(by).to(device=device, dtype=torch.long), cfg,
            ste_forward, opt)
        check(math.isclose(q8_losses[i], float(loss),
                           rel_tol=GRAD_TOL["rtol"],
                           abs_tol=GRAD_TOL["atol"]),
              f"step {i + 1}: fused_seq_q8 loss {q8_losses[i]} vs "
              f"sequential over STE weights {float(loss)}")
    print(f"[train] first 3 fused_seq_q8 losses agree with sequential over "
          f"straight-through int8 weights: {q8_losses[:3]}")

    def counted_step(forward, T_: int, cfg_=cfg, B_: int = 64) -> dict:
        model = lstm.LSTMClassifier(
            cfg_, generator=torch.Generator().manual_seed(1)).to(device)
        p = model.params()
        xs = randn(B_, T_, cfg_.input_dim, gen=gen)
        ys = torch.randint(0, cfg_.n_classes, (B_,), generator=gen).to(device)
        reset_counts(*counted)
        loss = lstm.loss_fn(p, xs, ys, cfg_, forward=forward)
        torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        return counts()

    for T_ in (128, 300):
        got = counted_step(lstm.forward_fused_seq, T_)
        check(got == only(lstm_seq_traj=1, lstm_seq_bwd=1),
              f"fused_seq training step at T={T_}: {got}")
        got = counted_step(lstm.forward_fused_seq_q8, T_)
        check(got == only(lstm_seq_q8_traj=1, lstm_seq_bwd_q8=1),
              f"fused_seq_q8 training step at T={T_}: {got}")
    got = counted_step(lstm.forward_fused_kernel, T)
    check(got == only(lstm_cell=T * L), f"fused_cell training step: {got}")
    print(f"[train] one step: fused_seq 2 launches (lstm_seq_traj 1, "
          f"lstm_seq_bwd 1) and fused_seq_q8 2 (lstm_seq_q8_traj 1, "
          f"lstm_seq_bwd_q8 1) at T=128 and T=300; fused_cell {T * L} cell "
          "launches and no backward kernel")

    # 2 x 48 (f32: the forward fits a block, the backward does not) and
    # 2 x 64 (q8: the same); both train on fused_cell
    for plan, hidden in (("fused_seq", 48), ("fused_seq_q8", 64)):
        wide = cfg.with_complexity(hidden, 2)
        wp = lstm.LSTMClassifier(
            wide, generator=torch.Generator().manual_seed(2)
        ).to(device).params()
        xs = randn(4, 16, wide.input_dim, gen=gen)
        ys = torch.randint(0, wide.n_classes, (4,), generator=gen).to(device)
        sink = trace_lib.ListSink()
        old = trace_lib.set_tracer(trace_lib.Tracer(sink))
        try:
            reset_counts(*counted)
            got = torch.autograd.grad(lstm.loss_fn(
                wp, xs, ys, wide, forward=lstm.FORWARD_PLANS[plan]),
                tree_leaves(wp))
            wide_launches = counts()
        finally:
            trace_lib.set_tracer(old)
        events = [r["attrs"] for r in sink.records
                  if r["name"] == "plan/dispatch"]
        check(wide_launches == only(lstm_cell=16 * 2)
              and len(events) == 1 and events[0]["train"]
              and events[0]["plan"] == plan
              and events[0].get("fallback") == "fused_cell",
              f"2 x {hidden} {plan} training step: {wide_launches}, "
              f"{events}")
        want = torch.autograd.grad(lstm.loss_fn(wp, xs, ys, wide),
                                   tree_leaves(wp))
        for g, r in zip(got, want):
            close(g, r, f"2 x {hidden} {plan} grads vs sequential", GRAD_TOL)
        w_s, b_s, P = seq_k.stack_params(wp["layers"], hidden)
        bare = seq_k.lstm_seq_q8 if plan == "fused_seq_q8" \
            else seq_k.lstm_seq
        try:
            bare(w_s, b_s, seq_k.pad_input(xs, P))
            raised = ""
        except ValueError as e:
            raised = str(e)
        check("working set" in raised,
              f"{bare.__name__} under autograd past the backward's budget: "
              f"{raised!r}")
        print(f"[train] 2 x {hidden} (backward fits no block): a {plan} "
              "step runs on fused_cell with the event and sequential's "
              f"grads; a bare {bare.__name__} call under autograd raises")

    def cudnn_lstm(w_s, b_s, P):
        """``nn.LSTM`` loaded with the stacked weights (TF32 off): one
        library call computing the sequence kernels' function."""
        L_, H_ = w_s.shape[0], w_s.shape[-1] // 4
        lib = torch.nn.LSTM(P, H_, num_layers=L_, batch_first=True
                            ).to(device).requires_grad_(False)
        for l in range(L_):
            getattr(lib, f"weight_ih_l{l}").copy_(
                w_s[l][:P if l == 0 else H_].T)
            getattr(lib, f"weight_hh_l{l}").copy_(w_s[l][P:].T)
            getattr(lib, f"bias_ih_l{l}").copy_(b_s[l])
            getattr(lib, f"bias_hh_l{l}").zero_()
        return lib

    def q8_rows(w_s, b_s, xp, B, dc, dh, extra=False) -> list[dict]:
        """Times of the q8 forward and, with cotangents, of the q8 training
        pair at the backward's tiling, each beside its plain version, its
        bound and cuDNN over the dequantized weights."""
        L_, H_ = w_s.shape[0], w_s.shape[-1] // 4
        P_, T_ = w_s.shape[1] - H_, xp.shape[1]
        wq, s = ref.quantize_q8(w_s)
        lib = cudnn_lstm(ref.dequantize_q8(wq, s), b_s, P_)
        c_k, h_k = seq_k.lstm_seq_q8(w_s, b_s, xp)
        _, (h_lib, c_lib) = lib(xp)
        close(c_lib, c_k, "nn.LSTM over dequantized weights vs lstm_seq_q8",
              Q8_ORACLE_TOL)
        close(h_lib, h_k, "nn.LSTM over dequantized weights vs lstm_seq_q8",
              Q8_ORACLE_TOL)
        # codes 1 byte, scales, bias and activations 4; (c, h) out
        q8_in = wq.numel() + 4 * (s.numel() + b_s.numel() + xp.numel())
        flops = T_ * 2 * B * 4 * H_ * ((P_ + H_) + (L_ - 1) * 2 * H_)
        fwd = seq_k.choose_batch_block(B, T_, L_, P_, H_, quantized=True)
        shape = f"B={B} T={T_} L={L_} P={P_} H={H_}"
        t_bound, by = bound(q8_in + 4 * 2 * L_ * B * H_, flops)
        rows = [dict(
            name="lstm_seq_q8", B=B, extra=extra, shape=shape,
            ms=time_ms(lambda: seq_k._launch(wq, b_s, xp, fwd.block_b,
                                             fwd.time_chunk, False, s), 100),
            entry_ms=time_ms(lambda: seq_k.lstm_seq_q8(w_s, b_s, xp), 100),
            plain_ms=time_ms(lambda: seq_k.lstm_seq_q8_plain(wq, s, b_s, xp),
                             2),
            library_ms=time_ms(lambda: lib(xp), 50),
            bound_ms=t_bound, bound_by=by)]
        if dc is None:
            return rows
        tiles = seq_k.choose_batch_block(B, T_, L_, P_, H_, mode="bwd",
                                         quantized=True)
        kw = dict(block_b=tiles.block_b, time_chunk=tiles.time_chunk)
        _, _, ct, ht = seq_k.lstm_seq_q8_traj(wq, s, b_s, xp, **kw)
        dw, db, dx = bwd_k.lstm_seq_bwd_q8(wq, s, b_s, xp, ct, ht, dc, dh,
                                           **kw)
        xg = xp.clone().requires_grad_()
        lib.requires_grad_(True)
        with torch.enable_grad():
            _, (h_lib, c_lib) = lib(xg)
            lib_in = [xg, *lib.parameters()]
            g_lib = torch.autograd.grad((h_lib, c_lib), lib_in, (dh, dc),
                                        retain_graph=True)
            close(g_lib[0], dx, "nn.LSTM backward vs lstm_seq_bwd_q8 dx",
                  GRAD_TOL)
            close(g_lib[3], db[0], "nn.LSTM backward vs lstm_seq_bwd_q8 db",
                  GRAD_TOL)
            traj_lib_ms = time_ms(lambda: lib(xg), 50)
            bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                (h_lib, c_lib), lib_in, (dh, dc), retain_graph=True), 50)
        state = 2 * T_ * L_ * B * H_                # both trajectories
        t_bound, by = bound(q8_in + 4 * (2 * L_ * B * H_ + state), flops)
        shape += f" tiles {tuple(tiles)}"
        rows.append(dict(
            name="lstm_seq_q8_traj", B=B, extra=extra, shape=shape,
            ms=time_ms(lambda: seq_k.lstm_seq_q8_traj(wq, s, b_s, xp, **kw),
                       100),
            plain_ms=time_ms(lambda: seq_k.lstm_seq_q8_traj_plain(
                wq, s, b_s, xp), 2),
            library_ms=traj_lib_ms, bound_ms=t_bound, bound_by=by))
        # codes, scales, b, x, both trajectories, dc, dh in; f32 dw, db and
        # dx out
        t_bound, by = bound(q8_in + 4 * (state + 2 * L_ * B * H_ + wq.numel()
                                         + b_s.numel() + xp.numel()),
                            3 * flops)
        rows.append(dict(
            name="lstm_seq_bwd_q8", B=B, extra=extra, shape=shape,
            ms=time_ms(lambda: bwd_k.lstm_seq_bwd_q8(
                wq, s, b_s, xp, ct, ht, dc, dh, **kw), 100),
            plain_ms=time_ms(lambda: bwd_k.lstm_seq_bwd_plain(
                wq, b_s, xp, ct, ht, dc, dh, scales=s), 2),
            library_ms=bwd_lib_ms, bound_ms=t_bound, bound_by=by))
        return rows

    # --- 5. times ----------------------------------------------------------
    # no_grad, not inference_mode: nn.LSTM's backward is timed in here too
    rows = []
    with torch.no_grad():
        for B in (1, 64):
            D = H = cfg.hidden
            lw = params["layers"][1]
            x = randn(B, D, gen=gen)
            c = randn(B, H, gen=gen)
            h = randn(B, H, gen=gen)
            lib = torch.nn.LSTMCell(D, H).to(device).requires_grad_(False)
            lib.weight_ih.copy_(lw["w"][:D].T)
            lib.weight_hh.copy_(lw["w"][D:].T)
            lib.bias_ih.copy_(lw["b"])
            lib.bias_hh.zero_()
            h_lib, c_lib = lib(x, (h, c))
            c_k, h_k = cell_k.lstm_cell(lw["w"], lw["b"], x, c, h)
            close(c_lib, c_k, "nn.LSTMCell vs lstm_cell")
            close(h_lib, h_k, "nn.LSTMCell vs lstm_cell")
            nbytes = 4 * (lw["w"].numel() + lw["b"].numel() + B * D
                          + 4 * B * H)      # x, c, h in; c', h' out
            t_bound, by = bound(nbytes, 2 * B * (D + H) * 4 * H)
            rows.append(dict(
                name="lstm_cell", B=B, shape=f"B={B} D={D} H={H}",
                ms=time_ms(lambda: cell_k.lstm_cell(lw["w"], lw["b"], x, c,
                                                    h), 200),
                plain_ms=time_ms(lambda: cell_k.lstm_cell_plain(
                    lw["w"], lw["b"], x, c, h), 200),
                library_ms=time_ms(lambda: lib(x, (h, c)), 200),
                bound_ms=t_bound, bound_by=by))

            w_s, b_s, P = seq_k.stack_params(params["layers"], H)
            xp = seq_k.pad_input(windows[:B], P)
            lib = cudnn_lstm(w_s, b_s, P)
            _, (h_lib, c_lib) = lib(xp)
            c_k, h_k = seq_k.lstm_seq(w_s, b_s, xp)
            close(c_lib, c_k, "nn.LSTM vs lstm_seq")
            close(h_lib, h_k, "nn.LSTM vs lstm_seq")
            nbytes = 4 * (xp.numel() + w_s.numel() + b_s.numel()
                          + 2 * L * B * H)
            flops = T * 2 * B * 4 * H * ((P + H) + (L - 1) * 2 * H)
            t_bound, by = bound(nbytes, flops)
            rows.append(dict(
                name="lstm_seq", B=B, shape=f"B={B} T={T} L={L} P={P} H={H}",
                ms=time_ms(lambda: seq_k.lstm_seq(w_s, b_s, xp), 100),
                plain_ms=time_ms(lambda: seq_k.lstm_seq_plain(w_s, b_s, xp),
                                 2),
                library_ms=time_ms(lambda: lib(xp), 50),
                bound_ms=t_bound, bound_by=by))

            # the training pair at the backward's tiling, beside nn.LSTM's
            # training forward and its backward (cuDNN, TF32 off)
            tiles = seq_k.choose_batch_block(B, T, L, P, H, mode="bwd")
            kw = dict(block_b=tiles.block_b, time_chunk=tiles.time_chunk)
            _, _, ct, ht = seq_k.lstm_seq_traj(w_s, b_s, xp, **kw)
            dc = torch.zeros(L, B, H, device=device)
            dh = randn(L, B, H, gen=gen)
            dw, db, dx = bwd_k.lstm_seq_bwd(w_s, b_s, xp, ct, ht, dc, dh,
                                            **kw)
            xg = xp.clone().requires_grad_()
            lib.requires_grad_(True)
            with torch.enable_grad():
                _, (h_lib, c_lib) = lib(xg)
                lib_in = [xg, *lib.parameters()]
                g_lib = torch.autograd.grad((h_lib, c_lib), lib_in,
                                            (dh, dc), retain_graph=True)
                close(g_lib[0], dx, "nn.LSTM backward vs lstm_seq_bwd dx",
                      GRAD_TOL)
                close(g_lib[3], db[0], "nn.LSTM backward vs lstm_seq_bwd db",
                      GRAD_TOL)
                traj_lib_ms = time_ms(lambda: lib(xg), 50)
                bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                    (h_lib, c_lib), lib_in, (dh, dc), retain_graph=True), 50)
            state = 2 * T * L * B * H                       # both trajectories
            t_bound, by = bound(4 * (xp.numel() + w_s.numel() + b_s.numel()
                                     + 2 * L * B * H + state), flops)
            rows.append(dict(
                name="lstm_seq_traj", B=B, tiles=tuple(tiles),
                shape=f"B={B} T={T} L={L} P={P} H={H} tiles {tuple(tiles)}",
                ms=time_ms(lambda: seq_k.lstm_seq_traj(w_s, b_s, xp, **kw),
                           100),
                plain_ms=time_ms(lambda: ref.lstm_seq_traj(w_s, b_s, xp), 2),
                library_ms=traj_lib_ms, bound_ms=t_bound, bound_by=by))
            # x, w, b, both trajectories, dc, dh in; dx, dw, db out
            t_bound, by = bound(4 * (2 * xp.numel() + 2 * w_s.numel()
                                     + 2 * b_s.numel() + state
                                     + 2 * L * B * H), 3 * flops)
            rows.append(dict(
                name="lstm_seq_bwd", B=B, tiles=tuple(tiles),
                shape=f"B={B} T={T} L={L} P={P} H={H} tiles {tuple(tiles)}",
                ms=time_ms(lambda: bwd_k.lstm_seq_bwd(
                    w_s, b_s, xp, ct, ht, dc, dh, **kw), 100),
                plain_ms=time_ms(lambda: bwd_k.lstm_seq_bwd_plain(
                    w_s, b_s, xp, ct, ht, dc, dh), 2),
                library_ms=bwd_lib_ms, bound_ms=t_bound, bound_by=by))

            # the int8 instances at the same shapes, beside nn.LSTM (cuDNN)
            # over the dequantized weights, the same function to
            # Q8_ORACLE_TOL; "ms" is the kernel's launch on the codes, the
            # public call adds the per-call quantize (printed beside)
            rows += q8_rows(w_s, b_s, xp, B, dc, dh)
        # 2 x 64, B=1: the int8 forward where the f32 one fits no block
        w64, b64, P64 = seq_k.stack_params(p64["layers"], 64)
        rows += q8_rows(w64, b64, seq_k.pad_input(windows[:1], P64), 1,
                        None, None, extra=True)
        # the backward's 8- and 16-row tiles, which batches past 132 SMs'
        # worth of rows take (timed here, not on the main path)
        for B in (1024, 2048):
            xb = randn(B, T, P, gen=gen)
            tiles = seq_k.choose_batch_block(B, T, L, P, H, mode="bwd")
            kw = dict(block_b=tiles.block_b, time_chunk=tiles.time_chunk)
            _, _, ct, ht = seq_k.lstm_seq_traj(w_s, b_s, xb, **kw)
            dc = torch.zeros(L, B, H, device=device)
            dh = randn(L, B, H, gen=gen)
            got = bwd_k.lstm_seq_bwd(w_s, b_s, xb, ct, ht, dc, dh, **kw)
            plain = bwd_k.lstm_seq_bwd_plain(w_s, b_s, xb, ct, ht, dc, dh)
            # dx elementwise; dw and db sum B x T terms in another order
            # than the plain version, so they are held to GRAD_TOL's rtol
            # of their largest entry
            err = close(got[2], plain[2], f"lstm_seq_bwd B={B} dx", GRAD_TOL)
            for g, r, what in zip(got[:2], plain[:2], ("dw", "db")):
                e = float((g - r).abs().max())
                check(e <= GRAD_TOL["rtol"] * float(r.abs().max()),
                      f"lstm_seq_bwd B={B} {what}: max abs err {e}")
                err = max(err, e)
            print(f"[K3] lstm_seq_bwd B={B} tiles {tuple(tiles)}: max abs "
                  f"err {err:.3e} vs plain (dw, db within {GRAD_TOL['rtol']}"
                  " of their largest entry)")
            xg = xb.clone().requires_grad_()
            with torch.enable_grad():
                _, (h_lib, c_lib) = lib(xg)
                lib_in = [xg, *lib.parameters()]
                bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                    (h_lib, c_lib), lib_in, (dh, dc), retain_graph=True), 20)
            state = 2 * T * L * B * H
            flops = T * 2 * B * 4 * H * ((P + H) + (L - 1) * 2 * H)
            t_bound, by = bound(4 * (2 * xb.numel() + 2 * w_s.numel()
                                     + 2 * b_s.numel() + state
                                     + 2 * L * B * H), 3 * flops)
            rows.append(dict(
                name="lstm_seq_bwd", B=B, tiles=tuple(tiles),
                shape=f"B={B} T={T} L={L} P={P} H={H} tiles {tuple(tiles)}",
                ms=time_ms(lambda: bwd_k.lstm_seq_bwd(
                    w_s, b_s, xb, ct, ht, dc, dh, **kw), 20),
                plain_ms=time_ms(lambda: bwd_k.lstm_seq_bwd_plain(
                    w_s, b_s, xb, ct, ht, dc, dh), 1, repeats=3),
                library_ms=bwd_lib_ms, bound_ms=t_bound, bound_by=by))
    for r in rows:
        entry = f" (public call, quantize included, {r['entry_ms']:.4f} ms)" \
            if "entry_ms" in r else ""
        print(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms"
              f"{entry}, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.3e} ms "
              f"({r['bound_by']})")
    for name, run in (("fused_seq", trained),
                      ("fused_seq_q8", runs["fused_seq_q8"]),
                      ("sequential", sequential)):
        print(f"[time] training step, {name}, batch 64: median "
              f"{statistics.median(run['step_ms']):.3f} ms, min "
              f"{min(run['step_ms']):.3f} ms over 20 steps (host clock "
              "around the step, ending in the loss's copy to the host)")

    # the serving path reads one window a request; the training path B=64
    source = {"lstm_cell": ("src/repro_torch/kernels/csrc/lstm_cell.cu",
                            "src/repro/kernels/lstm_cell.py:27", 1,
                            launches),
              "lstm_seq": ("src/repro_torch/kernels/csrc/lstm_seq.cu",
                           "src/repro/kernels/lstm_seq.py:317", 1, launches),
              "lstm_seq_traj": ("src/repro_torch/kernels/csrc/lstm_seq.cu",
                                "src/repro/kernels/lstm_seq.py:350", 64,
                                train_launches["fused_seq"]),
              "lstm_seq_bwd": ("src/repro_torch/kernels/csrc/lstm_seq_bwd.cu",
                               "src/repro/kernels/lstm_seq_bwd.py:134", 64,
                               train_launches["fused_seq"]),
              "lstm_seq_q8": ("src/repro_torch/kernels/csrc/lstm_seq.cu",
                              "src/repro/kernels/lstm_seq.py:340", 1,
                              launches),
              "lstm_seq_q8_traj": (
                  "src/repro_torch/kernels/csrc/lstm_seq.cu",
                  "src/repro/kernels/lstm_seq.py:374", 64,
                  train_launches["fused_seq_q8"]),
              "lstm_seq_bwd_q8": (
                  "src/repro_torch/kernels/csrc/lstm_seq_bwd.cu",
                  "src/repro/kernels/lstm_seq_bwd.py:197", 64,
                  train_launches["fused_seq_q8"])}
    kernels = []
    for r in rows:
        src_file, replaces, main_b, path = source[r["name"]]
        if r["B"] != main_b or r.get("extra"):
            continue
        kernels.append({
            "name": r["name"], "route": "cuda", "source": src_file,
            "replaces": replaces, "launches": path[r["name"]],
            "max_abs_err": errs[r["name"]], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
