#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Builds the hand-written kernels of the serving and training paths from
``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) into ``build/``, holds each
kernel against its plain PyTorch version on the card (the backward also
against torch autograd of the oracle), serves the paper's HAR classifier
(2 layers x 32 hidden, T=128) through the port's entry point
``repro_torch.launch.classify`` and trains it at batch 64 through
``repro_torch.launch.train_har``, each with the launch counters set to 0
just before and read just after, checks the four plans agree, that a
``fused_seq`` training step is two launches at any T, and times each
kernel beside its plain version, one PyTorch library call computing the same
function, and the least time the card could take for the work.

Float32 matrix products and cuDNN run without TF32 here
(``allow_tf32 = False`` for both), so the plain versions and the library
calls are true f32 references.

Exits nonzero if there is no CUDA device, if the port's sources are not
beside this script, or if any check fails.  Its last lines are the card's
name and power limit (from nvidia-smi), one JSON object with every kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
    """The template arguments of a mangled kernel name, e.g. ``<16,512>``
    for ``lstm_seq_bwd_kernel<16, 512>`` (a bool argument prints 0 or 1)."""
    args = re.search(r"I((?:L[ib]\d+E)+)E", mangled)
    return "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">" \
        if args else ""


def randn(*shape, gen, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).cuda()


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
    from repro_torch.core import lstm
    from repro_torch.kernels import _build
    from repro_torch.kernels import lstm_cell as cell_k
    from repro_torch.kernels import lstm_seq as seq_k
    from repro_torch.kernels import lstm_seq_bwd as bwd_k
    from repro_torch.kernels import ref
    from repro_torch.launch import classify, train_har
    from repro_torch.obs import trace as trace_lib
    from repro_torch.data import har
    from repro_torch.optim.adamw import tree_leaves

    counted = (cell_k.lstm_cell, seq_k.lstm_seq, seq_k.lstm_seq_traj,
               bwd_k.lstm_seq_bwd)

    def counts() -> dict:
        return {fn.__name__: fn.launches for fn in counted}

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
    check(seq_k.lstm_seq.launches == 0
          and cell_k.lstm_cell.launches == T * L,
          f"routed forward launched lstm_seq {seq_k.lstm_seq.launches}x, "
          f"lstm_cell {cell_k.lstm_cell.launches}x")
    close(routed, want, "fused_seq routed to fused_cell")
    print(f"[K2] 1 KiB budget: routed to fused_cell ({T * L} cell launches, "
          "0 sequence launches) with plan/dispatch fallback=fused_cell")

    # --- 4. the serving path, counted --------------------------------------
    reset_counts(*counted)
    served = classify.main(["--device", "cuda", "--requests", "32",
                            "--plan", "auto", "--seed", "0"])
    launches = counts()
    print(f"[slice] serving path launches: {launches}")
    for name in ("lstm_cell", "lstm_seq"):
        check(launches[name] > 0, f"{name} was not launched serving")
    check(launches["lstm_seq_traj"] == launches["lstm_seq_bwd"] == 0,
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
            f"served through {served['served']} vs sequential")
        windows = har_windows(64)
        ref_single = torch.cat([lstm.forward_sequential(
            params, windows[j:j + 1], cfg) for j in range(32)])
        ref_batch = lstm.forward_sequential(params, windows, cfg)
        for name, fwd in lstm.FORWARD_PLANS.items():
            single = torch.cat([fwd(params, windows[j:j + 1], cfg)
                                for j in range(32)])
            batch = fwd(params, windows, cfg)
            e1 = close(single, ref_single, f"{name} single-window")
            e2 = close(batch, ref_batch, f"{name} batch of 64")
            print(f"[slice] {name}: 32 single + batch of 64 agree with "
                  f"sequential (max abs err {max(e1, e2):.3e})")
        for B in (1, 64):
            reset_counts(*counted)
            lstm.forward_fused_seq(params, windows[:B], cfg)
            check(counts() == {"lstm_cell": 0, "lstm_seq": 1,
                               "lstm_seq_traj": 0, "lstm_seq_bwd": 0},
                  f"fused_seq B={B}: {counts()}")
            reset_counts(*counted)
            lstm.forward_fused_kernel(params, windows[:B], cfg)
            check(counts() == {"lstm_cell": T * L, "lstm_seq": 0,
                               "lstm_seq_traj": 0, "lstm_seq_bwd": 0},
                  f"fused_cell B={B}: {counts()}")
        print(f"[slice] launches per forward: fused_seq 1, fused_cell "
              f"{T * L} (T x L) at B=1 and B=64")
    print(f"[slice] scheduler chose {served['chosen']}")

    # --- 4b. the training path, counted -------------------------------------
    train_args = ["--device", "cuda", "--batch", "64", "--steps", "20",
                  "--n-train", "512", "--n-test", "256", "--latency-cases",
                  "0", "--seed", "0"]
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        reset_counts(*counted)
        trained = train_har.main(train_args + ["--plan", "fused_seq"])
        train_launches = counts()
    finally:
        trace_lib.set_tracer(old)
    print(f"[train] training path launches: {train_launches}")
    losses = trained["losses"]
    check(train_launches["lstm_seq_traj"] == train_launches["lstm_seq_bwd"]
          == len(losses) == 20 and train_launches["lstm_cell"] == 0,
          f"20 fused_seq steps launched {train_launches}")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"fused_seq losses not finite or not falling: {losses}")
    events = [r["attrs"] for r in sink.records
              if r["name"] == "plan/dispatch" and r["attrs"]["train"]]
    check(len(events) == 20 and all(
        "fallback" not in e and e["bwd_block_b"] >= 1 for e in events),
          f"a fused_seq training call left its kernels: {events}")
    step_tiles = {(e["bwd_block_b"], e["bwd_time_chunk"]) for e in events
                  if e["batch"] == 64}
    print(f"[train] fused_seq losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"backward tiling {step_tiles} (no oracle)")
    sequential = train_har.main(train_args + ["--plan", "sequential"])
    for i in range(3):
        check(math.isclose(losses[i], sequential["losses"][i],
                           rel_tol=GRAD_TOL["rtol"],
                           abs_tol=GRAD_TOL["atol"]),
              f"step {i + 1}: fused_seq loss {losses[i]} vs sequential "
              f"{sequential['losses'][i]}")
    print(f"[train] first 3 losses agree with sequential: {losses[:3]} vs "
          f"{sequential['losses'][:3]}")

    def counted_step(forward, T_: int) -> dict:
        model = lstm.LSTMClassifier(
            cfg, generator=torch.Generator().manual_seed(1)).to(device)
        p = model.params()
        xs = randn(64, T_, cfg.input_dim, gen=gen)
        ys = torch.randint(0, cfg.n_classes, (64,), generator=gen).to(device)
        reset_counts(*counted)
        loss = lstm.loss_fn(p, xs, ys, cfg, forward=forward)
        torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        return counts()

    for T_ in (128, 300):
        got = counted_step(lstm.forward_fused_seq, T_)
        check(got == {"lstm_cell": 0, "lstm_seq": 0, "lstm_seq_traj": 1,
                      "lstm_seq_bwd": 1},
              f"fused_seq training step at T={T_}: {got}")
    got = counted_step(lstm.forward_fused_kernel, T)
    check(got == {"lstm_cell": T * L, "lstm_seq": 0, "lstm_seq_traj": 0,
                  "lstm_seq_bwd": 0}, f"fused_cell training step: {got}")
    print(f"[train] one step: fused_seq 2 launches (lstm_seq_traj 1, "
          f"lstm_seq_bwd 1) at T=128 and T=300; fused_cell {T * L} cell "
          "launches and no backward kernel")

    # 2 x 48: the forward fits a thread block, the backward does not
    wide = cfg.with_complexity(48, 2)
    wp = lstm.LSTMClassifier(
        wide, generator=torch.Generator().manual_seed(2)).to(device).params()
    xs = randn(4, 16, wide.input_dim, gen=gen)
    ys = torch.randint(0, wide.n_classes, (4,), generator=gen).to(device)
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        reset_counts(*counted)
        got = torch.autograd.grad(lstm.loss_fn(
            wp, xs, ys, wide, forward=lstm.forward_fused_seq),
            tree_leaves(wp))
        wide_launches = counts()
    finally:
        trace_lib.set_tracer(old)
    events = [r["attrs"] for r in sink.records
              if r["name"] == "plan/dispatch"]
    check(wide_launches == {"lstm_cell": 16 * 2, "lstm_seq": 0,
                            "lstm_seq_traj": 0, "lstm_seq_bwd": 0}
          and len(events) == 1 and events[0]["train"]
          and events[0].get("fallback") == "fused_cell",
          f"2 x 48 training step: {wide_launches}, {events}")
    want = torch.autograd.grad(lstm.loss_fn(wp, xs, ys, wide),
                               tree_leaves(wp))
    for g, r in zip(got, want):
        close(g, r, "2 x 48 fused_seq grads vs sequential", GRAD_TOL)
    w_s, b_s, P = seq_k.stack_params(wp["layers"], 48)
    try:
        seq_k.lstm_seq(w_s, b_s, seq_k.pad_input(xs, P))
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("working set" in raised,
          f"lstm_seq under autograd past the backward's budget: {raised!r}")
    print("[train] 2 x 48 (backward fits no block): a fused_seq step runs "
          "on fused_cell with the event and sequential's grads; a bare "
          "lstm_seq call under autograd raises")

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
            lib = torch.nn.LSTM(P, H, num_layers=L, batch_first=True
                                ).to(device).requires_grad_(False)
            for l in range(L):
                getattr(lib, f"weight_ih_l{l}").copy_(
                    w_s[l][:P if l == 0 else H].T)
                getattr(lib, f"weight_hh_l{l}").copy_(w_s[l][P:].T)
                getattr(lib, f"bias_ih_l{l}").copy_(b_s[l])
                getattr(lib, f"bias_hh_l{l}").zero_()
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
        print(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f}"
              f" ms, bound {r['bound_ms']:.3e} ms ({r['bound_by']})")
    for name, run in (("fused_seq", trained), ("sequential", sequential)):
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
                                train_launches),
              "lstm_seq_bwd": ("src/repro_torch/kernels/csrc/lstm_seq_bwd.cu",
                               "src/repro/kernels/lstm_seq_bwd.py:134", 64,
                               train_launches)}
    kernels = []
    for r in rows:
        src_file, replaces, main_b, path = source[r["name"]]
        if r["B"] != main_b:
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
