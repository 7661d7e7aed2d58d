#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Builds the hand-written kernels of the serving path from
``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) into ``build/``, holds each
kernel against its plain PyTorch version on the card, serves the paper's HAR
classifier (2 layers x 32 hidden, T=128) through the port's entry point
``repro_torch.launch.classify`` with the launch counters set to 0 just
before and read just after, checks the four plans agree, and times each
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
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

#: The JAX package's f32 tolerance for LSTM plans and kernels (LSTM_TOL).
TOL = dict(rtol=2e-5, atol=2e-5)
#: Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores — the kernels use CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
REPO = Path(__file__).resolve().parent


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Assert agreement at TOL; return the max abs error."""
    torch.testing.assert_close(got, want, **TOL, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


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
    from repro_torch.launch import classify
    from repro_torch.obs import trace as trace_lib
    from repro_torch.data import har

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
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(1234)
    errs = {"lstm_cell": 0.0, "lstm_seq": 0.0}

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

    cfg = LSTMConfig()
    T, L = cfg.seq_len, cfg.n_layers
    model = lstm.LSTMClassifier(
        cfg, generator=torch.Generator().manual_seed(0)).to(device)
    params = model.params()
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        cell_k.lstm_cell.launches = seq_k.lstm_seq.launches = 0
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

    # --- 4. the slice: the serving entry point, counted --------------------
    cell_k.lstm_cell.launches = seq_k.lstm_seq.launches = 0
    served = classify.main(["--device", "cuda", "--requests", "32",
                            "--plan", "auto", "--seed", "0"])
    launches = {"lstm_cell": cell_k.lstm_cell.launches,
                "lstm_seq": seq_k.lstm_seq.launches}
    print(f"[slice] main path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
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
            cell_k.lstm_cell.launches = seq_k.lstm_seq.launches = 0
            lstm.forward_fused_seq(params, windows[:B], cfg)
            check(seq_k.lstm_seq.launches == 1
                  and cell_k.lstm_cell.launches == 0,
                  f"fused_seq B={B}: {seq_k.lstm_seq.launches} launches")
            cell_k.lstm_cell.launches = seq_k.lstm_seq.launches = 0
            lstm.forward_fused_kernel(params, windows[:B], cfg)
            check(cell_k.lstm_cell.launches == T * L
                  and seq_k.lstm_seq.launches == 0,
                  f"fused_cell B={B}: {cell_k.lstm_cell.launches} launches")
        print(f"[slice] launches per forward: fused_seq 1, fused_cell "
              f"{T * L} (T x L) at B=1 and B=64")
    print(f"[slice] scheduler chose {served['chosen']}")

    # --- 5. times ----------------------------------------------------------
    rows = []
    with torch.inference_mode():
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
    for r in rows:
        print(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f}"
              f" ms, bound {r['bound_ms']:.3e} ms ({r['bound_by']})")

    source = {"lstm_cell": ("src/repro_torch/kernels/csrc/lstm_cell.cu",
                            "src/repro/kernels/lstm_cell.py:27"),
              "lstm_seq": ("src/repro_torch/kernels/csrc/lstm_seq.cu",
                           "src/repro/kernels/lstm_seq.py:317")}
    kernels = []
    for r in rows:
        if r["B"] != 1:           # the main path serves one window a request
            continue
        src_file, replaces = source[r["name"]]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": src_file,
            "replaces": replaces, "launches": launches[r["name"]],
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
