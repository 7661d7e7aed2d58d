#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Builds the hand-written kernels of the serving and training paths from
``src/repro_torch/kernels/csrc`` (nvcc, sm_90a, one process per source, all
at once) into ``build/``, holds each kernel, f32, int8 and bf16 instances,
against its plain PyTorch version on the card (the LSTM backward also
against torch autograd of the oracle), serves the paper's HAR classifier
(2 layers x 32 hidden, T=128) through the port's entry point
``repro_torch.launch.classify`` with all five plans, and at 2 x 64 through
the int8 plan, and trains it at batch 64 through
``repro_torch.launch.train_har`` with ``fused_seq`` and with the int8 plan
``fused_seq_q8``, each path with the launch counters set to 0 just before
and read just after and the plain versions of the sequence kernels armed to
raise on CUDA tensors; checks each plan against ``sequential`` under its own
policy, that a ``fused_seq`` and a ``fused_seq_q8`` training step is two
launches at any T.  Then the RWKV6 slice: the K6 chunked scan against its
plain version (the JAX family's cases, the full-width heads at T=512 and
500, extreme decay, rows alone and in a batch, a split-resume run), the
full-width model cut to 4 layers in f32 (the kernel plan against
``chunked_xla``, prefill plus decode against ``forward``), and the full
32-layer bf16 RWKV6-3B served through ``repro_torch.launch.serve``'s wave
engine: 8 ragged requests of 300 to 500 tokens, 16 new tokens each, with
32 kernel launches per prefill, none in decode and the plain scans armed to
raise, every launch of the serve held against the plain version on the
inputs it was given, then the same requests with
``models.rwkv.WKV_PLAN = "chunked_xla"`` (and the waves' prefills through
``stepwise``: the first-token logits of the three plans are printed beside
each other).  Then the RWKV6 training slice: the trajectory forward K6t
and the backward K6b against their plain versions and torch autograd (the
same cases), the 4-layer f32 model's ``loss_fn`` gradients through the
kernels against those through ``chunked_xla``, with remat on and off and
its launches per step against the JAX package's dispatch count, and
RWKV6-3B trained at full width and depth in bf16 through
``repro_torch.launch.train`` (8 steps of batch 4 x 512, the plain scans
armed to raise, every K6b launch of step 1 held against its plain
version, the last step under torch.profiler for where the device's time
goes).  Then the Mamba slice: the selective scan K7, its trajectory
instance K7t and its backward K7b against their plain versions and torch
autograd (the JAX family's cases and Jamba's width, d_inner 16384 and
d_state 16, at B=4 x T=512 and 500; bit-identity across chunks, tiles,
rows and a split-resume; two runs of K7b equal; finite at dt x 1e4), the
attention-free Jamba stack at full width cut to 2 layers in f32 (the
kernel plan against ``scan``, prefill plus decode against ``forward``,
``loss_fn`` gradients across plans with remat on and off and its launches
a step), and the same stack in bf16, 3.12 B parameters, served through
``repro_torch.launch.serve`` (8 ragged requests of 300 to 500 tokens, 16
new tokens each, one K7 a layer per prefill and per decode step, each
launch held against the plain version on its own inputs) and trained
through ``repro_torch.launch.train.train`` (8 steps of batch 4 x 512, two
K7t and one K7b a layer a step, step 1's K7b launches held against plain,
the last two steps under torch.profiler).
It times each kernel beside its plain version, one PyTorch library call
computing the same function where there is one, and the least time the
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
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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
#: The split-resume tolerance of the JAX package's tests/test_wkv6.py.
SPLIT_TOL = dict(rtol=2e-4, atol=2e-4)
#: Prefill plus decode against the full forward: tests/test_consistency.py.
CONSISTENCY_TOL = dict(rtol=3e-4, atol=3e-4)
#: Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores — the kernels use CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: Its bf16 dense tensor-core peak: the yardstick of a training step's
#: model FLOPs and of the kernels that run on the tensor cores.
BF16_FLOP_PER_S = 989e12
#: Its TF32 dense tensor-core peak: the tier the chunk products of K6, K6t
#: and K6b would reach on the tensor cores (they run on the CUDA cores in
#: f32; their bounds are stated at both rates).
TF32_FLOP_PER_S = 495e12
#: nvcc's output per source of this run's build (ptxas registers and spills)
BUILD_LOGS: dict[str, str] = {}
#: JAX's Pallas dispatches of one value_and_grad of its loss_fn through
#: chunked_scan at 4 layers, with remat (the trajectory forward, its
#: recompute and the backward: 3 a layer) and without (2 a layer); pinned
#: on the CPU by tests/test_torch_lm_train.py.
JAX_TRAIN_DISPATCHES_4 = {True: 12, False: 8}
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
        if hasattr(fn, "tc_launches"):      # K8's tensor-core launches
            fn.tc_launches = 0
        if hasattr(fn, "reg_launches"):     # K2's register weight home
            fn.reg_launches = 0


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


def graph_ms(fn, calls: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, its replay timed by ``time_ms``; the host's per-call work (the
    wrapper, the launch) is left out."""
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
    return time_ms(graph.replay, 5) / calls


def bound(nbytes: int, flops: int, flop_rate: float = F32_FLOP_PER_S
          ) -> tuple[float, str]:
    """Least time in ms for the work, and which of the two bounds it: the
    bytes at the HBM rate, the operations at ``flop_rate`` (the f32 rate
    of the CUDA cores unless the inputs' type has a faster peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def instance(mangled: str) -> str:
    """The template arguments of a mangled kernel name, in order, e.g.
    ``<16,512,int8>`` for ``lstm_seq_bwd_kernel<16, 512, int8_t>``,
    ``<bf16,1>`` for ``mamba_scan_kernel<__nv_bfloat16, true>`` (a bool
    argument prints 0 or 1), ``<f32,160>`` for
    ``flash_prefill_kernel<float, 160>`` or ``<1,1,int8,1>`` for
    ``lstm_seq_fwd_kernel<1, true, int8_t, true>``."""
    args = re.search(r"I((?:L[ib]\d+E|f|a|13__nv_bfloat16)+)E", mangled)
    if not args:
        return ""
    names = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}
    return "<" + ",".join(
        tok[0] or names[tok[1]] for tok in re.findall(
            r"L[ib](\d+)E|(f|a|13__nv_bfloat16)", args.group(1))) + ">"


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


def wkv_inputs(BH, T, dk, dv, dtype, gen, decay=1.0):
    """r, k, v in ``dtype``; logw (<= 0, scaled by ``decay``), u and the
    state f32; on the card."""
    r, k = (randn(BH, T, dk, gen=gen).to(dtype) for _ in range(2))
    v = randn(BH, T, dv, gen=gen).to(dtype)
    logw = -torch.exp(randn(BH, T, dk, gen=gen)) * decay
    return (r, k, v, logw, randn(BH, dk, gen=gen),
            randn(BH, dk, dv, gen=gen, scale=0.3))


def wkv6_fwd_work(BH, T, dk, dv, C, dtype, traj=False) -> tuple[int, int]:
    """(bytes, operations) of one K6 launch (K6t with ``traj``): r, k, v
    in and out in the IO type, logw f32, u, s0 and s_out f32 (and s_traj
    f32 out); per chunk of a row the carry, the scores (sub, 2 mul, add),
    scores x v, the bonus, bonus x v, the state update and the decays."""
    io = 2 if dtype == torch.bfloat16 else 4
    nt = -(-T // C)
    nbytes = (io * BH * T * (2 * dk + 2 * dv) + 4 * BH * T * dk
              + 4 * (BH * dk + 2 * BH * dk * dv))
    if traj:
        nbytes += 4 * BH * nt * dk * dv
    pairs = C * (C - 1) // 2
    per_chunk = (2 * C * dk * dv + 4 * pairs * dk + 2 * pairs * dv
                 + 3 * C * dk + 2 * C * dv + 2 * C * dk * dv + dk * dv
                 + 3 * C * dk)
    return nbytes, BH * nt * per_chunk


def wkv6_bwd_work(BH, T, dk, dv, C, dtype) -> tuple[int, int]:
    """(bytes, operations) that the chunk backward of ``kernels/wkv6.py``'s
    docstring needs, each distinct product and exponential counted once (a
    multiply-add is 2 operations, an exponential 1), whatever the kernel
    recomputes: r, k, v, dout in and dr, dk, dv out in the IO type; logw in
    and dlogw out, u, du, the chunk-incoming states, s_fin, ds_fin and ds0
    f32.  Per chunk of a row: four (C, dk, dv) products (dv's state term
    through k e^{Llast - L}, dr's carry S dO, dk's v . dS', the dS update
    through r e^{L_prev}); for each of the C(C-1)/2 pairs over dk the decay
    (sub, exp), k times it, A, dr's term, r times it and dk's term, and over
    dv dA and dv's term; per (i, c) the cumsum, the two decays and their
    products with r and k, the bonus and its three gradient terms, du, the
    two scalings, dlogw's two inputs, the state term and the reverse
    cumsums; per (i, n) db and dv's bonus term; dS' scaled and Llast's
    term."""
    io = 2 if dtype == torch.bfloat16 else 4
    nt = -(-T // C)
    nbytes = (io * BH * T * (4 * dk + 3 * dv) + 4 * BH * T * 2 * dk
              + 4 * 2 * BH * dk + 4 * BH * nt * dk * dv
              + 4 * 3 * BH * dk * dv)
    pairs = C * (C - 1) // 2
    per_chunk = (8 * C * dk * dv
                 + pairs * (10 * dk + 4 * dv)
                 + 26 * C * dk + 4 * C * dv
                 + 3 * dk * dv + 3 * dk)
    return nbytes, BH * nt * per_chunk


def rwkv_slice(device, gen, counted, counts, only) -> dict:
    """The RWKV6 slice: K6 against its plain version, the 4-layer f32 model
    across plans and against its own forward, the 32-layer bf16 RWKV6-3B
    served through ``launch/serve.py`` (counted, plain scans armed), and
    K6's times.  Returns K6's entry of the ``kernels`` line."""
    from repro_torch.configs import get_arch
    from repro_torch.core import plans
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wkv6_k
    from repro_torch.launch import serve as serve_lm
    from repro_torch.models import registry, rwkv
    from repro_torch import steps as steps_lib
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serving import Request

    bf16, f32 = torch.bfloat16, torch.float32
    tol = plans.RWKV_TOL

    def inputs(BH, T, dk, dv, dtype, decay=1.0):
        return wkv_inputs(BH, T, dk, dv, dtype, gen, decay)

    # --- R1. K6 against its plain version -----------------------------------
    errs = {"float32": 0.0, "bfloat16": 0.0}
    fam = plans.get_family("rwkv6")
    cases = [(c.label, (c.shape[0] * c.shape[2], c.shape[1], c.shape[3],
                        c.shape[4], c.shape[5])) for c in fam.cases]
    cases += [(f"full width T={T}", (160, T, 64, 64, 32)) for T in (512, 500)]
    for label, (BH, T, dk, dv, C) in cases:
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[1]
            a = inputs(BH, T, dk, dv, dtype)
            got = wkv6_k.wkv6(*a, chunk=C)
            want = wkv6_k.wkv6_plain(*a, chunk=C)
            check(got[0].dtype == dtype and got[1].dtype == f32,
                  f"wkv6 {label} {name}: output dtypes {got[0].dtype}, "
                  f"{got[1].dtype}")
            # the state is f32 math on the same inputs: the f32 tier
            e = max(close(got[0].float(), want[0].float(),
                          f"wkv6 {label} {name} out", tol[name]),
                    close(got[1], want[1], f"wkv6 {label} {name} state",
                          tol["float32"]))
            errs[name] = max(errs[name], e)
            print(f"[K6] wkv6 {label} (BH={BH} T={T} {dk}x{dv} C={C}) "
                  f"{name}: max abs err {e:.3e} at RWKV_TOL {name} (state "
                  "at RWKV_TOL float32)")
    for dtype in (f32, bf16):
        for BH, T, dk, dv, C in ((4, 19, 8, 8, 8), (160, 500, 64, 64, 32)):
            out, s = wkv6_k.wkv6(*inputs(BH, T, dk, dv, dtype, decay=1e6),
                                 chunk=C)
            check(bool(torch.isfinite(out.float()).all())
                  and bool(torch.isfinite(s).all()),
                  f"wkv6 BH={BH} T={T} {dtype} not finite at log-decays of "
                  "-1e6")
    print("[K6] finite at single-step log-decays down to -1e6 (f32, bf16; "
          "T=19 and the full width at T=500)")
    a = inputs(5, 23, 64, 64, f32)
    base = wkv6_k.wkv6(*a, chunk=8)
    for bt in (2, 5):
        check(all(torch.equal(g, w) for g, w in zip(
            wkv6_k.wkv6(*a, chunk=8, bh_tile=bt), base)),
              f"wkv6 bh_tile={bt} differs from bh_tile=1")
    for i in range(5):
        alone = wkv6_k.wkv6(*(t[i:i + 1] for t in a), chunk=8)
        check(all(torch.equal(g[0], w[i]) for g, w in zip(alone, base)),
              f"wkv6 row {i} alone differs from the batch")
    a = inputs(160, 500, 64, 64, bf16)
    base = wkv6_k.wkv6(*a, chunk=32)
    for i in (0, 77, 159):
        alone = wkv6_k.wkv6(*(t[i:i + 1] for t in a), chunk=32)
        check(all(torch.equal(g[0], w[i]) for g, w in zip(alone, base)),
              f"wkv6 full-width row {i} alone differs from the batch")
    print("[K6] rows bit-identical alone and in a batch (BH=5, T=23, tiles "
          "1, 2, 5; bf16 rows 0, 77, 159 of 160 at T=500)")
    r, k, v, logw, u, s0 = inputs(160, 512, 64, 64, f32)
    out, s_full = wkv6_k.wkv6(r, k, v, logw, u, s0)
    out_a, s_mid = wkv6_k.wkv6(r[:, :300], k[:, :300], v[:, :300],
                               logw[:, :300], u, s0)
    out_b, s_end = wkv6_k.wkv6(r[:, 300:], k[:, 300:], v[:, 300:],
                               logw[:, 300:], u, s_mid)
    e = max(close(torch.cat([out_a, out_b], 1), out, "wkv6 split at 300",
                  SPLIT_TOL),
            close(s_end, s_full, "wkv6 split state", SPLIT_TOL))
    print(f"[K6] split at 300 of 512 and resumed from the carried state: "
          f"max abs err {e:.3e} against the unsplit run")

    # --- R2. the full-width model cut to 4 layers, f32 ---------------------
    cfg4 = dataclasses.replace(get_arch("rwkv6-3b"), n_layers=4,
                               dtype="float32")
    m4 = registry.build(cfg4)
    cgen = torch.Generator(device=device).manual_seed(0)
    p4 = m4.init(cgen, device)
    mix, mlp = p4["blocks"][0]["mix"], p4["blocks"][0]["mlp"]
    for t in (mix["maa_x"], mix["maa"], mix["u"], mlp["mu_k"], mlp["mu_r"]):
        t.add_(0.1 * torch.randn(t.shape, generator=cgen, device=device))
    S, K = 300, 4
    toks = torch.randint(0, cfg4.vocab, (2, S + K), generator=cgen,
                         device=device)
    with torch.no_grad():
        reset_counts(*counted)
        scan, _ = m4.forward(p4, {"tokens": toks})
        check(counts() == only(wkv6=4), f"4-layer forward: {counts()}")
        old = rwkv.WKV_PLAN
        rwkv.WKV_PLAN = "chunked_xla"
        try:
            xla, _ = m4.forward(p4, {"tokens": toks})
        finally:
            rwkv.WKV_PLAN = old
        e1 = close(scan, xla, "4-layer f32 logits, chunked_scan vs "
                   "chunked_xla", tol["float32"])
        cache = m4.init_cache(2, S + K, device)
        reset_counts(*counted)
        first, cache = m4.prefill(p4, cache, {"tokens": toks[:, :S]})
        e2 = close(first[:, 0], scan[:, S - 1], "4-layer prefill vs forward",
                   CONSISTENCY_TOL)
        for t in range(K):
            d, cache = m4.decode_step(p4, cache, {"tokens": toks[:, S + t]})
            e2 = max(e2, close(d, scan[:, S + t], f"4-layer decode {t}",
                               CONSISTENCY_TOL))
        check(counts() == only(wkv6=4),
              f"4-layer prefill + {K} decode steps launched {counts()}")
    print(f"[model] 4 x 2560 f32, S={S}: chunked_scan logits vs chunked_xla "
          f"max abs err {e1:.3e} (RWKV_TOL f32); prefill + {K} decode steps "
          f"vs forward over {S + K}: {e2:.3e} ({CONSISTENCY_TOL}); 4 launches"
          " a forward or prefill, none in decode")
    del p4, scan, xla, cache
    torch.cuda.empty_cache()

    # --- R3. RWKV6-3B served at full width, bf16 ---------------------------
    cfg = get_arch("rwkv6-3b")
    t0 = time.perf_counter()
    engine = serve_lm.build_engine(cfg, device, seed=0, batch_size=4,
                                   max_seq=500 + 16 + 1)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(engine.params))
    print(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B parameters in "
          f"{cfg.dtype}, drawn from seed 0 on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    lens = [412, 300, 377, 500, 333, 468, 451, 389]   # wave maxima 500, 468
    prng = np.random.default_rng(0)
    reqs = [Request(i, prng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate(lens)]
    seen = {"prefill": [], "tokens": [], "launches": [], "finite": True,
            "calls": []}
    kernel, prefill, decode = (wkv6_k.wkv6, engine._prefill,
                               steps_lib.decode_step)

    def watched_prefill(params, cache, batch):
        before = kernel.launches
        logits, cache = prefill(params, cache, batch)
        seen["launches"].append(kernel.launches - before)
        seen["tokens"].append(batch["tokens"])
        seen["prefill"].append(logits.float().clone())
        seen["finite"] &= bool(torch.isfinite(logits).all())
        return logits, cache

    def watched_decode(cfg_, params, cache, batch):
        logits, cache = decode(cfg_, params, cache, batch)
        seen["finite"] &= bool(torch.isfinite(logits).all())
        return logits, cache

    def captured_kernel(*args, **kwargs):
        """The kernel as the serve calls it, keeping its inputs (the state
        is a view of the cache, which the layer then overwrites) and
        outputs for the check against the plain version after the serve.
        The wrapper counts its launches through its module's name, which
        is this function while it is installed: the count is carried
        across."""
        captured_kernel.launches = kernel.launches
        got_ = kernel(*args, **kwargs)
        kernel.launches = captured_kernel.launches
        seen["calls"].append(([a.clone() for a in args], kwargs, got_))
        return got_

    engine._prefill, steps_lib.decode_step = watched_prefill, watched_decode
    wkv6_k.wkv6 = captured_kernel
    capacity = engine.pool.stats.capacity
    reset_counts(*counted)
    try:
        with tripwires((wkv6_k, "wkv6_plain"), (ref, "wkv6"),
                       (ref, "wkv6_stepwise"), (rwkv, "wkv_chunked")):
            served = serve_lm.serve(engine, reqs)
    finally:
        wkv6_k.wkv6, steps_lib.decode_step = kernel, decode
    got = counts()
    check(got == only(wkv6=64) and seen["launches"] == [32, 32],
          f"serve launched {got}, per prefill {seen['launches']}")
    check(all(r.tokens.shape == (16,) and int(r.tokens.min()) >= 0
              and int(r.tokens.max()) < cfg.vocab for r in served["results"]),
          "served tokens outside [0, vocab) or not 16 a request")
    check(seen["finite"], "a served logit is not finite")
    check(served["pool"].buffers_built == capacity,
          f"the pool built {served['pool'].buffers_built} buffers")
    print(f"[serve] wkv6 launches {got['wkv6']}: {seen['launches']} per "
          "prefill, 0 in decode, no plain scan reached; every logit finite;"
          f" buffers_built {served['pool'].buffers_built} = capacity")
    # every launch of the serve against the plain version on the inputs it
    # was given (the 32 layers' real r, k, v, logw, u and carried state):
    # out at the bf16 tier, the f32 state at the f32 tier
    e_out = e_state = 0.0
    n_calls, L = len(seen["calls"]), cfg.n_layers
    check(n_calls == sum(seen["launches"]), f"captured {n_calls} calls")
    for i, (args, kwargs, (out, s_out)) in enumerate(seen["calls"]):
        want = wkv6_k.wkv6_plain(*args, chunk=kwargs["chunk"])
        where = f"served wkv6 call {i} (layer {i % L}, wave {i // L})"
        e_out = max(e_out, close(out.float(), want[0].float(),
                                 f"{where} out", tol["bfloat16"]))
        e_state = max(e_state, close(s_out, want[1], f"{where} state",
                                     tol["float32"]))
    r0 = seen["calls"][0][0][0]
    print(f"[serve] each of the {n_calls} served wkv6 launches (r "
          f"{tuple(r0.shape)} {r0.dtype}) against wkv6_plain on its own "
          f"inputs: out max abs "
          f"err {e_out:.3e} (RWKV_TOL bf16), state {e_state:.3e} (RWKV_TOL "
          "f32)")
    seen["calls"].clear()
    scan_logits, seen["prefill"] = seen["prefill"], []
    old = rwkv.WKV_PLAN
    rwkv.WKV_PLAN = "chunked_xla"
    try:
        reset_counts(*counted)
        plain = serve_lm.serve(engine, reqs)
        check(counts() == only(), f"chunked_xla serve launched {counts()}")
        xla_logits, seen["prefill"] = seen["prefill"], []
        # the same waves through the stepwise oracle, for the model's own
        # bf16 spread between two plain plans
        rwkv.WKV_PLAN = "stepwise"
        step_logits = []
        with torch.no_grad():
            for toks in seen["tokens"][:2]:
                cache = engine.model.init_cache(toks.shape[0], 1, device)
                step_logits.append(engine.model.prefill(
                    engine.params, cache, {"tokens": toks})[0].float())
    finally:
        rwkv.WKV_PLAN = old
    # Printed, not held to a tolerance: in bf16 the 32 random layers turn a
    # one-ulp difference in a wkv output into first-token logits that
    # differ by O(1) between any two plans, the two plain ones included.
    # The kernel is held on this path by the per-launch check above, and
    # the model's bf16 casts by tests/test_torch_rwkv.py against JAX's.
    for i, (a, b, c) in enumerate(zip(scan_logits, xla_logits, step_logits)):
        d_kernel, d_plain = (a - b).abs(), (c - b).abs()
        print(f"[serve] wave {i} first-token logits (max |logit| "
              f"{float(b.abs().max()):.3f}): chunked_scan vs chunked_xla max "
              f"{float(d_kernel.max()):.3e} mean {float(d_kernel.mean()):.3e}"
              f"; stepwise vs chunked_xla max {float(d_plain.max()):.3e} "
              f"mean {float(d_plain.mean()):.3e}; argmax equal "
              f"{int((a.argmax(-1) == b.argmax(-1)).sum())} of {a.shape[0]}")
    same = sum(int((a.tokens == b.tokens).sum())
               for a, b in zip(served["results"], plain["results"]))
    print(f"[serve] greedy tokens equal between chunked_scan and chunked_xla:"
          f" {same} of {16 * len(reqs)}")
    for name, run in (("chunked_scan", served), ("chunked_xla", plain)):
        for i, w in enumerate(run["waves"]):
            print(f"[time] serve {name} wave {i}: prefill "
                  f"{w['prefill_ms']:.3f} ms, decode "
                  f"{w['decode_ms_per_token']:.3f} ms/token (host clock)")
    launches = got["wkv6"]
    del engine
    torch.cuda.empty_cache()

    # --- R4. K6's times at the serving heads -------------------------------
    BH, T, dk, dv, C = 160, 512, 64, 64, 32
    rows = {}
    for dtype in (bf16, f32):
        a = inputs(BH, T, dk, dv, dtype)
        t_bound, by = bound(*wkv6_fwd_work(BH, T, dk, dv, C, dtype))
        tc_bound, tc_by = bound(*wkv6_fwd_work(BH, T, dk, dv, C, dtype),
                                flop_rate=TF32_FLOP_PER_S)
        rows[dtype] = dict(
            ms=time_ms(lambda: wkv6_k.wkv6(*a, chunk=C), 50),
            graph_ms=graph_ms(lambda: wkv6_k.wkv6(*a, chunk=C)),
            plain_ms=time_ms(lambda: wkv6_k.wkv6_plain(*a, chunk=C), 2),
            bound_ms=t_bound, bound_by=by)
        print(f"[time] wkv6 BH={BH} T={T} {dk}x{dv} C={C} "
              f"{str(dtype).split('.')[1]}: kernel {rows[dtype]['ms']:.4f} ms"
              f" back to back, {rows[dtype]['graph_ms']:.4f} ms in a CUDA "
              f"graph, plain {rows[dtype]['plain_ms']:.4f} ms, library none "
              f"(no single PyTorch call computes WKV6), bound "
              f"{t_bound:.3e} ms ({by}, f32 at 67 TFLOP/s); with the "
              f"products on TF32 tensor cores (495 TFLOP/s) {tc_bound:.3e} "
              f"ms ({tc_by})")
    main_row = rows[bf16]
    print(f"[K6] max abs err vs plain: f32 {errs['float32']:.3e}, bf16 "
          f"{errs['bfloat16']:.3e} (bf16 outputs keep 8 significant bits)")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:312",
            "launches": launches, "max_abs_err": errs["bfloat16"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None}


def device_time(events, spans=()) -> tuple[float, dict, dict]:
    """The device's busy time in one profiled step (one stream, so kernels
    do not overlap), that time by group — the scan kernels of each family
    (wkv6, mamba_scan), the matrix products, the kernels inside the
    optimizer's span (``spans``, empty when the host was not traced) and
    the rest, each group that ran — and by kernel name with its
    launches."""
    def group(e) -> str:
        name = e.name.lower()
        for family in ("wkv6", "mamba_scan"):
            if family in name:
                return f"{family} kernels"
        if any(k in name for k in ("gemm", "cutlass", "xmma", "nvjet")):
            return "matrix products"
        if any(t.start <= e.time_range.start <= t.end for t in spans):
            return "AdamW"
        return "other"

    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in events:
        ms, g = e.time_range.elapsed_us() / 1e3, group(e)
        by_group[g] = by_group.get(g, 0.0) + ms
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    return sum(by_group.values()), by_group, by_name


def profiling(train_step, n_steps: int, profiles: list):
    """``train_step`` with the last two of ``n_steps`` steps under
    torch.profiler, each appended to ``profiles``: the first tracing the
    device alone, the second the host too (the steps before them run as
    they are)."""
    def profiled_step(*args, **kwargs):
        profiled_step.n += 1
        if profiled_step.n <= n_steps - 2:
            return train_step(*args, **kwargs)
        host = profiled_step.n == n_steps
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if host:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as p:
            t1 = time.perf_counter()
            out = train_step(*args, **kwargs)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        profiles.append({"step": profiled_step.n, "host": host,
                         "wall_ms": wall, "events": p.events()})
        return out

    profiled_step.n = 0
    return profiled_step


def print_step_profile(profiles: list[dict], unprofiled_ms: float) -> None:
    """Where the last two training steps' device time goes, from
    torch.profiler's device events.  The first traced the device alone:
    its busy time against its own wall gives the device's idle share, and
    its wall against the unprofiled steps' median the tracing's host cost.
    The second also traced the host, so the optimizer's span groups its
    kernels; its wall carries the host tracing's cost and is not used."""
    span = "adamw.update_"
    for prof in profiles:
        device = [e for e in prof["events"]
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = [e.time_range for e in device if e.name == span]
        kernels = [e for e in device if e.name != span]
        what = ("device and host traced" if prof["host"]
                else "device traced alone")
        if not kernels:
            print(f"[profile] training step {prof['step']} ({what}): the "
                  "profiler recorded no device time; not measured")
            continue
        busy, by_group, by_name = device_time(kernels, spans)
        groups = "; ".join(f"{g} {t:.3f} ms" for g, t in by_group.items()
                           if prof["host"] or g != "AdamW")
        if prof["host"]:
            print(f"[profile] training step {prof['step']} ({what}): device "
                  f"busy {busy:.3f} ms; {groups}")
            top = sorted(by_name.items(), key=lambda kv: kv[1][0],
                         reverse=True)
            for name, (ms, n) in top[:12]:
                print(f"[profile]   {ms:9.3f} ms in {n:5d} launches: "
                      f"{name[:110]}")
        else:
            wall = prof["wall_ms"]
            print(f"[profile] training step {prof['step']} ({what}): wall "
                  f"{wall:.3f} ms ({wall - unprofiled_ms:+.3f} ms against the"
                  f" unprofiled median), device busy {busy:.3f} ms, idle "
                  f"{1 - busy / wall:.1%} of this step's wall; {groups} "
                  f"(AdamW in other)")


def rwkv_train_slice(device, gen, counted, counts, only) -> list[dict]:
    """The RWKV6 training slice: K6t and K6b against their plain versions
    and torch autograd (R5); the full-width model cut to 4 layers in f32,
    its gradients through the kernels against those through
    ``chunked_xla``, with remat on and off, and its launches per step
    against JAX's dispatch count (R6); RWKV6-3B trained at full width and
    depth in bf16 through ``launch/train.py``, counted, the plain scans
    armed to raise, each K6b launch of step 1 held against its plain
    version (R7); the two kernels' times (R8).  Returns their entries of
    the ``kernels`` line."""
    from repro_torch.configs import get_arch
    from repro_torch.core import plans
    from repro_torch import steps as steps_lib
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wkv6_k
    from repro_torch.launch import train as train_lm
    from repro_torch.models import registry, rwkv
    from repro_torch.optim.adamw import tree_leaves

    bf16, f32 = torch.bfloat16, torch.float32
    tol, grad_tol = plans.RWKV_TOL, plans.RWKV_GRAD_TOL["float32"]
    names = ("dr", "dk", "dv", "dlogw", "du", "ds0")

    bf16_step = {"share": 0.0}

    def hold(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
        """Hold a gradient to its reference; return the max abs error.  One
        in f32 at RWKV_GRAD_TOL; one in bf16 at RWKV_TOL bf16 with its atol
        scaled by the reference's max abs, and also within one bf16 step at
        that max, 2^-7 * max|want| (the largest share is kept)."""
        if want.dtype == f32:
            return close(got, want, what, grad_tol)
        m = float(want.float().abs().max())
        t = tol["bfloat16"]
        e = close(got.float(), want.float(), what,
                  dict(rtol=t["rtol"], atol=t["atol"] * m))
        check(e <= 2.0 ** -7 * m, f"{what}: max abs err {e} is past one "
              f"bf16 step at max|want| {m}")
        bf16_step["share"] = max(bf16_step["share"], e / m if m else 0.0)
        return e

    def cotangents(BH, T, dk, dv, dtype):
        return randn(BH, T, dv, gen=gen).to(dtype), randn(BH, dk, dv, gen=gen)

    def bwd_args(a, traj, s_fin, dout, dsf):
        return (*a[:5], traj, s_fin, dout, dsf)

    # --- R5. K6t and K6b against their plain versions ----------------------
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in ("traj", "bwd")}
    fam = plans.get_family("rwkv6")
    cases = [(c.label, (c.shape[0] * c.shape[2], c.shape[1], c.shape[3],
                        c.shape[4], c.shape[5])) for c in fam.cases]
    cases += [(f"full width T={T}", (160, T, 64, 64, 32)) for T in (512, 500)]
    for label, (BH, T, dk, dv, C) in cases:
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[1]
            a = wkv_inputs(BH, T, dk, dv, dtype, gen)
            out, s_out = wkv6_k.wkv6(*a, chunk=C)
            t_out, t_s, traj = wkv6_k.wkv6_traj(*a, chunk=C)
            check(torch.equal(out, t_out) and torch.equal(s_out, t_s),
                  f"wkv6_traj {label} {name}: out or state differs from "
                  "wkv6's")
            p_out, _, p_traj = wkv6_k.wkv6_traj_plain(*a, C)
            e_t = max(close(t_out.float(), p_out.float(),
                            f"wkv6_traj {label} {name} out", tol[name]),
                      close(traj, p_traj, f"wkv6_traj {label} {name} s_traj",
                            tol["float32"]))
            errs["traj"][name] = max(errs["traj"][name], e_t)
            dout, dsf = cotangents(BH, T, dk, dv, dtype)
            args = bwd_args(a, traj, t_s, dout, dsf)
            got = wkv6_k.wkv6_bwd(*args, chunk=C)
            plain = wkv6_k.wkv6_bwd_plain(*args, C)
            x = [t.clone().requires_grad_() for t in a]
            with torch.enable_grad():
                auto = torch.autograd.grad(wkv6_k.wkv6_plain(*x, C), x,
                                           (dout, dsf))
            e_b = e_a = 0.0
            for n, g, pl, au in zip(names, got, plain, auto):
                check(g.dtype == pl.dtype == au.dtype,
                      f"wkv6_bwd {label} {name} {n}: dtype {g.dtype}")
                e_b = max(e_b, hold(g, pl, f"wkv6_bwd {label} {name} {n} "
                                    "vs plain"))
                e_a = max(e_a, hold(g, au, f"wkv6_bwd {label} {name} {n} "
                                    "vs autograd"))
            errs["bwd"][name] = max(errs["bwd"][name], e_b)
            print(f"[K6t/K6b] {label} (BH={BH} T={T} {dk}x{dv} C={C}) {name}:"
                  f" K6t out and state bit-equal to K6's, vs plain {e_t:.3e};"
                  f" K6b vs plain {e_b:.3e}, vs autograd of wkv6_plain "
                  f"{e_a:.3e}")
    for dtype in (f32, bf16):
        for BH, T, dk, dv, C in ((4, 19, 8, 8, 8), (160, 500, 64, 64, 32)):
            a = wkv_inputs(BH, T, dk, dv, dtype, gen, decay=1e6)
            _, s_fin, traj = wkv6_k.wkv6_traj(*a, chunk=C)
            got = wkv6_k.wkv6_bwd(*bwd_args(a, traj, s_fin, *cotangents(
                BH, T, dk, dv, dtype)), chunk=C)
            check(all(bool(torch.isfinite(g.float()).all()) for g in got),
                  f"wkv6_bwd BH={BH} T={T} {dtype}: a gradient is not finite"
                  " at log-decays of -1e6")
    print("[K6b] gradients finite at single-step log-decays down to -1e6 "
          "(f32, bf16; T=19 and the full width at T=500)")
    # the sub-chunk edges: T not a multiple of the sub-chunk (19, 23, 500),
    # chunks of 8, 16 and 32, heads of 128 at C=16; K6t bit-equal to K6,
    # and K6t and K6b against the pairwise plain versions and those in the
    # kernels' sub-chunk form
    for BH, T, dk, dv, C in ((8, 19, 64, 64, 32), (8, 23, 64, 64, 32),
                             (8, 500, 64, 64, 8), (8, 500, 64, 64, 16),
                             (8, 500, 64, 64, 32), (8, 100, 128, 128, 16)):
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[1]
            a = wkv_inputs(BH, T, dk, dv, dtype, gen)
            out, s_out = wkv6_k.wkv6(*a, chunk=C)
            t_out, t_s, traj = wkv6_k.wkv6_traj(*a, chunk=C)
            what = f"T={T} {dk}x{dv} C={C} {name}"
            check(torch.equal(out, t_out) and torch.equal(s_out, t_s),
                  f"wkv6_traj {what}: out or state differs from wkv6's")
            dout, dsf = cotangents(BH, T, dk, dv, dtype)
            got = wkv6_k.wkv6_bwd(*bwd_args(a, traj, t_s, dout, dsf),
                                  chunk=C)
            e_t = e_b = 0.0
            for sub in (None, wkv6_k.SUB_CHUNK):
                form = "pairwise" if sub is None else f"sub-chunk {sub}"
                p_out, p_s, p_traj = wkv6_k.wkv6_traj_plain(*a, C,
                                                           sub_chunk=sub)
                e_t = max(e_t, close(t_out.float(), p_out.float(),
                                     f"wkv6_traj {what} out vs {form}",
                                     tol[name]),
                          close(t_s, p_s, f"wkv6_traj {what} state vs "
                                f"{form}", tol["float32"]),
                          close(traj, p_traj, f"wkv6_traj {what} s_traj vs "
                                f"{form}", tol["float32"]))
                plain = wkv6_k.wkv6_bwd_plain(
                    *bwd_args(a, traj, t_s, dout, dsf), C, sub_chunk=sub)
                for n, g, pl in zip(names, got, plain):
                    e_b = max(e_b, hold(g, pl, f"wkv6_bwd {what} {n} vs "
                                        f"{form}"))
            print(f"[K6t/K6b] sub-chunk edge BH={BH} {what}: K6t bit-equal "
                  f"to K6, vs plain (pairwise and sub-chunk form) {e_t:.3e};"
                  f" K6b vs both {e_b:.3e}")
    a = wkv_inputs(160, 500, 64, 64, bf16, gen)
    _, s_fin, traj = wkv6_k.wkv6_traj(*a, chunk=32)
    args = bwd_args(a, traj, s_fin, *cotangents(160, 500, 64, 64, bf16))
    base = wkv6_k.wkv6_bwd(*args, chunk=32)
    check(all(torch.equal(g, w) for g, w in zip(
        wkv6_k.wkv6_bwd(*args, chunk=32), base)),
          "wkv6_bwd: two runs differ")
    for i in (0, 77, 159):
        alone = wkv6_k.wkv6_bwd(*(t[i:i + 1] for t in args), chunk=32)
        check(all(torch.equal(g[0], w[i]) for g, w in zip(alone, base)),
              f"wkv6_bwd full-width row {i} alone differs from the batch")
        t_alone = wkv6_k.wkv6_traj(*(t[i:i + 1] for t in a), chunk=32)[2]
        check(torch.equal(t_alone[0], traj[i]),
              f"wkv6_traj full-width row {i} alone differs from the batch")
    a = wkv_inputs(5, 23, 64, 64, f32, gen)
    _, s_fin, traj = wkv6_k.wkv6_traj(*a, chunk=8)
    args = bwd_args(a, traj, s_fin, *cotangents(5, 23, 64, 64, f32))
    base = wkv6_k.wkv6_bwd(*args, chunk=8)
    for bt in (2, 5):
        check(all(torch.equal(g, w) for g, w in zip(
            wkv6_k.wkv6_bwd(*args, chunk=8, bh_tile=bt), base)),
              f"wkv6_bwd bh_tile={bt} differs from bh_tile=1")
    print("[K6b] two runs bit-identical; rows bit-identical alone and in a "
          "batch (bf16 rows 0, 77, 159 of 160 at T=500, K6t too; f32 BH=5, "
          "T=23 at tiles 1, 2, 5)")

    # --- R6. the full-width model cut to 4 layers, f32: gradients ----------
    cfg4 = dataclasses.replace(get_arch("rwkv6-3b"), n_layers=4,
                               dtype="float32")
    m4 = registry.build(cfg4)
    cgen = torch.Generator(device=device).manual_seed(0)
    p4 = m4.init(cgen, device)
    mix, mlp = p4["blocks"][0]["mix"], p4["blocks"][0]["mlp"]
    for t in (mix["maa_x"], mix["maa"], mix["u"], mlp["mu_k"], mlp["mu_r"]):
        t.add_(0.1 * torch.randn(t.shape, generator=cgen, device=device))
    leaves = tree_leaves(p4)
    for t in leaves:
        t.requires_grad_()
    batch = {"tokens": torch.randint(0, cfg4.vocab, (2, 300), generator=cgen,
                                     device=device)}
    L = cfg4.n_layers

    def grads(remat: bool):
        reset_counts(*counted)
        loss, _ = steps_lib.loss_fn(p4, cfg4, batch, remat=remat)
        g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.detach(), g, counts()

    loss_on, g_on, n_on = grads(True)
    loss_off, g_off, n_off = grads(False)
    for remat, n in ((True, n_on), (False, n_off)):
        want = only(wkv6_traj=(2 if remat else 1) * L, wkv6_bwd=L)
        check(n == want and n["wkv6_traj"] + n["wkv6_bwd"]
              == JAX_TRAIN_DISPATCHES_4[remat],
              f"4-layer training step (remat {remat}) launched {n}")
    d_remat = max(float((a - b).abs().max()) for a, b in zip(g_on, g_off))
    for a, b in zip(g_on, g_off):
        close(a, b, "4-layer grads, remat on vs off", grad_tol)
    old = rwkv.WKV_PLAN
    rwkv.WKV_PLAN = "chunked_xla"
    try:
        loss_x, g_x, n_x = grads(True)
    finally:
        rwkv.WKV_PLAN = old
    check(n_x == only(), f"chunked_xla training step launched {n_x}")
    e = close(loss_on, loss_x, "4-layer loss, chunked_scan vs chunked_xla",
              grad_tol)
    for a, b in zip(g_on, g_x):
        e = max(e, close(a, b, "4-layer grads, chunked_scan vs chunked_xla",
                         grad_tol))
    print(f"[train] 4 x 2560 f32, B=2 S=300: loss_fn grads through "
          f"chunked_scan vs chunked_xla max abs err {e:.3e} (RWKV_GRAD_TOL "
          f"f32); remat on vs off max abs diff {d_remat:.3e}; launches a "
          f"step: remat on {n_on['wkv6_traj']} K6t + {n_on['wkv6_bwd']} "
          f"K6b, off {n_off['wkv6_traj']} + {n_off['wkv6_bwd']}, no K6 (JAX:"
          f" {JAX_TRAIN_DISPATCHES_4[True]} and "
          f"{JAX_TRAIN_DISPATCHES_4[False]})")
    del p4, leaves, g_on, g_off, g_x
    torch.cuda.empty_cache()

    # --- R7. RWKV6-3B trained at full width and depth, bf16 ----------------
    cfg = get_arch("rwkv6-3b")
    n_steps, L = 8, cfg.n_layers
    kernel_bwd, plain_bwd = wkv6_k.wkv6_bwd, wkv6_k.wkv6_bwd_plain
    seen = {"n": 0, "err": 0.0, "shape": None}

    def checked_bwd(*args, **kwargs):
        """K6b as the training step calls it; each launch of step 1 (the
        first L) held against the plain version on its own inputs.  The
        wrapper counts its launches through its module's name, which is
        this function while it is installed: the count is carried
        across."""
        checked_bwd.launches = kernel_bwd.launches
        got = kernel_bwd(*args, **kwargs)
        kernel_bwd.launches = checked_bwd.launches
        if seen["n"] < L:
            want = plain_bwd(*args, kwargs["chunk"])
            for n, g, w in zip(names, got, want):
                seen["err"] = max(seen["err"], hold(
                    g, w, f"trained wkv6_bwd launch {seen['n']} {n}"))
            seen["n"] += 1
            seen["shape"] = (tuple(args[0].shape), args[0].dtype,
                             kwargs["chunk"])
        return got

    train_step = steps_lib.train_step
    profiles = []
    wkv6_k.wkv6_bwd = checked_bwd
    steps_lib.train_step = profiling(train_step, n_steps, profiles)
    reset_counts(*counted)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with tripwires((wkv6_k, "wkv6_plain"), (wkv6_k, "wkv6_traj_plain"),
                       (wkv6_k, "wkv6_bwd_plain"), (ref, "wkv6"),
                       (ref, "wkv6_traj"), (ref, "wkv6_stepwise"),
                       (rwkv, "wkv_chunked")):
            report = train_lm.main([
                "--arch", cfg.name, "--device", "cuda", "--steps",
                str(n_steps), "--batch", "4", "--seq", "512", "--log-every",
                "1", "--seed", "0"])
    finally:
        wkv6_k.wkv6_bwd, steps_lib.train_step = kernel_bwd, train_step
    wall = time.perf_counter() - t0
    got = counts()
    check(got == only(wkv6_traj=2 * L * n_steps, wkv6_bwd=L * n_steps),
          f"{n_steps} training steps launched {got}")
    check(seen["n"] == L, f"checked {seen['n']} K6b launches of step 1")
    check(all(math.isfinite(x) for x in report["losses"]
              + report["grad_norms"]),
          f"a loss or grad_norm is not finite: {report['losses']}, "
          f"{report['grad_norms']}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # step 1 also ran the 32 checks, the last two the profiler
    step_ms = report["step_ms"][1:-2]
    med = statistics.median(step_ms)
    tokens = report["tokens_per_step"]
    model_flops = 6 * report["n_params"] * tokens
    print(f"[train] {cfg.name}: {report['n_params'] / 1e9:.3f} B parameters "
          f"in {cfg.dtype}, batch 4 x 512, {n_steps} steps in {wall:.1f} s "
          f"(init included); launches {got['wkv6_traj']} K6t + "
          f"{got['wkv6_bwd']} K6b ({2 * L} + {L} a step), none of K6, no "
          "plain scan reached; every loss and grad_norm finite; peak "
          f"device memory {peak:.2f} GB (torch.cuda.max_memory_allocated)")
    print(f"[train] each of step 1's {seen['n']} K6b launches (r "
          f"{seen['shape'][0]} {seen['shape'][1]}, C={seen['shape'][2]}) "
          f"against wkv6_bwd_plain on its own inputs: max abs err "
          f"{seen['err']:.3e} (dr, dk, dv at RWKV_TOL bf16 x max|grad| and "
          "one bf16 step at max|grad|, dlogw, du, ds0 at RWKV_GRAD_TOL f32)")
    print(f"[time] training step, {cfg.name}, batch 4 x 512, steps 2 to "
          f"{n_steps - 2}: median {med:.3f} ms, min {min(step_ms):.3f} ms "
          f"(host clock around the step, ending in the loss's copy to the "
          f"host); "
          f"{tokens / (med / 1e3):.1f} tokens/s; model FLOPs (6 x params x "
          f"tokens, {model_flops:.3e} a step) at "
          f"{model_flops / (med / 1e3) / BF16_FLOP_PER_S:.2%} of the H100's "
          "989 TFLOP/s bf16 dense peak")
    print_step_profile(profiles, med)
    launches = {"wkv6_traj": got["wkv6_traj"], "wkv6_bwd": got["wkv6_bwd"]}
    torch.cuda.empty_cache()

    # --- R8. K6t's and K6b's times at the training heads -------------------
    BH, T, dk, dv = 160, 512, 64, 64
    C = wkv6_k.choose_blocks(T, dk, dv, target=cfg.ssm.chunk,
                             mode="bwd").chunk
    rows = {}
    for dtype in (bf16, f32):
        a = wkv_inputs(BH, T, dk, dv, dtype, gen)
        _, s_fin, traj = wkv6_k.wkv6_traj(*a, chunk=C)
        args = bwd_args(a, traj, s_fin, *cotangents(BH, T, dk, dv, dtype))
        t_bound, by = bound(*wkv6_fwd_work(BH, T, dk, dv, C, dtype,
                                           traj=True))
        tc = bound(*wkv6_fwd_work(BH, T, dk, dv, C, dtype, traj=True),
                   flop_rate=TF32_FLOP_PER_S)
        rows["wkv6_traj", dtype] = dict(
            ms=time_ms(lambda: wkv6_k.wkv6_traj(*a, chunk=C), 50),
            graph_ms=graph_ms(lambda: wkv6_k.wkv6_traj(*a, chunk=C)),
            plain_ms=time_ms(lambda: wkv6_k.wkv6_traj_plain(*a, C), 2),
            bound_ms=t_bound, bound_by=by, tc=tc)
        t_bound, by = bound(*wkv6_bwd_work(BH, T, dk, dv, C, dtype))
        tc = bound(*wkv6_bwd_work(BH, T, dk, dv, C, dtype),
                   flop_rate=TF32_FLOP_PER_S)
        rows["wkv6_bwd", dtype] = dict(
            ms=time_ms(lambda: wkv6_k.wkv6_bwd(*args, chunk=C), 20),
            graph_ms=graph_ms(lambda: wkv6_k.wkv6_bwd(*args, chunk=C)),
            plain_ms=time_ms(lambda: wkv6_k.wkv6_bwd_plain(*args, C), 2),
            bound_ms=t_bound, bound_by=by, tc=tc)
        for name in ("wkv6_traj", "wkv6_bwd"):
            r = rows[name, dtype]
            print(f"[time] {name} BH={BH} T={T} {dk}x{dv} C={C} "
                  f"{str(dtype).split('.')[1]}: kernel {r['ms']:.4f} ms back "
                  f"to back, {r['graph_ms']:.4f} ms in a CUDA graph, plain "
                  f"{r['plain_ms']:.4f} ms, library none (no single PyTorch "
                  f"call computes it), bound {r['bound_ms']:.3e} ms "
                  f"({r['bound_by']}, f32 at 67 TFLOP/s); with the products "
                  f"on TF32 tensor cores (495 TFLOP/s) {r['tc'][0]:.3e} ms "
                  f"({r['tc'][1]})")
    for name, legend in (("wkv6", "<IO,traj>"), ("wkv6_bwd", "<IO>")):
        compiled = ""                  # the entry ptxas is reporting on
        for line in BUILD_LOGS.get(name, "").splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                compiled = entry.group(1)
            elif "registers" in line or "spill" in line:
                print(f"[time] {name} {legend} = {instance(compiled)}: "
                      f"{line.strip()}")
    print(f"[K6t/K6b] max abs err vs plain: K6t f32 "
          f"{errs['traj']['float32']:.3e}, bf16 {errs['traj']['bfloat16']:.3e}"
          f"; K6b f32 {errs['bwd']['float32']:.3e}, bf16 "
          f"{errs['bwd']['bfloat16']:.3e}; bf16 dr, dk, dv (R5 and R7) "
          f"within {bf16_step['share']:.3e} x max|want| (held at one bf16 "
          f"step, 2^-7 = {2.0 ** -7:.3e})")
    entries = []
    for name, replaces in (("wkv6_traj", "src/repro/kernels/wkv6.py:318"),
                           ("wkv6_bwd", "src/repro/kernels/wkv6.py:327")):
        r = rows[name, bf16]
        src = "wkv6.cu" if name == "wkv6_traj" else "wkv6_bwd.cu"
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name.split("_")[1]]["bfloat16"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    return entries


def mamba_inputs(B, T, di, ds, dtype, gen, dt_scale=1.0):
    """x in ``dtype``; dt (> 0, scaled by ``dt_scale``), b, c, a (< 0) and
    h0 f32; on the card."""
    x = randn(B, T, di, gen=gen).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, T, di, gen=gen)) * dt_scale
    return (x, dt, randn(B, T, ds, gen=gen), randn(B, T, ds, gen=gen),
            -torch.exp(randn(di, ds, gen=gen)),
            randn(B, di, ds, gen=gen, scale=0.3))


def mamba_fwd_work(B, T, di, ds, C, dtype, traj=False) -> tuple[int, int]:
    """(bytes, operations) of one K7 launch (K7t with ``traj``): x in and y
    out in the IO type, dt, b, c, a, h0 and h_out f32 (and h_traj f32
    out); per state-step dt A, its exponential (one operation), (dt x) B,
    the update's multiply-add and y's, and per channel-step dt x."""
    io = 2 if dtype == torch.bfloat16 else 4
    nt = -(-T // C)
    nbytes = (2 * io * B * T * di + 4 * B * T * di + 4 * 2 * B * T * ds
              + 4 * di * ds + 4 * 2 * B * di * ds)
    if traj:
        nbytes += 4 * B * nt * di * ds
    return nbytes, B * T * di * (7 * ds + 1)


def mamba_bwd_work(B, T, di, ds, C, dtype) -> tuple[int, int]:
    """(bytes, operations) that the backward of ``kernels/mamba_scan.py``'s
    docstring needs, each product and exponential counted once: x, dy in
    and dx out in the IO type; dt, ddt, b, c, db, dc, a, da, h_traj,
    dh_fin and dh0 f32.  Per state-step the recompute of h from the chunk's
    incoming state (dt A, exp, (dt x) B, multiply-add: 5) and the reverse
    step (g's multiply-add, sum g B, g h a, sum g h a A, dA's multiply-add,
    the dB and dC terms and their sums over d_inner, a g: 16); per
    channel-step dt x, dx and ddt's multiply-add (4).  The kernel's own
    partial sums of dB and dC are its choice and not counted."""
    io = 2 if dtype == torch.bfloat16 else 4
    nt = -(-T // C)
    nbytes = (3 * io * B * T * di + 2 * 4 * B * T * di + 4 * 4 * B * T * ds
              + 2 * 4 * di * ds + 4 * B * nt * di * ds + 2 * 4 * B * di * ds)
    return nbytes, B * T * di * (21 * ds + 4)


def mamba_slice(device, gen, counted, counts, only) -> list[dict]:
    """The Mamba slice: K7 and K7t against their plain versions (M1); K7b
    against its plain version and torch autograd (M2); the attention-free
    Jamba stack at full width cut to 2 layers in f32, across plans and
    against its own forward, with its gradients (M3); the same stack in
    bf16 (3.12 B parameters) served through ``launch/serve.py`` and
    trained through ``launch/train.train``, counted, the plain scans armed
    to raise (M4); the three kernels' times (M5).  Returns their entries
    of the ``kernels`` line."""
    from repro_torch.configs import get_arch, jamba_1_5_large_398b as jamba
    from repro_torch.core import plans
    from repro_torch import steps as steps_lib
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.launch import serve as serve_lm
    from repro_torch.launch import train as train_lm
    from repro_torch.models import mamba, registry
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serving import Request

    bf16, f32 = torch.bfloat16, torch.float32
    tol, grad_tol = plans.MAMBA_TOL, plans.MAMBA_GRAD_TOL["float32"]
    names = ("dx", "ddt", "db", "dc", "da", "dh0")
    sums = ("db", "dc", "da")          # sums over d_inner or batch and time
    # attention and MoE layers out (they come with the LM stack), depth 2
    cfg = dataclasses.replace(get_arch("jamba-1.5-large-398b"),
                              **jamba.ATTENTION_FREE, n_layers=2)
    di, ds = mamba.d_inner(cfg), cfg.ssm.d_state
    plain_scans = ((ms, "mamba_scan_plain"), (ms, "mamba_scan_traj_plain"),
                   (ms, "mamba_scan_bwd_plain"), (ms, "mamba_scan_ref"),
                   (ms, "_chunk_math"))
    bf16_step = {"share": 0.0}

    def hold(got: torch.Tensor, want: torch.Tensor, what: str,
             name: str) -> float:
        """Hold a gradient to its reference; return the max abs error.  An
        f32 one at MAMBA_GRAD_TOL elementwise, its atol scaled by the
        reference's max abs (past 1: at full width gradients reach the
        hundreds), or for a sum over d_inner or over batch and time (db,
        dc, da: another order of summation) within its rtol of the largest
        entry; a bf16 one (dx of a bf16 launch) at MAMBA_TOL bf16 with its
        atol scaled the same way and within one bf16 step at that max,
        2^-7 * max|want|."""
        m = float(want.float().abs().max())
        if want.dtype == f32 and name in sums:
            e = float((got - want).abs().max())
            check(e <= grad_tol["rtol"] * m, f"{what}: max abs err {e} past "
                  f"{grad_tol['rtol']} of max|want| {m}")
            return e
        if want.dtype == f32:
            return close(got, want, what, dict(
                rtol=grad_tol["rtol"], atol=grad_tol["atol"] * max(1.0, m)))
        t = tol["bfloat16"]
        e = close(got.float(), want.float(), what,
                  dict(rtol=t["rtol"], atol=t["atol"] * m))
        check(e <= 2.0 ** -7 * m, f"{what}: max abs err {e} is past one "
              f"bf16 step at max|want| {m}")
        bf16_step["share"] = max(bf16_step["share"], e / m if m else 0.0)
        return e

    # --- M1. K7 and K7t against their plain versions -----------------------
    errs = {k: {"float32": 0.0, "bfloat16": 0.0}
            for k in ("fwd", "traj", "bwd")}
    fam = plans.get_family("mamba")
    cases = [(c.label, c.shape) for c in fam.cases]
    cases += [(f"full width T={T}", (4, T, di, ds, cfg.ssm.chunk, 1))
              for T in (512, 500)]
    for label, (B, T, di_, ds_, C, bb) in cases:
        tr = ms.choose_blocks(T, di_, ds_, target=C, mode="bwd")
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[1]
            a = mamba_inputs(B, T, di_, ds_, dtype, gen)
            got = ms.mamba_scan(*a, chunk=C, block_b=bb)
            want = ms.mamba_scan_plain(*a, C)
            check(got[0].dtype == dtype and got[1].dtype == f32,
                  f"mamba_scan {label} {name}: output dtypes {got[0].dtype},"
                  f" {got[1].dtype}")
            # the state is f32 math on the same inputs: the f32 tier
            e = max(close(got[0].float(), want[0].float(),
                          f"mamba_scan {label} {name} y", tol[name]),
                    close(got[1], want[1], f"mamba_scan {label} {name} state",
                          tol["float32"]))
            errs["fwd"][name] = max(errs["fwd"][name], e)
            # K7t at the training tiling: y and state bit-equal to K7's
            t_y, t_h, traj = ms.mamba_scan_traj(*a, chunk=tr.chunk,
                                                di_tile=tr.di_tile)
            check(torch.equal(t_y, got[0]) and torch.equal(t_h, got[1]),
                  f"mamba_scan_traj {label} {name}: y or state differs from "
                  "mamba_scan's")
            p_traj = ms.mamba_scan_traj_plain(*a, tr.chunk)[2]
            e_t = close(traj, p_traj, f"mamba_scan_traj {label} {name} "
                        "h_traj", tol["float32"])
            errs["traj"][name] = max(errs["traj"][name], max(e, e_t))
            # the one-phase path at T=1 (a served decode step) on the
            # case's first step: against plain, bit-equal to the general
            # path at T=1, and K7t's one-phase instance to K7's
            one = tuple(t[:, :1] for t in a[:4]) + a[4:]
            dec = ms.mamba_scan(*one, chunk=1, block_b=bb)
            want1 = ms.mamba_scan_plain(*one, 1)
            e_1 = max(close(dec[0].float(), want1[0].float(),
                            f"mamba_scan T=1 {label} {name} y", tol[name]),
                      close(dec[1], want1[1], f"mamba_scan T=1 {label} "
                            f"{name} state", tol["float32"]))
            errs["fwd"][name] = max(errs["fwd"][name], e_1)
            gen_ = ms._launch_fwd(*one, 1, 1, ms._tiles(di_)[0],
                                  traj=False, one_phase=False)
            t1 = ms.mamba_scan_traj(*one, chunk=1)
            check(all(torch.equal(g, d) for g, d in zip(gen_, dec))
                  and torch.equal(t1[0], dec[0])
                  and torch.equal(t1[1], dec[1])
                  and torch.equal(t1[2][:, 0], one[5].float()),
                  f"mamba_scan T=1 {label} {name}: the one-phase path "
                  "differs from the general path, or K7t's from K7's")
            print(f"[K7/K7t] {label} (B={B} T={T} di={di_} ds={ds_} C={C} "
                  f"block_b={bb}) {name}: K7 vs plain max abs err {e:.3e} "
                  f"(MAMBA_TOL {name}, state at f32); K7t at (C={tr.chunk}, "
                  f"di_tile={tr.di_tile}) y and state bit-equal to K7's, "
                  f"h_traj vs plain {e_t:.3e}; T=1 one-phase vs plain "
                  f"{e_1:.3e}, bit-equal to the general path and to K7t's")
    B, T = 4, 500
    for dtype in (f32, bf16):
        a = mamba_inputs(B, T, di, ds, dtype, gen)
        base = ms.mamba_scan(*a, chunk=T, di_tile=32)
        for C, tile in ((1, 128), (16, 128), (64, 64), (64, 32), (64, 128)):
            check(all(torch.equal(g, w) for g, w in zip(
                ms.mamba_scan(*a, chunk=C, di_tile=tile), base)),
                  f"mamba_scan {dtype} chunk {C} di_tile {tile} differs from "
                  "chunk T")
        for i in (0, 3):
            alone = ms.mamba_scan(*(t[i:i + 1] if t.dim() == 3 and t.shape[0]
                                    == B else t for t in a), chunk=64)
            check(torch.equal(alone[0][0], base[0][i])
                  and torch.equal(alone[1][0], base[1][i]),
                  f"mamba_scan {dtype} row {i} alone differs from the batch")
        y1, h1 = ms.mamba_scan(*(t[:, :300] for t in a[:4]), a[4], a[5],
                               chunk=64)
        y2, h2 = ms.mamba_scan(*(t[:, 300:] for t in a[:4]), a[4], h1,
                               chunk=64)
        check(torch.equal(torch.cat([y1, y2], 1), base[0])
              and torch.equal(h2, base[1]),
              f"mamba_scan {dtype} split at 300 and resumed differs")
        out = ms.mamba_scan(*mamba_inputs(B, T, di, ds, dtype, gen,
                                          dt_scale=1e4), chunk=64)
        check(all(bool(torch.isfinite(t.float()).all()) for t in out),
              f"mamba_scan {dtype} not finite at dt x 1e4")
    print(f"[K7] bit-identical at chunks 1, 16, 64 and T={T} and d_inner "
          f"tiles 32, 64, 128 (f32, bf16, B={B} at full width); rows 0 and "
          "3 alone as in the batch; split at 300 and resumed from the final "
          "state bit-identical to the whole run; finite at dt x 1e4")

    # --- M2. K7b against its plain version and torch autograd -------------
    for label, (B, T, di_, ds_, C, bb) in cases:
        tr = ms.choose_blocks(T, di_, ds_, target=C, mode="bwd")
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[1]
            a = mamba_inputs(B, T, di_, ds_, dtype, gen)
            _, _, traj = ms.mamba_scan_traj(*a, chunk=tr.chunk,
                                            di_tile=tr.di_tile)
            dy, dhf = randn(B, T, di_, gen=gen).to(dtype), randn(
                B, di_, ds_, gen=gen)
            args = (*a[:5], traj, dy, dhf)
            got = ms.mamba_scan_bwd(*args, chunk=tr.chunk, di_tile=tr.di_tile)
            plain = ms.mamba_scan_bwd_plain(*args, tr.chunk)
            x = [t.clone().requires_grad_() for t in a]
            with torch.enable_grad():
                auto = torch.autograd.grad(ms.mamba_scan_plain(*x, tr.chunk),
                                           x, (dy, dhf))
            e_b = e_a = 0.0
            for n, g, pl, au in zip(names, got, plain, auto):
                check(g.dtype == pl.dtype == au.dtype,
                      f"mamba_scan_bwd {label} {name} {n}: dtype {g.dtype}")
                e_b = max(e_b, hold(g, pl, f"mamba_scan_bwd {label} {name} "
                                    f"{n} vs plain", n))
                e_a = max(e_a, hold(g, au, f"mamba_scan_bwd {label} {name} "
                                    f"{n} vs autograd", n))
            del auto, x
            errs["bwd"][name] = max(errs["bwd"][name], e_b)
            print(f"[K7b] {label} (B={B} T={T} di={di_} ds={ds_} "
                  f"C={tr.chunk} di_tile={tr.di_tile}) {name}: vs plain "
                  f"{e_b:.3e}, vs autograd of mamba_scan_plain {e_a:.3e}")
    tr = ms.choose_blocks(500, di, ds, target=cfg.ssm.chunk, mode="bwd")
    for dt_scale, dtype in ((1.0, bf16), (1e4, f32), (1e4, bf16)):
        a = mamba_inputs(4, 500, di, ds, dtype, gen, dt_scale)
        _, _, traj = ms.mamba_scan_traj(*a, chunk=tr.chunk)
        args = (*a[:5], traj, randn(4, 500, di, gen=gen).to(dtype),
                randn(4, di, ds, gen=gen))
        base = ms.mamba_scan_bwd(*args, chunk=tr.chunk)
        if dt_scale > 1:
            check(all(bool(torch.isfinite(g.float()).all()) for g in base),
                  f"mamba_scan_bwd {dtype}: a gradient is not finite at dt x"
                  " 1e4")
            continue
        check(all(torch.equal(g, w) for g, w in zip(
            ms.mamba_scan_bwd(*args, chunk=tr.chunk), base)),
              "mamba_scan_bwd: two runs differ")
        for i in (0, 3):
            alone = ms.mamba_scan_bwd(*(t[i:i + 1] if t.shape[0] == 4 and
                                        t.dim() >= 3 else t for t in args),
                                      chunk=tr.chunk)
            check(all(torch.equal(g[0], w[i]) for j, (g, w) in enumerate(
                zip(alone, base)) if names[j] != "da"),
                  f"mamba_scan_bwd row {i} alone differs from the batch")
    print(f"[K7b] two runs bit-identical (bf16, full width, T=500, "
          f"C={tr.chunk}); rows 0 and 3 alone as in the batch (all but dA, "
          "which sums the rows); gradients finite at dt x 1e4 (f32, bf16)")

    # --- M3. the stack at full width, 2 layers, f32 ------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = registry.build(cfg32)
    cgen = torch.Generator(device=device).manual_seed(0)
    p32 = m32.init(cgen, device)
    S, K = 300, 4
    toks = torch.randint(0, cfg.vocab, (2, S + K), generator=cgen,
                         device=device)
    with torch.no_grad(), tripwires(*plain_scans[:3]):
        reset_counts(*counted)
        fused, _ = m32.forward(p32, {"tokens": toks})
        check(counts() == only(mamba_scan=cfg.n_layers),
              f"2-layer forward: {counts()}")
        cache = m32.init_cache(2, S + K, device)
        reset_counts(*counted)
        first, cache = m32.prefill(p32, cache, {"tokens": toks[:, :S]})
        e2 = close(first[:, 0], fused[:, S - 1], "2-layer prefill vs "
                   "forward", CONSISTENCY_TOL)
        for t in range(K):
            d, cache = m32.decode_step(p32, cache, {"tokens": toks[:, S + t]})
            e2 = max(e2, close(d, fused[:, S + t], f"2-layer decode {t}",
                               CONSISTENCY_TOL))
        check(counts() == only(mamba_scan=cfg.n_layers * (1 + K)),
              f"2-layer prefill + {K} decode steps launched {counts()}")
    old = mamba.SCAN_PLAN
    mamba.SCAN_PLAN = "scan"
    try:
        with torch.no_grad():
            plain_logits, _ = m32.forward(p32, {"tokens": toks})
    finally:
        mamba.SCAN_PLAN = old
    e1 = close(fused, plain_logits, "2-layer f32 logits, fused_scan vs scan",
               tol["float32"])
    print(f"[model] {cfg.n_layers} x {cfg.d_model} (d_inner {di}) f32, "
          f"S={S}: fused_scan logits vs scan max abs err {e1:.3e} (MAMBA_TOL"
          f" f32); prefill + {K} decode steps vs forward over {S + K}: "
          f"{e2:.3e} ({CONSISTENCY_TOL}); {cfg.n_layers} launches a forward "
          f"or prefill, {cfg.n_layers} a decode step")
    del fused, plain_logits, cache
    leaves = tree_leaves(p32)
    for t in leaves:
        t.requires_grad_()
    batch = {"tokens": toks[:, :S]}
    L = cfg.n_layers

    def grads(remat: bool):
        reset_counts(*counted)
        loss, _ = steps_lib.loss_fn(p32, cfg32, batch, remat=remat)
        g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.detach(), g, counts()

    with tripwires(*plain_scans[:3]):
        loss_on, g_on, n_on = grads(True)
        loss_off, g_off, n_off = grads(False)
    for remat, n in ((True, n_on), (False, n_off)):
        check(n == only(mamba_scan_traj=(2 if remat else 1) * L,
                        mamba_scan_bwd=L),
              f"2-layer training step (remat {remat}) launched {n}")
    d_remat = max(float((a - b).abs().max()) for a, b in zip(g_on, g_off))
    for a, b in zip(g_on, g_off):
        close(a, b, "2-layer grads, remat on vs off", grad_tol)
    del g_off
    mamba.SCAN_PLAN = "scan"
    try:
        loss_p, g_p, n_p = grads(True)
    finally:
        mamba.SCAN_PLAN = old
    check(n_p == only(), f"scan training step launched {n_p}")
    e = close(loss_on, loss_p, "2-layer loss, fused_scan vs scan", grad_tol)
    for a, b in zip(g_on, g_p):
        e = max(e, close(a, b, "2-layer grads, fused_scan vs scan",
                         grad_tol))
    print(f"[train] {L} x {cfg.d_model} f32, B=2 S={S}: loss_fn grads "
          f"through fused_scan vs scan max abs err {e:.3e} (MAMBA_GRAD_TOL "
          f"f32); remat on vs off max abs diff {d_remat:.3e}; launches a "
          f"step: remat on {n_on['mamba_scan_traj']} K7t + "
          f"{n_on['mamba_scan_bwd']} K7b, off {n_off['mamba_scan_traj']} + "
          f"{n_off['mamba_scan_bwd']}, no K7")
    del p32, leaves, g_on, g_p
    torch.cuda.empty_cache()

    # --- M4. the stack in bf16, served ------------------------------------
    t0 = time.perf_counter()
    engine = serve_lm.build_engine(cfg, device, seed=0, batch_size=4,
                                   max_seq=500 + 16 + 1)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(engine.params))
    print(f"[serve] {cfg.name} attention-free, {cfg.n_layers} layers: "
          f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}, drawn from "
          f"seed 0 on the card in {time.perf_counter() - t0:.1f} s")
    lens = [412, 300, 377, 500, 333, 468, 451, 389]   # wave maxima 500, 468
    prng = np.random.default_rng(0)
    reqs = [Request(i, prng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate(lens)]
    seen = {"prefill": [], "calls": [], "finite": True}
    kernel, prefill, decode = (ms.mamba_scan, engine._prefill,
                               steps_lib.decode_step)

    def watched_prefill(params, cache, batch):
        before = kernel.launches
        logits, cache = prefill(params, cache, batch)
        seen["prefill"].append(kernel.launches - before)
        seen["finite"] &= bool(torch.isfinite(logits).all())
        return logits, cache

    def watched_decode(cfg_, params, cache, batch):
        logits, cache = decode(cfg_, params, cache, batch)
        seen["finite"] &= bool(torch.isfinite(logits).all())
        return logits, cache

    def captured_kernel(*args, **kwargs):
        """K7 as the serve calls it, keeping its inputs (h0 is a view of
        the cache, which the layer then overwrites) and outputs for the
        check against the plain version after the serve.  The wrapper
        counts its launches through its module's name, which is this
        function while it is installed: the count is carried across."""
        captured_kernel.launches = kernel.launches
        got_ = kernel(*args, **kwargs)
        kernel.launches = captured_kernel.launches
        seen["calls"].append(([a.clone() for a in args], kwargs, got_))
        return got_

    engine._prefill, steps_lib.decode_step = watched_prefill, watched_decode
    ms.mamba_scan = captured_kernel
    reset_counts(*counted)
    try:
        with tripwires(*plain_scans):
            served = serve_lm.serve(engine, reqs)
    finally:
        ms.mamba_scan, steps_lib.decode_step = kernel, decode
    got = counts()
    per_wave = cfg.n_layers * (1 + 16)
    check(got == only(mamba_scan=2 * per_wave)
          and seen["prefill"] == [cfg.n_layers] * 2,
          f"serve launched {got}, per prefill {seen['prefill']}")
    check(all(r.tokens.shape == (16,) and int(r.tokens.min()) >= 0
              and int(r.tokens.max()) < cfg.vocab for r in served["results"]),
          "served tokens outside [0, vocab) or not 16 a request")
    check(seen["finite"], "a served logit is not finite")
    check(served["pool"].buffers_built == served["pool"].capacity,
          f"the pool built {served['pool'].buffers_built} buffers")
    e_y = e_h = 0.0
    n_calls = len(seen["calls"])
    check(n_calls == got["mamba_scan"], f"captured {n_calls} calls")
    for i, (args, kwargs, (y, h)) in enumerate(seen["calls"]):
        want = ms.mamba_scan_plain(*args, kwargs["chunk"])
        e_y = max(e_y, close(y, want[0], f"served mamba_scan call {i} y",
                             tol["float32"]))
        e_h = max(e_h, close(h, want[1], f"served mamba_scan call {i} state",
                             tol["float32"]))
    x0 = seen["calls"][0][0][0]
    print(f"[serve] mamba_scan launches {got['mamba_scan']}: "
          f"{seen['prefill']} per prefill, {cfg.n_layers} a decode step, no "
          f"plain scan reached; every logit finite; buffers_built "
          f"{served['pool'].buffers_built} = capacity; each launch (prefill "
          f"x {tuple(x0.shape)} {x0.dtype}, decode at T=1) against "
          f"mamba_scan_plain on its own inputs: y max abs err {e_y:.3e}, "
          f"state {e_h:.3e} (MAMBA_TOL f32)")
    for i, w in enumerate(served["waves"]):
        print(f"[time] serve mamba wave {i}: prefill {w['prefill_ms']:.3f} "
              f"ms, decode {w['decode_ms_per_token']:.3f} ms/token (host "
              "clock)")
    serve_launches = got["mamba_scan"]
    del engine, served, seen
    torch.cuda.empty_cache()

    # --- M4. the stack in bf16, trained -----------------------------------
    n_steps = 8
    kernel_bwd, plain_bwd = ms.mamba_scan_bwd, ms.mamba_scan_bwd_plain
    seen = {"n": 0, "err": 0.0, "shape": None}

    def checked_bwd(*args, **kwargs):
        """K7b as the training step calls it; each launch of step 1 (the
        first L) held against the plain version on its own inputs, its
        launch count carried across as ``captured_kernel``'s."""
        checked_bwd.launches = kernel_bwd.launches
        got_ = kernel_bwd(*args, **kwargs)
        kernel_bwd.launches = checked_bwd.launches
        if seen["n"] < L:
            want = plain_bwd(*args, kwargs["chunk"])
            for n, g, w in zip(names, got_, want):
                seen["err"] = max(seen["err"], hold(
                    g, w, f"trained mamba_scan_bwd launch {seen['n']} {n}",
                    n))
            seen["n"] += 1
            seen["shape"] = (tuple(args[0].shape), args[0].dtype,
                             kwargs["chunk"], kwargs["di_tile"])
        return got_

    train_step = steps_lib.train_step
    profiles = []
    ms.mamba_scan_bwd = checked_bwd
    steps_lib.train_step = profiling(train_step, n_steps, profiles)
    reset_counts(*counted)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with tripwires(*plain_scans):
            report = train_lm.train(cfg, steps=n_steps, batch=4, seq=512,
                                    lr=3e-3, seed=0, device="cuda",
                                    log_every=1)
    finally:
        ms.mamba_scan_bwd, steps_lib.train_step = kernel_bwd, train_step
    wall = time.perf_counter() - t0
    got = counts()
    check(got == only(mamba_scan_traj=2 * L * n_steps,
                      mamba_scan_bwd=L * n_steps),
          f"{n_steps} training steps launched {got}")
    check(seen["n"] == L, f"checked {seen['n']} K7b launches of step 1")
    check(all(math.isfinite(x) for x in report["losses"]
              + report["grad_norms"]),
          f"a loss or grad_norm is not finite: {report['losses']}, "
          f"{report['grad_norms']}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = report["step_ms"][1:-2]
    med = statistics.median(step_ms)
    tokens = report["tokens_per_step"]
    model_flops = 6 * report["n_params"] * tokens
    print(f"[train] {cfg.name} attention-free: {report['n_params'] / 1e9:.3f}"
          f" B parameters in {cfg.dtype}, batch 4 x 512, {n_steps} steps in "
          f"{wall:.1f} s (init included); launches {got['mamba_scan_traj']} "
          f"K7t + {got['mamba_scan_bwd']} K7b ({2 * L} + {L} a step), none "
          "of K7, no plain scan reached; every loss and grad_norm finite; "
          f"loss {report['losses'][0]:.3f} -> {report['losses'][-1]:.3f}; "
          f"peak device memory {peak:.2f} GB "
          "(torch.cuda.max_memory_allocated)")
    print(f"[train] each of step 1's {seen['n']} K7b launches (x "
          f"{seen['shape'][0]} {seen['shape'][1]}, C={seen['shape'][2]}, "
          f"di_tile={seen['shape'][3]}) against mamba_scan_bwd_plain on its "
          f"own inputs: max abs err {seen['err']:.3e} (MAMBA_GRAD_TOL f32, "
          "atol x max|grad|; db, dc, da within its rtol of their max)")
    print(f"[time] training step, {cfg.name} attention-free, batch 4 x 512, "
          f"steps 2 to {n_steps - 2}: median {med:.3f} ms, min "
          f"{min(step_ms):.3f} ms (host clock around the step, ending in the "
          f"loss's copy to the host); {tokens / (med / 1e3):.1f} tokens/s; "
          f"model FLOPs (6 x params x tokens, {model_flops:.3e} a step) at "
          f"{model_flops / (med / 1e3) / BF16_FLOP_PER_S:.2%} of the H100's "
          "989 TFLOP/s bf16 dense peak")
    print_step_profile(profiles, med)
    train_launches = {"mamba_scan_traj": got["mamba_scan_traj"],
                      "mamba_scan_bwd": got["mamba_scan_bwd"]}
    torch.cuda.empty_cache()

    # --- M5. the kernels' times at full width -----------------------------
    # back to back and in a CUDA graph (device time alone), each beside its
    # bound: K7 at the serving table's tiling as the prefill (B=4, T=512)
    # and as the served decode step (T=1), K7t and K7b at the training
    # table's
    B, T = 4, 512
    sv = ms.choose_blocks(T, di, ds, target=cfg.ssm.chunk)
    tr = ms.choose_blocks(T, di, ds, target=cfg.ssm.chunk, mode="bwd")
    rows = {}
    for dtype in (f32, bf16):
        a = mamba_inputs(B, T, di, ds, dtype, gen)
        # a decode step's inputs are whole tensors of one step, as the
        # model hands them over (no copy kernel of a strided view timed)
        one = tuple(t[:, :1].contiguous() for t in a[:4]) + a[4:]
        _, _, traj = ms.mamba_scan_traj(*a, chunk=tr.chunk,
                                        di_tile=tr.di_tile)
        args = (*a[:5], traj, randn(B, T, di, gen=gen).to(dtype),
                randn(B, di, ds, gen=gen))
        for name, fn, plain_fn, work, it in (
                ("mamba_scan",
                 lambda: ms.mamba_scan(*a, chunk=sv.chunk,
                                       di_tile=sv.di_tile),
                 lambda: ms.mamba_scan_plain(*a, sv.chunk),
                 mamba_fwd_work(B, T, di, ds, sv.chunk, dtype), 20),
                ("mamba_scan decode",
                 lambda: ms.mamba_scan(*one, chunk=1, di_tile=sv.di_tile),
                 lambda: ms.mamba_scan_plain(*one, 1),
                 mamba_fwd_work(B, 1, di, ds, 1, dtype), 50),
                ("mamba_scan_traj",
                 lambda: ms.mamba_scan_traj(*a, chunk=tr.chunk,
                                            di_tile=tr.di_tile),
                 lambda: ms.mamba_scan_traj_plain(*a, tr.chunk),
                 mamba_fwd_work(B, T, di, ds, tr.chunk, dtype, traj=True),
                 20),
                ("mamba_scan_bwd",
                 lambda: ms.mamba_scan_bwd(*args, chunk=tr.chunk,
                                           di_tile=tr.di_tile),
                 lambda: ms.mamba_scan_bwd_plain(*args, tr.chunk),
                 mamba_bwd_work(B, T, di, ds, tr.chunk, dtype), 10)):
            t_bound, by = bound(*work)
            r = rows[name, dtype] = dict(
                ms=time_ms(fn, it), graph_ms=graph_ms(fn, 10),
                plain_ms=time_ms(plain_fn, 1, repeats=3),
                bound_ms=t_bound, bound_by=by)
            tiles = sv if name.startswith("mamba_scan ") or \
                name == "mamba_scan" else tr
            print(f"[time] {name} B={B} T={1 if 'decode' in name else T} "
                  f"di={di} ds={ds} C={1 if 'decode' in name else tiles.chunk}"
                  f" di_tile={tiles.di_tile} {str(dtype).split('.')[1]}: "
                  f"kernel {r['ms']:.4f} ms back to back, {r['graph_ms']:.4f}"
                  f" ms in a CUDA graph, plain {r['plain_ms']:.4f} ms, "
                  f"library none (no single PyTorch call computes a "
                  f"selective scan), bound {r['bound_ms']:.3e} ms "
                  f"({r['bound_by']}), kernel at "
                  f"{r['graph_ms'] / r['bound_ms']:.2f}x it in a graph")
    # the training pair at other chunks than the table's, and K7 at the
    # config's own (f32, in a CUDA graph)
    a = mamba_inputs(B, T, di, ds, f32, gen)
    k7 = graph_ms(lambda: ms.mamba_scan(*a, chunk=cfg.ssm.chunk), 10)
    alt = [f"K7 at chunk {cfg.ssm.chunk} {k7:.4f} ms against "
           f"{rows['mamba_scan', f32]['graph_ms']:.4f} at {sv.chunk}"]
    for tile in (64, 32):
        k7 = graph_ms(lambda: ms.mamba_scan(*a, chunk=sv.chunk,
                                            di_tile=tile), 10)
        alt.append(f"K7 at di_tile {tile} {k7:.4f} ms")
    for C in (16, 64):
        _, _, traj = ms.mamba_scan_traj(*a, chunk=C, di_tile=tr.di_tile)
        args = (*a[:5], traj, randn(B, T, di, gen=gen),
                randn(B, di, ds, gen=gen))
        k7t = graph_ms(lambda: ms.mamba_scan_traj(
            *a, chunk=C, di_tile=tr.di_tile), 10)
        k7b = graph_ms(lambda: ms.mamba_scan_bwd(
            *args, chunk=C, di_tile=tr.di_tile), 5)
        alt.append(f"K7t and K7b at chunk {C} {k7t:.4f} and {k7b:.4f} ms")
    occupancy = [ms.bwd_blocks_per_sm(t, T, ds, tr.chunk, tr.di_tile)
                 for t in (f32, bf16)]
    print(f"[time] K7b holds {occupancy[0]} blocks of "
          f"{ms.BWD_LANES * tr.di_tile} threads an SM in f32, {occupancy[1]}"
          " in bf16 (the runtime's occupancy calculator)")
    for t in (f32, bf16):
        fwd_occ = [ms.fwd_blocks_per_sm(t, T_, ds, C, tile, traj)
                   for T_, C, tile, traj in ((T, sv.chunk, sv.di_tile, False),
                                             (1, 1, sv.di_tile, False),
                                             (T, tr.chunk, tr.di_tile, True))]
        print(f"[time] {str(t).split('.')[1]}: K7 prefill holds "
              f"{fwd_occ[0]} blocks of {sv.di_tile} threads an SM, the T=1 "
              f"one-phase path {fwd_occ[1]} of 128, K7t {fwd_occ[2]} of "
              f"{tr.di_tile} (the runtime's occupancy calculator)")
    print(f"[time] f32 tilings in a CUDA graph: {'; '.join(alt)}; the "
          f"table's (chunk {tr.chunk}) "
          f"{rows['mamba_scan_traj', f32]['graph_ms']:.4f} and "
          f"{rows['mamba_scan_bwd', f32]['graph_ms']:.4f} ms")
    for name in ("mamba_scan", "mamba_scan_bwd"):
        compiled = ""
        for line in BUILD_LOGS.get(name, "").splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                compiled = entry.group(1)
            elif "registers" in line or "spill" in line:
                kernel = re.search(r"[0-9]([a-z_]+_kernel)I", compiled)
                print(f"[time] {name} {kernel.group(1) if kernel else ''}"
                      f"{instance(compiled)}: {line.strip()}")
    print(f"[K7/K7t/K7b] max abs err vs plain: K7 f32 "
          f"{errs['fwd']['float32']:.3e}, bf16 {errs['fwd']['bfloat16']:.3e}"
          f"; K7t f32 {errs['traj']['float32']:.3e}, bf16 "
          f"{errs['traj']['bfloat16']:.3e}; K7b f32 "
          f"{errs['bwd']['float32']:.3e}, bf16 {errs['bwd']['bfloat16']:.3e};"
          f" bf16 dx within {bf16_step['share']:.3e} x max|want| (held at "
          f"one bf16 step, 2^-7 = {2.0 ** -7:.3e})")
    # the model hands the scan its input in f32 (what JAX's scan computes
    # with), so the main path runs the f32-IO instances: their rows go in;
    # K7's row also splits its launches into the served prefills and decode
    # steps (one prefill and 16 decode steps a layer a wave)
    launches = dict(mamba_scan=serve_launches, **train_launches)
    prefills = serve_launches // (1 + 16)
    entries = []
    for name, err, replaces in (
            ("mamba_scan", "fwd", "src/repro/kernels/mamba_scan.py:217"),
            ("mamba_scan_traj", "traj",
             "src/repro/kernels/mamba_scan.py:223"),
            ("mamba_scan_bwd", "bwd", "src/repro/kernels/mamba_scan.py:232")):
        r = rows[name, f32]
        src = "mamba_scan_bwd.cu" if name == "mamba_scan_bwd" \
            else "mamba_scan.cu"
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[err]["float32"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "graph_ms": r["graph_ms"],
            "bf16_graph_ms": rows[name, bf16]["graph_ms"]})
        if name == "mamba_scan":
            d = rows["mamba_scan decode", f32]
            entries[-1].update(
                prefill_launches=prefills,
                decode_launches=launches[name] - prefills,
                decode_ms=d["ms"], decode_graph_ms=d["graph_ms"],
                decode_bound_ms=d["bound_ms"])
    return entries


def attn_inputs(B, S, Hq, Hkv, dh, dtype, gen):
    """q (B, S, Hq, dh) and k, v (B, S, Hkv, dh) in ``dtype``, on the card
    (S = 1 and the query squeezed for a decode step's q)."""
    return (randn(B, S, Hq, dh, gen=gen).to(dtype),
            randn(B, S, Hkv, dh, gen=gen).to(dtype),
            randn(B, S, Hkv, dh, gen=gen).to(dtype))


def prefill_work(B, S, Hq, Hkv, dh, dtype) -> tuple[int, int]:
    """(bytes, operations) of one K8 launch: q, k, v in and o out in the IO
    type, each once; the causal half of the two products, 4 B Hq dh
    S (S + 1) / 2 (a multiply-add is 2)."""
    io = 2 if dtype == torch.bfloat16 else 4
    return (io * B * S * dh * (2 * Hq + 2 * Hkv),
            4 * B * Hq * dh * S * (S + 1) // 2)


def decode_work(B, Hq, Hkv, dk, lengths, dtype) -> tuple[int, int]:
    """(bytes, operations) of one K9 launch: the k and v rows below each
    row's length, q in and o out, in the IO type; the two products over
    those rows (4 Hq dk a row and position)."""
    io = 2 if dtype == torch.bfloat16 else 4
    n = int(lengths.clamp_min(0).sum())
    return (io * (2 * n * Hkv * dk + 2 * B * Hq * dk), 4 * n * Hq * dk)


def attention_slice(device, gen, counted, counts, only) -> list[dict]:
    """The dense attention slice: K8 against its plain version (A1); K9
    against its plain version (A2); Qwen2-0.5B at full width and depth in
    f32, across plans and prefill + decode against its own forward (A3);
    Qwen2-0.5B and Yi-9B in bf16 served through ``launch/serve.py``,
    counted, the plain attention functions armed to raise, every launch
    then held against its plain version on its own inputs, and served
    again uncaptured for the times (A4); the two
    kernels' times beside SDPA's (A5).  Returns their entries of the
    ``kernels`` line."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ref
    from repro_torch import steps as steps_lib
    from repro_torch.launch import serve as serve_lm
    from repro_torch.models import attention, registry
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serving import Request

    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    #: the JAX package's kernel tolerances (tests/test_flash_prefill.py):
    #: 2e-4 against the oracle and across tiles; per dtype 1e-4 f32, 3e-2
    #: bf16 (an output rounded to bf16 on both sides)
    tol = {f32: dict(rtol=2e-4, atol=2e-4), bf16: dict(rtol=3e-2, atol=3e-2)}
    #: K8's tensor-core instance against the plain version with p rounded
    #: as the kernel rounds it: one bf16 step of each output (2^-7 of it;
    #: both sides round the output to bf16, from f32 sums taken in another
    #: order), plus 2^-7 for a p that lands on the other side of a bf16
    #: step (the scores' last f32 bits differ) in a row of few keys, where
    #: one p moves o by up to 2^-8 |v| / l
    tc_tol = dict(rtol=2 ** -7, atol=2 ** -7)
    err_rp = 0.0
    plain_attention = ((fp, "flash_prefill_plain"), (da, "decode_attn_plain"),
                       (attention, "flash_attention"),
                       (attention, "_decode_einsum"), (ref, "prefill_attn"),
                       (ref, "decode_attn"))
    errs = {"flash_prefill": {f32: 0.0, bf16: 0.0},
            "decode_attn": {f32: 0.0, bf16: 0.0}}

    # --- A1. K8 against its plain version ---------------------------------
    # f32 runs the SIMT instance at each case's tiles; bf16 the tensor-core
    # instance at its own (q_block 64, k_block from the bf16 table), held
    # to the plain version at the same tiles twice: with p rounded to bf16
    # before the PV product as the kernel rounds it (round_p) at
    # tc_tol, and as the JAX kernel computes (p in f32) at bf16's
    # 3e-2.
    cases = [  # tests/test_flash_prefill.py's sweep, dtype and model cases
        (2, 64, 4, 2, 32, 16, 16, 0), (1, 128, 8, 8, 16, 32, 64, 0),
        (2, 96, 4, 1, 32, 32, 32, 24), (1, 60, 2, 2, 16, 16, 16, 0),
        (1, 60, 2, 2, 16, 16, 16, 20), (1, 64, 4, 2, 32, 32, 32, 0),
        (2, 96, 4, 2, 16, 32, 32, 0),
        # Qwen2-0.5B's served prefills, Yi-9B's, 8/8 x 160, a window of 64
        (4, 500, 14, 2, 64, None, None, 0), (4, 468, 14, 2, 64, None, None, 0),
        (4, 500, 32, 4, 128, None, None, 0), (2, 500, 8, 8, 160, None, None, 0),
        (4, 500, 14, 2, 64, None, None, 64)]
    for B, S, Hq, Hkv, dh, qb, kb, w in cases:
        blocks = fp.choose_blocks(S, dh)
        qb_, kb_ = qb or blocks.q_block, kb or blocks.k_block
        q, k, v = attn_inputs(B, S, Hq, Hkv, dh, f32, gen)
        got = fp.flash_prefill(q, k, v, window=w, q_block=qb, k_block=kb)
        want = fp.flash_prefill_plain(q, k, v, window=w, q_block=qb_,
                                      k_block=kb_)
        check(got.dtype == f32 and got.shape == q.shape,
              f"flash_prefill {B, S, Hq, Hkv, dh}: {got.dtype} "
              f"{tuple(got.shape)}")
        e32 = close(got, want, f"flash_prefill {(B, S, Hq, Hkv, dh, qb_, kb_, w)}"
                    " float32", tol[f32])
        errs["flash_prefill"][f32] = max(errs["flash_prefill"][f32], e32)
        tc = fp.choose_blocks(S, dh, bf16)
        q, k, v = attn_inputs(B, S, Hq, Hkv, dh, bf16, gen)
        before = fp.flash_prefill.tc_launches
        got = fp.flash_prefill(q, k, v, window=w)
        check(got.dtype == bf16 and got.shape == q.shape
              and fp.flash_prefill.tc_launches == before + 1,
              f"flash_prefill {B, S, Hq, Hkv, dh} bf16: {got.dtype} "
              f"{tuple(got.shape)}, not on the tensor-core instance")
        e_rp = close(got.float(), fp.flash_prefill_plain(
            q, k, v, window=w, q_block=tc.q_block, k_block=tc.k_block,
            round_p=True).float(), f"flash_prefill {(B, S, Hq, Hkv, dh, w)} "
            f"bf16 {tuple(tc)} vs round_p plain", tc_tol)
        e16 = close(got.float(), fp.flash_prefill_plain(
            q, k, v, window=w, q_block=tc.q_block,
            k_block=tc.k_block).float(), f"flash_prefill "
            f"{(B, S, Hq, Hkv, dh, w)} bf16 {tuple(tc)}", tol[bf16])
        errs["flash_prefill"][bf16] = max(errs["flash_prefill"][bf16], e16)
        err_rp = max(err_rp, e_rp)
        print(f"[K8] B={B} S={S} {Hq}/{Hkv} x {dh} window={w}: f32 (q_block "
              f"{qb_}, k_block {kb_}) vs plain max abs err {e32:.3e}; bf16 "
              f"tensor cores (q_block {tc.q_block}, k_block {tc.k_block}) "
              f"vs round_p plain {e_rp:.3e}, vs plain {e16:.3e}")
    q, k, v = attn_inputs(4, 500, 14, 2, 64, f32, gen)
    base = fp.flash_prefill(q, k, v)
    for qb, kb in ((16, 64), (32, 32), (48, 16), (64, 2)):
        close(fp.flash_prefill(q, k, v, q_block=qb, k_block=kb), base,
              f"flash_prefill tiles ({qb}, {kb}) vs default", tol[f32])
    for Hq, Hkv, dh in ((14, 2, 64), (32, 4, 128), (8, 8, 160)):
        q, k, v = attn_inputs(2, 500, Hq, Hkv, dh, bf16, gen)
        base = fp.flash_prefill(q, k, v).float()
        for kb in fp.TC_K_BLOCKS:
            close(fp.flash_prefill(q, k, v, k_block=kb).float(), base,
                  f"flash_prefill bf16 {Hq}/{Hkv} x {dh} k_block {kb} vs "
                  "default", tol[bf16])
    q, k, v = attn_inputs(4, 500, 14, 2, 64, f32, gen)
    q.requires_grad_()
    try:
        fp.flash_prefill(q, k, v)
        raised = False
    except RuntimeError:
        raised = True
    check(raised, "flash_prefill under autograd did not raise on the card")
    print(f"[K8] max abs err vs plain: f32 "
          f"{errs['flash_prefill'][f32]:.3e}, bf16 "
          f"{errs['flash_prefill'][bf16]:.3e} (vs round_p plain "
          f"{err_rp:.3e}, within rtol {tc_tol['rtol']:.4g} atol "
          f"{tc_tol['atol']:.4g}); f32 results within 2e-4 at q/k "
          "tiles (16, 64), (32, 32), (48, 16), (64, 2); bf16 within 3e-2 at "
          f"k_block {fp.TC_K_BLOCKS} at dh 64, 128, 160; raises under "
          "autograd")

    # --- A2. K9 against its plain version ---------------------------------
    # each case against the plain version at the table's split (block_s,
    # splits): each split's online softmax, then the merge in split order;
    # two runs bit-identical
    cases = [  # tests/test_kernels.py::test_decode_attn_sweep, then the
        # served decode shapes of Qwen2-0.5B and Yi-9B at lengths 0, 1, 63,
        # 64, 65, 300, 508 and 517 (one row each), and StableLM's heads
        (2, 8, 2, 96, 32, 32, None), (1, 4, 4, 64, 64, 64, None),
        (3, 16, 2, 128, 16, 128, None), (2, 2, 1, 33, 8, 16, None),
        (4, 14, 2, 517, 64, None, [0, 1, 63, 64]),
        (4, 14, 2, 517, 64, None, [65, 300, 508, 517]),
        (4, 32, 4, 517, 128, None, [0, 1, 63, 64]),
        (4, 32, 4, 517, 128, None, [65, 300, 508, 517]),
        (2, 32, 8, 517, 160, None, [300, 508])]
    for B, Hq, Hkv, S, dk, bs, lens in cases:
        if lens is None:
            lens = (torch.arange(1, B + 1) * (S // (B + 1)) + 1).tolist()
        lens = torch.tensor(lens, dtype=torch.int32, device=device)
        e_case, picked = {}, {}
        for dtype in (f32, bf16):
            bl = da.choose_blocks(S, B, Hkv, Hq // Hkv, dk, dtype,
                                  block_s=bs)
            picked[dtype] = (bl.block_s, bl.splits)
            q = randn(B, Hq, dk, gen=gen).to(dtype)
            _, kc, vc = attn_inputs(B, S, Hkv, Hkv, dk, dtype, gen)
            got = da.decode_attn(q, kc, vc, lens, block_s=bs)
            want = da.decode_attn_plain(q, kc, vc, lens, block_s=bl.block_s,
                                        splits=bl.splits)
            e = close(got.float(), want.float(),
                      f"decode_attn {(B, Hq, Hkv, S, dk)} {tuple(bl)} "
                      f"{dtype}", tol[dtype])
            check(torch.equal(got, da.decode_attn(q, kc, vc, lens,
                                                  block_s=bs)),
                  f"decode_attn {(B, Hq, Hkv, S, dk)} {dtype}: two runs "
                  "differ")
            errs["decode_attn"][dtype] = max(errs["decode_attn"][dtype], e)
            e_case[dtype] = e
            zero = (lens == 0).nonzero().flatten().tolist()
            check(all(bool((got[i] == 0).all()) for i in zero),
                  f"decode_attn {(B, Hq, Hkv, S, dk)}: a row of length 0 "
                  "is not 0")
        print(f"[K9] B={B} {Hq}/{Hkv} x {dk} S={S} (block_s, splits) f32 "
              f"{picked[f32]}, bf16 {picked[bf16]}, lengths "
              f"{lens.tolist()}: vs plain max abs err f32 {e_case[f32]:.3e}, "
              f"bf16 {e_case[bf16]:.3e}; two runs bit-identical"
              + ("; length 0 gives 0" if 0 in lens.tolist() else ""))
    # 20 launches captured in one CUDA graph, replayed twice, equal to the
    # eager calls: each launch leaves its arrival counters at 0
    for Hq, Hkv, dk in ((14, 2, 64), (32, 4, 128)):
        q = randn(4, Hq, dk, gen=gen).to(bf16)
        _, kc, vc = attn_inputs(4, 517, Hkv, Hkv, dk, bf16, gen)
        lens = torch.tensor([508, 1, 0, 300], dtype=torch.int32,
                            device=device)
        eager = da.decode_attn(q, kc, vc, lens)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            da.decode_attn(q, kc, vc, lens)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [da.decode_attn(q, kc, vc, lens) for _ in range(20)]
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            check(all(torch.equal(o, eager) for o in outs),
                  f"decode_attn {Hq}/{Hkv} x {dk}: a graph replay differs "
                  "from the eager call")
        check(torch.equal(da.decode_attn(q, kc, vc, lens), eager),
              f"decode_attn {Hq}/{Hkv} x {dk}: an eager call after the "
              "replays differs")
        print(f"[K9] {Hq}/{Hkv} x {dk} bf16: 20 launches in a CUDA graph, "
              "replayed twice, bit-identical to the eager call")
    # across block_s (each with the table's split for it), f32: at Yi's
    # heads 1, 16 and 100; 128 there would stage 256 KB of k/v, so the
    # table finds no launch and the wrapper raises; 128 at Qwen2's heads
    lens = torch.tensor([1, 64, 300, 517], dtype=torch.int32, device=device)
    for Hq, Hkv, dk, sizes in ((32, 4, 128, (1, 16, 100)),
                               (14, 2, 64, (128,))):
        q = randn(4, Hq, dk, gen=gen)
        _, kc, vc = attn_inputs(4, 517, Hkv, Hkv, dk, f32, gen)
        base = da.decode_attn(q, kc, vc, lens)
        for bs in sizes:
            close(da.decode_attn(q, kc, vc, lens, block_s=bs), base,
                  f"decode_attn {Hq}/{Hkv} x {dk} block_s {bs} vs default",
                  tol[f32])
    q = randn(4, 32, 128, gen=gen)
    _, kc, vc = attn_inputs(4, 517, 4, 4, 128, f32, gen)
    try:
        da.decode_attn(q, kc, vc, lens, block_s=128)
        raised = False
    except ValueError:
        raised = True
    check(raised, "decode_attn f32 32/4 x 128 at block_s 128 (256 KB of "
          "k/v stages) did not raise")
    print(f"[K9] max abs err vs plain: f32 {errs['decode_attn'][f32]:.3e}, "
          f"bf16 {errs['decode_attn'][bf16]:.3e}; f32 results within 2e-4 "
          "at block_s 1, 16, 100 (32/4 x 128) and 128 (14/2 x 64); 32/4 x "
          "128 at block_s 128 raises (no launch in the table)")

    # --- A3. Qwen2-0.5B at full width and depth, f32 ----------------------
    cfg32 = dataclasses.replace(get_arch("qwen2-0.5b"), dtype="float32")
    model = registry.build(cfg32)
    p32 = model.init(torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(t.numel() for t in tree_leaves(p32))
    L, S, K = cfg32.n_layers, 300, 4
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg32.vocab, (2, S + K)).astype(np.int32)).to(device)

    def run(prefill_plan: str, decode_plan: str):
        """forward over S + K, then prefill S + K decode steps, under the
        given plans: (forward logits, each step's logits, launches of the
        forward, the prefill and each decode step)."""
        old = attention.PREFILL_PLAN, attention.DECODE_PLAN
        attention.PREFILL_PLAN, attention.DECODE_PLAN = (prefill_plan,
                                                         decode_plan)
        try:
            with torch.no_grad():
                reset_counts(*counted)
                full, _ = model.forward(p32, {"tokens": toks})
                n = [counts()]
                cache = model.init_cache(2, S + K, device=device)
                reset_counts(*counted)
                first, cache = model.prefill(p32, cache,
                                             {"tokens": toks[:, :S]})
                n.append(counts())
                outs = [first[:, 0]]
                for t in range(K):
                    reset_counts(*counted)
                    logits, cache = model.decode_step(
                        p32, cache, {"tokens": toks[:, S + t]})
                    n.append(counts())
                    outs.append(logits)
            torch.cuda.synchronize()
        finally:
            attention.PREFILL_PLAN, attention.DECODE_PLAN = old
        return full, outs, n

    with tripwires(*plain_attention[:2], *plain_attention[4:]):
        full, outs, n_k = run("flash_prefill", "decode_attn")
    check(n_k[:2] == [only(flash_prefill=L)] * 2
          and n_k[2:] == [only(decode_attn=L)] * K
          and fp.flash_prefill.tc_launches == 0,
          f"f32 Qwen2 launches (forward, prefill, decode steps): {n_k}, "
          f"{fp.flash_prefill.tc_launches} on K8's tensor cores")
    e2 = max(close(o, full[:, S - 1 + t], f"f32 Qwen2 step {t} vs forward",
                   CONSISTENCY_TOL) for t, o in enumerate(outs))
    plain_full, plain_outs, n_p = run("blocked", "einsum")
    check(all(n == only() for n in n_p), f"plain plans launched {n_p}")
    e1 = close(full, plain_full, "f32 Qwen2 forward, flash_prefill vs "
               "blocked", tol[f32])
    e1d = max(close(a, b, f"f32 Qwen2 step {t}, kernels vs blocked/einsum",
                    tol[f32]) for t, (a, b) in enumerate(zip(outs,
                                                             plain_outs)))
    print(f"[model] {cfg32.name} {L} x {cfg32.d_model} f32 ({n_params / 1e9:.3f}"
          f" B parameters), B=2 S={S}: forward logits flash_prefill vs "
          f"blocked max abs err {e1:.3e}, prefill + {K} decode steps "
          f"through K8/K9 vs blocked/einsum {e1d:.3e} (2e-4); vs the "
          f"forward over {S + K}: {e2:.3e} ({CONSISTENCY_TOL}); {L} K8 "
          f"launches a forward or prefill, {L} K9 a decode step")
    del p32, full, outs, plain_full, plain_outs, model
    torch.cuda.empty_cache()

    # --- A4. Qwen2-0.5B and Yi-9B in bf16, served --------------------------
    lens_req = [412, 300, 377, 500, 333, 468, 451, 389]  # wave maxima 500, 468
    served_launches = {"flash_prefill": 0, "decode_attn": 0}
    served_err = {"flash_prefill": 0.0, "decode_attn": 0.0}
    for name in ("qwen2-0.5b", "yi-9b"):
        cfg = get_arch(name)
        t0 = time.perf_counter()
        engine = serve_lm.build_engine(cfg, device, seed=0, batch_size=4,
                                       max_seq=500 + 16 + 1)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(engine.params))
        print(f"[serve] {cfg.name}: {cfg.n_layers} x {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, {n_params / 1e9:.3f} B parameters "
              f"in {cfg.dtype}, drawn from seed 0 on the card in "
              f"{time.perf_counter() - t0:.1f} s")
        prng = np.random.default_rng(0)
        reqs = [Request(i, prng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                        max_new_tokens=16) for i, n in enumerate(lens_req)]
        seen = {"calls": {"flash_prefill": [], "decode_attn": []},
                "prefill": [], "decode": [], "finite": True}
        kernels = {"flash_prefill": fp.flash_prefill,
                   "decode_attn": da.decode_attn}
        prefill, decode = engine._prefill, steps_lib.decode_step

        def watched_prefill(params, cache, batch):
            before = kernels["flash_prefill"].launches
            logits, cache = prefill(params, cache, batch)
            seen["prefill"].append(kernels["flash_prefill"].launches - before)
            seen["finite"] &= bool(torch.isfinite(logits).all())
            return logits, cache

        def watched_decode(cfg_, params, cache, batch):
            before = kernels["decode_attn"].launches
            logits, cache = decode(cfg_, params, cache, batch)
            seen["decode"].append(kernels["decode_attn"].launches - before)
            seen["finite"] &= bool(torch.isfinite(logits).all())
            return logits, cache

        def capture(kname):
            """The kernel as the serve calls it, keeping clones of its
            inputs (the caches are written after the call and zeroed
            between waves) and its output for the check against the plain
            version after the serve; the launch count is carried across,
            as in the Mamba slice."""
            kernel = kernels[kname]
            attrs = [a for a in ("launches", "tc_launches")
                     if hasattr(kernel, a)]

            def captured(*args, **kwargs):
                for a in attrs:
                    setattr(captured, a, getattr(kernel, a))
                out = kernel(*args, **kwargs)
                for a in attrs:
                    setattr(kernel, a, getattr(captured, a))
                seen["calls"][kname].append(
                    ([a.clone() for a in args], kwargs, out))
                return out
            for a in attrs:
                setattr(captured, a, getattr(kernel, a))
            return captured

        engine._prefill, steps_lib.decode_step = watched_prefill, \
            watched_decode
        fp.flash_prefill = capture("flash_prefill")
        da.decode_attn = capture("decode_attn")
        reset_counts(*counted)
        try:
            with tripwires(*plain_attention):
                served = serve_lm.serve(engine, reqs)
        finally:
            fp.flash_prefill = kernels["flash_prefill"]
            da.decode_attn = kernels["decode_attn"]
            steps_lib.decode_step = decode
        got = counts()
        n_tc = kernels["flash_prefill"].tc_launches
        Lc = cfg.n_layers
        check(got == only(flash_prefill=2 * Lc, decode_attn=2 * 16 * Lc)
              and seen["prefill"] == [Lc] * 2
              and seen["decode"] == [Lc] * 32
              and n_tc == got["flash_prefill"],
              f"{name} serve launched {got}, {n_tc} K8 on the tensor cores; "
              f"per prefill {seen['prefill']}, per decode step "
              f"{sorted(set(seen['decode']))}")
        check(all(r.tokens.shape == (16,) and int(r.tokens.min()) >= 0
                  and int(r.tokens.max()) < cfg.vocab
                  for r in served["results"]),
              f"{name}: served tokens outside [0, vocab) or not 16 a request")
        check(seen["finite"], f"{name}: a served logit is not finite")
        check(served["pool"].buffers_built == served["pool"].capacity,
              f"{name}: the pool built {served['pool'].buffers_built} "
              "buffers")
        for kname, calls in seen["calls"].items():
            check(len(calls) == got[kname],
                  f"{name}: captured {len(calls)} {kname} calls")
            for i, (args, kwargs, out) in enumerate(calls):
                if kname == "flash_prefill":
                    bl = fp.choose_blocks(args[0].shape[1], args[0].shape[3],
                                          args[0].dtype)
                    want = fp.flash_prefill_plain(
                        *args, window=kwargs.get("window", 0),
                        q_block=bl.q_block, k_block=bl.k_block)
                else:
                    B_, S_, Hkv_, dk_ = args[1].shape
                    bl = da.choose_blocks(S_, B_, Hkv_,
                                          args[0].shape[1] // Hkv_, dk_,
                                          args[0].dtype)
                    want = da.decode_attn_plain(*args, block_s=bl.block_s,
                                                splits=bl.splits)
                served_err[kname] = max(served_err[kname], close(
                    out.float(), want.float(),
                    f"{name} served {kname} call {i}", tol[bf16]))
            served_launches[kname] += got[kname]
        q0 = seen["calls"]["flash_prefill"][0][0][0]
        k0 = seen["calls"]["decode_attn"][0][0][1]
        print(f"[serve] {name}: {got['flash_prefill']} K8 launches "
              f"({seen['prefill']} per prefill; {n_tc} on the tensor-core "
              f"instance) and {got['decode_attn']} K9 "
              f"({Lc} a decode step), no plain attention reached; every "
              f"logit finite; buffers_built {served['pool'].buffers_built} "
              f"= capacity; each launch (K8 at q {tuple(q0.shape)}, K9 over "
              f"caches {tuple(k0.shape)}, {q0.dtype}) against its plain "
              f"version on its own inputs: K8 max abs err "
              f"{served_err['flash_prefill']:.3e}, K9 "
              f"{served_err['decode_attn']:.3e} (bf16 3e-2)")
        # the same requests again, nothing captured: the serve's times
        reset_counts(*counted)
        with tripwires(*plain_attention):
            timed = serve_lm.serve(engine, reqs)
        check(counts() == got and fp.flash_prefill.tc_launches == n_tc,
              f"{name}: the second serve launched {counts()}, "
              f"{fp.flash_prefill.tc_launches} K8 on the tensor cores")
        check(all(np.array_equal(a.tokens, b.tokens) for a, b in zip(
            timed["results"], served["results"])),
              f"{name}: the second serve's tokens differ from the first's")
        for i, (w, wc) in enumerate(zip(timed["waves"], served["waves"])):
            print(f"[time] serve {name} wave {i}: prefill "
                  f"{w['prefill_ms']:.3f} ms, decode "
                  f"{w['decode_ms_per_token']:.3f} ms/token (host clock; "
                  f"the first serve, launches captured: "
                  f"{wc['prefill_ms']:.3f} and "
                  f"{wc['decode_ms_per_token']:.3f})")
        print(f"[serve] {name}: a second serve of the same requests, "
              "nothing captured, launched as many kernels and gave the same "
              "tokens")
        del engine, served, timed, seen
        torch.cuda.empty_cache()

    # --- A5. the kernels' times at the served shapes ----------------------
    rows = {}
    for name, (Hq, Hkv, dh) in (("qwen2-0.5b", (14, 2, 64)),
                                ("yi-9b", (32, 4, 128))):
        B, S = 4, 500
        q, k, v = attn_inputs(B, S, Hq, Hkv, dh, bf16, gen)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bl = fp.choose_blocks(S, dh, bf16)
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        e_lib = close(lib.transpose(1, 2).float(), fp.flash_prefill(
            q, k, v).float(), f"SDPA vs K8 at {name}", tol[bf16])
        work = prefill_work(B, S, Hq, Hkv, dh, bf16)
        t_bound, by = bound(*work, flop_rate=BF16_FLOP_PER_S)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        rows["flash_prefill", name] = r = dict(
            ms=time_ms(lambda: fp.flash_prefill(q, k, v), 20),
            plain_ms=time_ms(lambda: fp.flash_prefill_plain(
                q, k, v, q_block=bl.q_block, k_block=bl.k_block), 1,
                repeats=3),
            library_ms=time_ms(sdpa, 20), bound_ms=t_bound, bound_by=by)
        g_k8 = graph_ms(lambda: fp.flash_prefill(q, k, v))
        g_lib = graph_ms(sdpa)
        print(f"[time] flash_prefill {name} B={B} S={S} {Hq}/{Hkv} x {dh} "
              f"bf16 on the tensor cores (q_block {bl.q_block}, k_block "
              f"{bl.k_block}): kernel {r['ms']:.4f} ms "
              f"({work[1] / r['ms'] / 1e9:.1f} TFLOP/s of the causal "
              f"products), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms (F.scaled_dot_product_attention, "
              f"is_causal, enable_gqa; vs K8 {e_lib:.3e}), kernel at "
              f"{r['ms'] / r['library_ms']:.2f}x the library's time; in a "
              f"CUDA graph (device time alone) kernel {g_k8:.4f} ms "
              f"({work[1] / g_k8 / 1e9:.1f} TFLOP/s), library {g_lib:.4f} "
              f"ms ({g_k8 / g_lib:.2f}x); bound {r['bound_ms']:.3e} ms "
              f"({r['bound_by']}; bf16 dense peak), kernel at "
              f"{r['ms'] / r['bound_ms']:.1f}x it")
        S_c = 517
        qd = randn(B, Hq, dh, gen=gen).to(bf16)
        _, kc, vc = attn_inputs(B, S_c, Hkv, Hkv, dh, bf16, gen)
        lens = torch.full((B,), 508, dtype=torch.int32, device=device)
        bl = da.choose_blocks(S_c, B, Hkv, Hq // Hkv, dh, bf16)
        kct, vct = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2) \
            .contiguous()
        mask = (torch.arange(S_c, device=device)[None, :]
                < lens[:, None])[:, None, None, :]
        lib = F.scaled_dot_product_attention(qd[:, :, None], kct, vct,
                                             attn_mask=mask,
                                             enable_gqa=True)[:, :, 0]
        e_lib = close(lib.float(), da.decode_attn(qd, kc, vc, lens).float(),
                      f"SDPA vs K9 at {name}", tol[bf16])
        t_bound, by = bound(*decode_work(B, Hq, Hkv, dh, lens, bf16),
                            flop_rate=BF16_FLOP_PER_S)
        def sdpa_decode():
            return F.scaled_dot_product_attention(
                qd[:, :, None], kct, vct, attn_mask=mask, enable_gqa=True)

        rows["decode_attn", name] = r = dict(
            ms=time_ms(lambda: da.decode_attn(qd, kc, vc, lens), 50),
            graph_ms=graph_ms(lambda: da.decode_attn(qd, kc, vc, lens)),
            plain_ms=time_ms(lambda: da.decode_attn_plain(
                qd, kc, vc, lens, block_s=bl.block_s, splits=bl.splits), 3,
                repeats=3),
            library_ms=time_ms(sdpa_decode, 50),
            library_graph_ms=graph_ms(sdpa_decode),
            bound_ms=t_bound, bound_by=by)
        print(f"[time] decode_attn {name} B={B} {Hq}/{Hkv} x {dh} over "
              f"{S_c} cache slots, length 508, bf16 (block_s {bl.block_s}, "
              f"{bl.splits} splits, {bl.grid} blocks): kernel "
              f"{r['ms']:.4f} ms back to back, {r['graph_ms']:.4f} ms in a "
              f"CUDA graph; plain {r['plain_ms']:.4f} ms; library "
              f"{r['library_ms']:.4f} ms, {r['library_graph_ms']:.4f} ms in "
              f"a graph (F.scaled_dot_product_attention with a length mask, "
              f"enable_gqa; vs K9 {e_lib:.3e}); bound {r['bound_ms']:.3e} ms "
              f"({r['bound_by']}), kernel at "
              f"{r['graph_ms'] / r['bound_ms']:.1f}x it in a graph")
    compiled = ""                      # the entry ptxas is reporting on
    for line in BUILD_LOGS.get("flash_prefill", "").splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            compiled = entry.group(1)
        elif "flash_prefill_tc_kernel" in compiled and (
                "registers" in line or "spill" in line):
            print(f"[time] flash_prefill tensor-core instance "
                  f"<padded dh, k_block> = {instance(compiled)}: "
                  f"{line.strip()}")
    # the main path's first model, Qwen2-0.5B, gives the line its times;
    # K8's error is its bf16 instance's, the one the line times
    entries = []
    for kname, replaces, src in (
            ("flash_prefill", "src/repro/kernels/flash_prefill.py:27",
             "flash_prefill.cu"),
            ("decode_attn", "src/repro/kernels/decode_attn.py:26",
             "decode_attn.cu")):
        r = rows[kname, "qwen2-0.5b"]
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": served_launches[kname],
            "max_abs_err": errs[kname][
                bf16 if kname == "flash_prefill" else f32], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if kname == "decode_attn":        # device time alone, both sides
            entries[-1].update(graph_ms=r["graph_ms"],
                               library_graph_ms=r["library_graph_ms"])
    return entries


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
    from repro_torch.kernels import decode_attn as da_k
    from repro_torch.kernels import flash_prefill as fp_k
    from repro_torch.kernels import lstm_cell as cell_k
    from repro_torch.kernels import lstm_seq as seq_k
    from repro_torch.kernels import lstm_seq_bwd as bwd_k
    from repro_torch.kernels import mamba_scan as mamba_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wkv6_k
    from repro_torch.launch import classify, train_har
    from repro_torch.obs import trace as trace_lib
    from repro_torch.data import har
    from repro_torch.optim.adamw import AdamW, tree_leaves, warmup_cosine

    counted = (cell_k.lstm_cell, seq_k.lstm_seq, seq_k.lstm_seq_traj,
               bwd_k.lstm_seq_bwd, seq_k.lstm_seq_q8, seq_k.lstm_seq_q8_traj,
               bwd_k.lstm_seq_bwd_q8, wkv6_k.wkv6, wkv6_k.wkv6_traj,
               wkv6_k.wkv6_bwd, mamba_k.mamba_scan, mamba_k.mamba_scan_traj,
               mamba_k.mamba_scan_bwd, fp_k.flash_prefill, da_k.decode_attn)

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
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    sm_clock_hz = float(clocks.stdout.strip().splitlines()[0]) * 1e6
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    # --- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(ptxas_info=True)
    BUILD_LOGS.update(logs)
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
    # the 2 x 32 cell's layers at B=1, 5 and 64, a ragged width, the 2 x 64
    # stack that fused_seq routes to fused_cell, and 3 x 256; two runs of
    # each agree bit for bit (the slices' partials meet in a fixed order)
    for B, D, H in [(1, 9, 32), (1, 32, 32), (64, 9, 32), (64, 32, 32),
                    (5, 9, 20), (5, 32, 32), (1, 9, 64), (1, 64, 64),
                    (64, 64, 64), (1, 9, 256), (1, 256, 256),
                    (64, 256, 256)]:
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
        again = cell_k.lstm_cell(w, b, x, c, h)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"lstm_cell B={B} D={D} H={H}: two runs differ")
        errs["lstm_cell"] = max(errs["lstm_cell"], err)
        print(f"[K1] lstm_cell B={B} D={D} H={H} "
              f"{tuple(cell_k.choose_blocks(B, D, H))} (block_b, block_h, "
              f"k_slices, threads, smem, grid): max abs err {err:.3e}; two "
              "runs bit-identical")

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
              dict(block_b=16, time_chunk=8)),
             # the wavefront's edges: one layer, three (shared weight
             # home), one step, fewer steps than layers, a 16-row tail
             ("L=1 1x32 T=64 B=2", (1, 32, 32, 2, 64), {}),
             ("L=3 3x32 T=64 B=2", (3, 32, 32, 2, 64), {}),
             ("T=1 2x32 B=3", (2, 32, 32, 3, 1), {}),
             ("T<L 3x32 T=2 B=2", (3, 32, 32, 2, 2), {}),
             ("batch tail B=37 tile 16 T=50", (2, 32, 32, 37, 50),
              dict(block_b=16))]
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

    # --- 3b'. the wavefront across time chunks, weight homes and tiles ------
    # f32 and q8, plain and trajectory launches: every time_chunk gives the
    # same bits, the trajectory launch's final (c, h) are the plain
    # launch's, and so are those of every other batch tile and weight home
    # (the canonical order of lstm_gates.cuh is layout-free)
    def wave_runs(w, b, x, q8, **kw):
        if q8:
            wq, s = ref.quantize_q8(w)
            return (seq_k.lstm_seq_q8(w, b, x, **kw),
                    seq_k.lstm_seq_q8_traj(wq, s, b, x, **kw))
        return seq_k.lstm_seq(w, b, x, **kw), seq_k.lstm_seq_traj(w, b, x,
                                                                   **kw)

    for label, (L_, P_, H_, B_, T_), q8s, block_b, chunks in [
            ("L=1", (1, 32, 32, 2, 64), (False, True), 1, (None, 1, 24)),
            ("L=3", (3, 32, 32, 2, 64), (False, True), 1, (None, 1, 24)),
            ("T=1", (2, 32, 32, 3, 1), (False, True), 1, (None, 1)),
            ("T<L", (3, 32, 32, 2, 2), (False, True), 1, (None, 1)),
            ("tail B=37 tile 16", (2, 32, 32, 37, 50), (False, True), 16,
             (None, 1, 8, 24)),
            ("q8 2x64", (2, 64, 64, 1, 128), (True,), 1, (None, 1, 48)),
            ("q8 3x64", (3, 64, 64, 1, 128), (True,), 1, (None, 1, 48)),
            ("q8 2x96", (2, 96, 96, 1, 128), (True,), 1, (None, 1, 24))]:
        w, b, x = seq_case(L_, P_, H_, B_, T_)
        for q8 in q8s:
            runs = [wave_runs(w, b, x, q8, block_b=block_b, time_chunk=tc)
                    for tc in chunks]
            (c0, h0), traj0 = runs[0]
            check(all(torch.equal(g, r) for plain, traj in runs[1:]
                      for g, r in zip((*plain, *traj), (c0, h0, *traj0))),
                  f"{label} q8={q8}: time_chunk {chunks} differ")
            check(torch.equal(traj0[0], c0) and torch.equal(traj0[1], h0),
                  f"{label} q8={q8}: trajectory launch's final (c, h) differ")
        home = seq_k.weight_home(L_, P_, H_, block_b)
        print(f"[K2] {label} ({home} weights, tile {block_b}): f32 and q8 "
              f"forward and trajectories bit-identical across time_chunk "
              f"{chunks}; K2t's final (c, h) equal the plain launch's"
              if len(q8s) == 2 else
              f"[K5] {label} ({home} weights, tile {block_b}): forward and "
              f"trajectories bit-identical across time_chunk {chunks}; "
              "K2t's final (c, h) equal the plain launch's")
    w, b, x = seq_case(2, 32, 32, 3, 50)
    for q8 in (False, True):
        base = wave_runs(w, b, x, q8, block_b=1)
        for block_b, tc in ((1, 8), (2, None), (4, 8), (16, None)):
            got = wave_runs(w, b, x, q8, block_b=block_b, time_chunk=tc)
            check(all(torch.equal(g, r) for g, r in zip(
                (*got[0], *got[1]), (*base[0], *base[1]))),
                  f"q8={q8} tile {block_b} tc {tc} differs from tile 1")
    print("[K2] 2x32 B=3 T=50, f32 and q8: tiles 1 (register weights) and "
          "2, 4, 16 (shared weights), whole and 8-step chunks, give the same"
          " bits, forward and trajectories")

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
            # below the smallest 2 x 32 forward tile: (1, 1) with the
            # weights in registers is 768 bytes (h slots and the x ring)
            routed = lstm.forward_fused_seq(params, x1, cfg, smem_budget=512)
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
    print(f"[K2] 512-byte budget: routed to fused_cell ({T * L} cell launches, "
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
    reg = {fn.__name__: fn.reg_launches
           for fn in (seq_k.lstm_seq, seq_k.lstm_seq_q8)}
    check(all(reg[n] == launches[n] for n in reg),
          f"a 2 x 32 serving launch left the register weight home: {reg} "
          f"of {launches}")
    print(f"[slice] serving path: every lstm_seq and lstm_seq_q8 launch ran "
          f"the wavefront kernel with its weights in registers ({reg})")
    print(f"[slice] HAR fused_seq p50 of one window: "
          f"{served['table']['fused_seq']['p50_ms']:.3f} ms, fused_seq_q8 "
          f"{served['table']['fused_seq_q8']['p50_ms']:.3f} ms, fused_cell "
          f"{served['table']['fused_cell']['p50_ms']:.3f} ms ({card})")
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
                check(seq_k.lstm_seq.reg_launches == want["lstm_seq"]
                      and seq_k.lstm_seq_q8.reg_launches
                      == want["lstm_seq_q8"],
                      f"{fwd.__name__} B={B}: not on the register home")
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
            traj_fn, plain_fn = (
                (seq_k.lstm_seq_q8_traj, seq_k.lstm_seq_q8)
                if plan == "fused_seq_q8" else
                (seq_k.lstm_seq_traj, seq_k.lstm_seq))
            train_reg = (traj_fn.reg_launches, plain_fn.reg_launches)
        finally:
            trace_lib.set_tracer(old)
        print(f"[train] {plan} training path launches: "
              f"{train_launches[plan]}")
        # the 20 steps' trajectory launches (B=64, one row a block) keep
        # their weights in registers; the two accuracy forwards over the
        # 256 test windows run 2-row tiles, on the shared weight home
        check(train_reg[0] == train_launches[plan][traj_fn.__name__] == 20,
              f"{plan}: {train_reg[0]} of 20 trajectory launches on the "
              "register weight home")
        print(f"[train] {plan}: all 20 trajectory launches ran the wavefront "
              f"kernel with weights in registers; the 2 accuracy forwards "
              f"(B=256) {train_reg[1]} in registers, "
              f"{train_launches[plan][plain_fn.__name__] - train_reg[1]} on "
              "shared-memory weights")
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
        check(got == only(lstm_seq_traj=1, lstm_seq_bwd=1)
              and seq_k.lstm_seq_traj.reg_launches == 1,
              f"fused_seq training step at T={T_}: {got}")
        got = counted_step(lstm.forward_fused_seq_q8, T_)
        check(got == only(lstm_seq_q8_traj=1, lstm_seq_bwd_q8=1)
              and seq_k.lstm_seq_q8_traj.reg_launches == 1,
              f"fused_seq_q8 training step at T={T_}: {got}")
    got = counted_step(lstm.forward_fused_kernel, T)
    check(got == only(lstm_cell=T * L), f"fused_cell training step: {got}")
    print(f"[train] one step: fused_seq 2 launches (lstm_seq_traj 1, "
          f"lstm_seq_bwd 1) and fused_seq_q8 2 (lstm_seq_q8_traj 1, "
          f"lstm_seq_bwd_q8 1) at T=128 and T=300, the trajectory launch on "
          f"register weights; fused_cell {T * L} cell launches and no "
          "backward kernel")

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

    def library_graph_ms(fn) -> float | None:
        """``fn``'s device time in a CUDA graph, or None (printed) when the
        library call cannot be captured."""
        try:
            return graph_ms(fn)
        except Exception as e:                      # noqa: BLE001
            torch.cuda.synchronize()
            print(f"[time] nn.LSTM cannot be captured in a CUDA graph: "
                  f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
            return None

    def chain_bound_ms(T_: int, L_: int, P_: int, H_: int) -> float:
        """Least time of the wavefront's dependent chain by arithmetic: T +
        L - 1 wave-steps, each at least its dependent f32 operations at 4
        cycles apiece (the arithmetic latency the CUDA C++ Programming
        Guide gives for compute capability 7.x and later) at the card's
        highest SM clock: one accumulator's chain of multiply-adds
        (ceil(max(P, H) / 4) of them: 4 accumulators a segment), the
        combine's two levels, in + rec, the bias (or scale fold), and the
        cell update's fmaf and multiply.  The shared-memory loads, the
        shuffles, expf, tanhf and the barrier are left out (no published
        latency), so the real step is longer."""
        ops = -(-max(P_, H_) // 4) + 2 + 1 + 1 + 2
        return (T_ + L_ - 1) * ops * 4 / sm_clock_hz * 1e3

    def bwd_chain_bound_ms(T_: int, L_: int, P_: int, H_: int) -> float:
        """The same bound for the backward's wavefront (K3's register
        home): T + L - 1 wave-steps, each at least the chain's dependent
        f32 operations at 4 cycles: dh (the carry plus the layer above's
        dinp), dc's two, the gate gradient's multiply, one accumulator's
        multiply-adds of a product (4H / 8 of them: a half-row of 4H
        columns a lane in 4 accumulators), the combine's two levels and
        the halves' add.  Loads, the shuffle and the barriers are left
        out."""
        ops = 1 + 2 + 1 + -(-4 * H_ // 8) + 2 + 1
        return (T_ + L_ - 1) * ops * 4 / sm_clock_hz * 1e3

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
        fwd_launch = lambda: seq_k._launch(wq, b_s, xp, fwd.block_b,  # noqa
                                           fwd.time_chunk, False, s)
        rows = [dict(
            name="lstm_seq_q8", B=B, extra=extra, shape=shape,
            home=seq_k.weight_home(L_, P_, H_, fwd.block_b),
            ms=time_ms(fwd_launch, 100), graph_ms=graph_ms(fwd_launch),
            entry_ms=time_ms(lambda: seq_k.lstm_seq_q8(w_s, b_s, xp), 100),
            plain_ms=time_ms(lambda: seq_k.lstm_seq_q8_plain(wq, s, b_s, xp),
                             2),
            library_ms=time_ms(lambda: lib(xp), 50),
            library_graph_ms=library_graph_ms(lambda: lib(xp)),
            chain_ms=chain_bound_ms(T_, L_, P_, H_),
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
            traj_lib_graph_ms = library_graph_ms(lambda: lib(xg))
            bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                (h_lib, c_lib), lib_in, (dh, dc), retain_graph=True), 50)
        state = 2 * T_ * L_ * B * H_                # both trajectories
        t_bound, by = bound(q8_in + 4 * (2 * L_ * B * H_ + state), flops)
        shape += f" tiles {tuple(tiles)}"
        traj_launch = lambda: seq_k._launch(wq, b_s, xp, tiles.block_b,  # noqa
                                            tiles.time_chunk, True, s)
        rows.append(dict(
            name="lstm_seq_q8_traj", B=B, extra=extra, shape=shape,
            home=seq_k.weight_home(L_, P_, H_, tiles.block_b),
            ms=time_ms(traj_launch, 100), graph_ms=graph_ms(traj_launch),
            entry_ms=time_ms(lambda: seq_k.lstm_seq_q8_traj(
                wq, s, b_s, xp, **kw), 100),
            plain_ms=time_ms(lambda: seq_k.lstm_seq_q8_traj_plain(
                wq, s, b_s, xp), 2),
            library_ms=traj_lib_ms, library_graph_ms=traj_lib_graph_ms,
            chain_ms=chain_bound_ms(T_, L_, P_, H_),
            bound_ms=t_bound, bound_by=by))
        # codes, scales, b, x, both trajectories, dc, dh in; f32 dw, db and
        # dx out
        t_bound, by = bound(q8_in + 4 * (state + 2 * L_ * B * H_ + wq.numel()
                                         + b_s.numel() + xp.numel()),
                            3 * flops)
        bwd_call = lambda: bwd_k.lstm_seq_bwd_q8(  # noqa: E731
            wq, s, b_s, xp, ct, ht, dc, dh, **kw)
        rows.append(dict(
            name="lstm_seq_bwd_q8", B=B, extra=extra, shape=shape,
            home=seq_k.weight_home(L_, P_, H_, tiles.block_b),
            ms=time_ms(bwd_call, 100), graph_ms=graph_ms(bwd_call),
            plain_ms=time_ms(lambda: bwd_k.lstm_seq_bwd_plain(
                wq, b_s, xp, ct, ht, dc, dh, scales=s), 2),
            library_ms=bwd_lib_ms, chain_ms=bwd_chain_bound_ms(
                T_, L_, P_, H_), bound_ms=t_bound, bound_by=by))
        return rows

    # --- 5. times ----------------------------------------------------------
    # no_grad, not inference_mode: nn.LSTM's backward is timed in here too
    rows = []

    def cell_row(B: int, lw: dict, extra: bool = False) -> dict:
        """K1 at layer ``lw``'s width beside nn.LSTMCell with its weights:
        back to back and in a CUDA graph, the plain version and the
        bound."""
        H = lw["b"].numel() // 4
        D = lw["w"].shape[0] - H
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
        return dict(
            name="lstm_cell", B=B, shape=f"B={B} D={D} H={H}", extra=extra,
            ms=time_ms(lambda: cell_k.lstm_cell(lw["w"], lw["b"], x, c, h),
                       200),
            # the kernel's device time alone: the host's wrapper and
            # launch are left out
            cell_graph_ms=graph_ms(lambda: cell_k.lstm_cell(
                lw["w"], lw["b"], x, c, h)),
            plain_ms=time_ms(lambda: cell_k.lstm_cell_plain(
                lw["w"], lw["b"], x, c, h), 200),
            library_ms=time_ms(lambda: lib(x, (h, c)), 200),
            library_graph_ms=graph_ms(lambda: lib(x, (h, c))),
            bound_ms=t_bound, bound_by=by)

    with torch.no_grad():
        # the 2 x 64 stack's second layer: fused_seq serves it on fused_cell
        rows.append(cell_row(1, p64["layers"][1], extra=True))
        for B in (1, 64):
            H = cfg.hidden
            rows.append(cell_row(B, params["layers"][1]))
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
            fwd = seq_k.choose_batch_block(B, T, L, P, H)
            fwd_launch = lambda: seq_k._launch(  # noqa: E731
                w_s, b_s, xp, fwd.block_b, fwd.time_chunk, False)
            rows.append(dict(
                name="lstm_seq", B=B, shape=f"B={B} T={T} L={L} P={P} H={H}",
                home=seq_k.weight_home(L, P, H, fwd.block_b),
                ms=time_ms(fwd_launch, 100), graph_ms=graph_ms(fwd_launch),
                entry_ms=time_ms(lambda: seq_k.lstm_seq(w_s, b_s, xp), 100),
                plain_ms=time_ms(lambda: seq_k.lstm_seq_plain(w_s, b_s, xp),
                                 2),
                library_ms=time_ms(lambda: lib(xp), 50),
                library_graph_ms=library_graph_ms(lambda: lib(xp)),
                chain_ms=chain_bound_ms(T, L, P, H),
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
                traj_lib_graph_ms = library_graph_ms(lambda: lib(xg))
                bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                    (h_lib, c_lib), lib_in, (dh, dc), retain_graph=True), 50)
            state = 2 * T * L * B * H                       # both trajectories
            t_bound, by = bound(4 * (xp.numel() + w_s.numel() + b_s.numel()
                                     + 2 * L * B * H + state), flops)
            traj_launch = lambda: seq_k._launch(  # noqa: E731
                w_s, b_s, xp, tiles.block_b, tiles.time_chunk, True)
            rows.append(dict(
                name="lstm_seq_traj", B=B, tiles=tuple(tiles),
                shape=f"B={B} T={T} L={L} P={P} H={H} tiles {tuple(tiles)}",
                home=seq_k.weight_home(L, P, H, tiles.block_b),
                ms=time_ms(traj_launch, 100),
                graph_ms=graph_ms(traj_launch),
                entry_ms=time_ms(lambda: seq_k.lstm_seq_traj(
                    w_s, b_s, xp, **kw), 100),
                plain_ms=time_ms(lambda: ref.lstm_seq_traj(w_s, b_s, xp), 2),
                library_ms=traj_lib_ms, library_graph_ms=traj_lib_graph_ms,
                chain_ms=chain_bound_ms(T, L, P, H),
                bound_ms=t_bound, bound_by=by))
            # x, w, b, both trajectories, dc, dh in; dx, dw, db out
            t_bound, by = bound(4 * (2 * xp.numel() + 2 * w_s.numel()
                                     + 2 * b_s.numel() + state
                                     + 2 * L * B * H), 3 * flops)
            bwd_call = lambda: bwd_k.lstm_seq_bwd(  # noqa: E731
                w_s, b_s, xp, ct, ht, dc, dh, **kw)
            rows.append(dict(
                name="lstm_seq_bwd", B=B, tiles=tuple(tiles),
                shape=f"B={B} T={T} L={L} P={P} H={H} tiles {tuple(tiles)}",
                home=seq_k.weight_home(L, P, H, tiles.block_b),
                ms=time_ms(bwd_call, 100), graph_ms=graph_ms(bwd_call),
                plain_ms=time_ms(lambda: bwd_k.lstm_seq_bwd_plain(
                    w_s, b_s, xp, ct, ht, dc, dh), 2),
                library_ms=bwd_lib_ms, chain_ms=bwd_chain_bound_ms(
                    T, L, P, H), bound_ms=t_bound, bound_by=by))

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
            bwd_call = lambda: bwd_k.lstm_seq_bwd(  # noqa: E731
                w_s, b_s, xb, ct, ht, dc, dh, **kw)
            rows.append(dict(
                name="lstm_seq_bwd", B=B, tiles=tuple(tiles),
                shape=f"B={B} T={T} L={L} P={P} H={H} tiles {tuple(tiles)}",
                home=seq_k.weight_home(L, P, H, tiles.block_b),
                ms=time_ms(bwd_call, 20), graph_ms=graph_ms(bwd_call, 5),
                plain_ms=time_ms(lambda: bwd_k.lstm_seq_bwd_plain(
                    w_s, b_s, xb, ct, ht, dc, dh), 1, repeats=3),
                library_ms=bwd_lib_ms, chain_ms=bwd_chain_bound_ms(
                    T, L, P, H), bound_ms=t_bound, bound_by=by))
    def ms_or_none(v):
        return "not capturable" if v is None else f"{v:.4f} ms"

    for r in rows:
        if r["name"].startswith("lstm_seq_bwd"):
            print(f"[time] {r['name']} {r['shape']} ({r['home']} weights): "
                  f"kernel {r['ms']:.4f} ms back to back, "
                  f"{r['graph_ms']:.4f} ms in a CUDA graph; nn.LSTM's "
                  f"backward {r['library_ms']:.4f} ms back to back; plain "
                  f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.3e} ms "
                  f"({r['bound_by']}); chain bound {r['chain_ms']:.3e} ms "
                  f"(the backward's wavefront, T + L - 1 wave-steps at "
                  f"{sm_clock_hz / 1e6:.0f} MHz)")
            continue
        if "graph_ms" not in r:
            graph = (f", {r['cell_graph_ms']:.4f} ms in a CUDA graph"
                     if "cell_graph_ms" in r else "")
            lib_graph = (f" ({r['library_graph_ms']:.4f} ms in a graph)"
                         if "library_graph_ms" in r else "")
            print(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.4f} "
                  f"ms back to back{graph}, plain {r['plain_ms']:.4f} ms, "
                  f"library "
                  f"{r['library_ms']:.4f} ms{lib_graph}, bound "
                  f"{r['bound_ms']:.3e} ms ({r['bound_by']})")
            continue
        print(f"[time] {r['name']} {r['shape']} ({r['home']} weights): "
              f"kernel {r['ms']:.4f} ms back to back (raw launch), "
              f"{r['graph_ms']:.4f} ms in a CUDA graph; public call "
              f"{r['entry_ms']:.4f} ms back to back; nn.LSTM "
              f"{r['library_ms']:.4f} ms back to back, "
              f"{ms_or_none(r['library_graph_ms'])} in a CUDA graph; plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.3e} ms "
              f"({r['bound_by']}); chain bound {r['chain_ms']:.3e} ms "
              f"(T + L - 1 wave-steps at {sm_clock_hz / 1e6:.0f} MHz)")
    for B in (1, 64):
        libs = {r["name"]: r for r in rows
                if r["B"] == B and "library_graph_ms" in r
                and r["name"] != "lstm_cell" and not r.get("extra")}
        print(f"[time] the nn.LSTM yardstick at B={B}, two phases of one "
              f"function: f32 forward {libs['lstm_seq']['library_ms']:.4f} "
              f"ms (graph {ms_or_none(libs['lstm_seq']['library_graph_ms'])})"
              f", over dequantized q8 weights "
              f"{libs['lstm_seq_q8']['library_ms']:.4f} ms (graph "
              f"{ms_or_none(libs['lstm_seq_q8']['library_graph_ms'])}); "
              f"training forward {libs['lstm_seq_traj']['library_ms']:.4f} "
              f"and {libs['lstm_seq_q8_traj']['library_ms']:.4f} ms")
    for name, legend in (("lstm_seq", "<rows,traj,weights,register home>"),
                         ("lstm_seq_bwd", "<rows,max threads,weights> "
                          "(shared home) or wave<weights> (register home)")):
        compiled = ""                  # the entry ptxas is reporting on
        for line in BUILD_LOGS.get(name, "").splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                compiled = entry.group(1)
            elif "registers" in line or "spill" in line:
                tag = "wave" if "wave_kernel" in compiled else ""
                print(f"[time] {name} {legend} = {tag}{instance(compiled)}:"
                      f" {line.strip()}")
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
        if r["name"] == "lstm_cell":      # device time alone, both sides
            kernels[-1].update(graph_ms=r["cell_graph_ms"],
                               library_graph_ms=r["library_graph_ms"])
        if r["name"].startswith("lstm_seq_bwd"):
            kernels[-1].update(graph_ms=r["graph_ms"],
                               chain_bound_ms=r["chain_ms"])
    kernels.append(rwkv_slice(device, gen, counted, counts, only))
    kernels += rwkv_train_slice(device, gen, counted, counts, only)
    kernels += mamba_slice(device, gen, counted, counts, only)
    kernels += attention_slice(device, gen, counted, counts, only)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
