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
launches at any T.  Phase 3e does the same in bf16: K1, K2/K2t, K3 and the
int8 stack over bf16 x against their plain versions (one bf16 step of the
largest entry; f32 trajectories at the f32 tolerance) and bit-equal to
their f32 instances on the widened operands, across time chunks, tiles,
weight homes and runs; ``classify.serve`` of a bf16 ``LSTMConfig`` through
all five plans (one bf16 K2 launch a request, T x L bf16 K1 for
``fused_cell``, 2 x 64 in one K2 launch where f32 takes ``fused_cell``),
20 bf16 ``train_har`` steps each through ``fused_seq`` and
``fused_seq_q8`` (two launches a step, the first 3 losses against bf16
``sequential``), 2 x 64 bf16 training routed to ``fused_cell``, and the
bf16 instances' times beside their f32 instances'.  Then the RWKV6 slice:
the K6 chunked scan against its
plain version (the JAX family's cases, the full-width heads at T=512 and
500, extreme decay, rows alone and in a batch, a split-resume run), the
full-width model cut to 4 layers in f32 (the kernel plan against
``chunked_xla``, prefill plus decode against ``forward``), and the full
bf16 RWKV6-3B at full width (8 of its 32 layers: ``SERVE_LAYERS``)
served through ``repro_torch.launch.serve``'s wave
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
``repro_torch.launch.train`` (40 steps of batch 4 x 512, warmup 4, the
plain scans armed to raise, every K6b launch of step 1 held against its
plain version, the loss curve, the last step under torch.profiler for
where the device's time goes).  Then the Mamba slice: the selective scan K7, its trajectory
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
Beside each family's wave serve (phases R3, M4 and A4), on the parameters
that phase drew, the slot engine (``serving.SlotEngine``, continuous
batching, 4 slots of 517 positions, its decode tick captured in a CUDA
graph) serves the same 8 requests: S1 Qwen2-0.5B, S2 RWKV6-3B and the
Jamba stack, each with a replayed tick bit-equal to the eager tick on a
clone of the same state, the graph-ticked tokens equal to the eager-ticked
ones, no allocation across replayed ticks, every eager K8/K9 (K7) launch
held against its plain version, chunked admission and the wave engine at
batch 1 compared token by token up to the reference's first low top-2
margin; S3 Qwen2's engine under a seeded FaultPlan; S4 the decode ms a
tick eager against replayed beside the wave engine's, TTFT and TBT.
Then the MoE phases (``moe_slice``), each model freed before the next and
each phase's peak memory printed: X1 OLMoE-1B-7B at full width, 2 of 16
layers, in f32 (prefill plus 4 decode steps against
``forward(inference=True)`` with one K8 and one K9 an attention layer,
chunked against whole-prompt admission, ``moe.apply_moe`` on the card
against the CPU with the same routing, drop-free and at capacity); X2
OLMoE-1B-7B in bf16 at full width, 8 of its 16 layers, and X3
the Jamba hybrid cut to one period at 8 experts (25.9 B: attention, Mamba
and MoE in one model, one cache and one captured tick), each served
through ``launch/serve``'s wave engine and the slot engine as S1 to S4
serve (every K7, K8 and K9 launch held against its plain version), with
the MoE layers' share of the decode tick beside the weights' read, and
for X3 the first-token logits of prefill plus decode against the forward
beside the plan spread; X4 Qwen3-30B-A3B in bf16 at full width, 24 of its
48 layers, through the wave engine, one wave of 4 (``SERVE_LAYERS``).
Attention training (``attention_train_slice``, at the end of the attention
slice, and X5 in ``moe_slice``): A6 the training forward K8t (K8 that also
writes each row's log-sum-exp) bit-equal to K8 and its lse against the
plain version, and the hand-written backward K8b (bf16 on the tensor
cores, f32 on the SIMT kernels; the GQA group split over blocks and summed
in head order) against its plain version (in bf16 rounding p and ds as
the kernel does) and torch autograd of the plain K8 (Qwen2's, OLMoE's and
Yi's heads, StableLM's width, a ragged S, a window of 64; f32 and bf16;
two runs bit-identical; every bf16 call on the tensor cores); A7
Qwen2-0.5B at full width, 2 of 24 layers, in f32 (``grad_gate``): two
steps' ``loss_fn`` gradients and the AdamW update between them on the card
against the CPU, remat on and off; A8 Qwen2-0.5B trained at
full width and depth in bf16 through ``launch/train.train`` (40 steps of
batch 4 x 512, 48 K8t and 24 K8b calls a step, every K8b on the tensor
cores, no K8, the plain attention armed to raise, step 1's K8b calls held
against plain, the loss curve, the last two steps under torch.profiler);
A9 K8t's and K8b's times beside their bounds, plain versions and SDPA
forward + backward (and its backward alone), K8b's kernels by the
profiler; X5 OLMoE-1B-7B at full width, 4 of its 16 layers, trained the
same way for 8 steps, with its router metrics.
The vision and audio fronts (``fronts_slice``), each model freed before
the next: V1 InternVL2-1B and U1 MusicGen-large at full width, 2 layers,
in f32 (drawn patch embeddings ahead of the text; 4 codebooks a step):
K8/K9 against the blocked/einsum plans, prefill + 4 decode steps against
``forward(inference=True)``, every launch held against its plain version;
V2 and U2 the two at full width and half depth (``SERVE_LAYERS``) in bf16
through the wave engine and the slot engine as S1 to S4 serve them (every
K8/K9 launch held, every
bf16 K8 on the tensor cores, a replayed tick bit-equal to the eager one;
InternVL2-1B's chunked engine refused, MusicGen-large's (4, 16) tokens
through whole and chunked admission and under the seeded FaultPlan); V3
and U3 the two trained at full width and depth for 8 steps of batch 4 x
512 positions drawn by ``registry.make_batch``, as A8 (step 1's K8b calls
held, peak memory, the loss).  A1, A2, A5, A6 and A9 also hold and time
K8, K9, K8t and K8b at MusicGen-large's heads (32/32 x 64).
The dense archs with LayerNorm: A3 also holds StableLM-2-12B (32/8 heads
of 160) and Command-R-35B (64/8 of 128, a tied 256,000-entry head, rope
theta 8e6) at full width, 2 layers, in f32 as V1 holds InternVL2-1B; A4
serves both at full width and 10 of their 40 layers in bf16
(``SERVE_LAYERS``) through the wave engine and the slot engine (every K8 on
the tensor cores and every K8/K9 launch held against its plain version
as it comes, a replayed tick bit-equal to the eager one, each model's
peak memory); A1, A2 and A5 hold and time K8 and K9 at their heads.
T1 (``ln_train_slice``) trains both: at 2 layers in f32 (``grad_gate``,
as A7), two steps' gradients and the AdamW update between them on the
card against the CPU at 1e-4; in bf16 at full width and ``TRAIN_LAYERS``
depth (12 and 2 of 40 layers), 8 steps as A8 (step 1's K8b calls held against plain: at StableLM's heads
the GQA reduction at dh 160; the loss curve, peak memory); A9 times K8t
and K8b at both training heads.
The JAX package's other cache layouts (``layouts_slice``): L1 the
long-context ring ``config_for_shape(qwen2-0.5b, long_500k)`` gives (a
window of 8,192 slots), at full width and depth: in f32 a 9,000-token
prefill (windowed K8) and 16 decode steps on the ring against the
windowed ``forward(inference=True)``, in bf16 the slot engine over 4
lanes of the ring (prompts of 8,300 to 9,000 tokens); Q1 the int8 cache
on Yi-9B (``SERVE_LAYERS`` depth) against the bf16 full cache as the
JAX package's tests/test_kv_quant.py holds it, then the slot engine over
it.
The analysis and profiler half: P1 holds every served and trained
model's parameters to ``analysis.param_counts`` (within the norms'
bookkeeping of the JAX package's count), prints each training step's
model-FLOPs share from ``analysis.model_flops`` (active, non-embedding
parameters) and each replayed tick beside its ``analysis.analytic_costs``
roofline; P2 sweeps ``obs/profile.profile_families`` (K2/K4, K6, K7 at
the kernel table's shapes, each point held against its plain version and
timed beside its ``model_s``), saves the profile under ``build/`` and
reloads it; P3 calibrates the Fig 7 scheduler's five LSTM plans from it
(``fused_seq`` seeded without a launch) and serves 32 windows through the
chosen plan; P4 trains Qwen2-0.5B 4 steps through ``launch/train.py
--ckpt-dir --ckpt-every 2`` and restores the checkpoint onto the card and
the CPU bit for bit (``profiler_slice``).
The paper's cost model (``factorization_slice``): F1 times MobiRNN's Figs
2 and 3 on the card, one HAR window (2 x 32, T=128 x 9, B=1, f32) through
``forward_sequential`` over the per-column cell (Fig 2b), the 10-column
cell and the packed plain cell (Fig 2c), ``fused_cell`` and
``fused_seq``, each held to ``sequential`` at LSTM_TOL, K1 launched
exactly 256 times and K2 once, the host-clock medians in the paper's
order (per-column > 10-column > packed > ``fused_cell`` >
``fused_seq``), each beside ``core/factorization.H100``'s modelled time
(printed, not held), the host cost a launch beside the profile's, and the
Fig 3 to 6 model rows under the paper's profiles.  The one-device mesh
(``mesh_slice``): D1 trains Qwen2-0.5B at full width and depth through
``launch/train.train`` (bf16, 2 steps of 4 x 512) inside ``use_rules`` on
the 1 x 1 host mesh and outside it (losses and ``grad_norm``s bit-equal,
launches equal), serves it through the slot engine with its tick captured
inside the rules and outside (tokens and launches equal), and builds
every architecture's abstract parameter and cache trees at full width
with their specs on the host mesh and the abstract (16, 16) mesh, with
``torch.cuda.memory_allocated()`` unchanged.  The multi-device paths
(``multidevice_slice``): D2 starts 4 gloo ranks on the one card as a
(1, 4) mesh; each draws the full-width parameters from one seed and holds
RWKV6-3B's sequence-parallel time-mix (B 4 x S 512, 128 tokens a rank,
f32 and bf16; one K6 a rank, K6t and K6b under autograd, the plain scans
armed to raise) and OLMoE-1B-7B's expert-parallel MoE layer (16 experts
a rank, drop-free and at the training capacity) against the
single-device paths on the full inputs, forward and gradients, and each
rank's collectives to their count and bytes; the time-mix's f32
gradients also against a float64 autograd of the plain time-mix, seqpar
within twice the one-device path's error there.  It prints no time for
them.  The trainer on several ranks (``train_ranks_slice``): D3 trains
Qwen2-0.5B at full width and depth on 2 gloo ranks on the card as (data=2,
model=1), parameters and AdamW moments DTensors placed FSDP-style, f32 4
steps (each loss and grad_norm within 1e-4 of the one-device trainer's,
2L K8t + L K8b a step a rank with the plain attention armed, step 1's K8b
against plain, each rank's collectives a step equal to those its specs
predict) and bf16 2 steps (losses printed); then, on the same ranks as
(data=1, model=2), serves it in f32 (prefill 4 x 64, 4 decode steps): the
heads and the cache's sequence split, L K8 a prefill and L K9 a decode
step on each rank (K9's log-sum-exp combining the cache's slices), the
gathered logits within 3e-4 of one device.  The production-mesh dry run
(``dryrun_slice``): D4 runs ``python -m repro_torch.launch.dryrun`` over
every arch x input shape on pod1 and a case a family on pod2 (meta
DTensors over a fake group of 256 or 512 ranks), every case passing with
a non-zero collective term; its roofline terms are modelled.  It times
each kernel beside its plain version, one PyTorch library call
computing the same function where there is one, and the least time the
card could take for the work (``repro_torch.analysis``).

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
import gc
import json
import math
import os
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
#: nvcc's output per source of this run's build (ptxas registers and spills)
BUILD_LOGS: dict[str, str] = {}
#: JAX's Pallas dispatches of one value_and_grad of its loss_fn through
#: chunked_scan at 4 layers, with remat (the trajectory forward, its
#: recompute and the backward: 3 a layer) and without (2 a layer); pinned
#: on the CPU by tests/test_torch_lm_train.py.
JAX_TRAIN_DISPATCHES_4 = {True: 12, False: 8}
REPO = Path(__file__).resolve().parent
#: Layers of the serving phases run at cut depth (full width), so that the
#: whole script stays within the time it took before attention training's
#: phases (A6 to A9, X5) were added: RWKV6-3B's wave and slot serves (R3,
#: S2; 32 layers), Yi-9B's serve (A4; 48), OLMoE-1B-7B's serves (X2; 16)
#: and Qwen3-30B-A3B's (X4; 48); and, since T1 and R7's 40 steps were
#: added, the LayerNorm archs' serves (A4; 40 layers each), InternVL2-1B's
#: (V2; 24) and MusicGen-large's (U2; 48).  The training runs keep their
#: depth.
SERVE_LAYERS = {"rwkv6-3b": 8, "yi-9b": 24, "olmoe-1b-7b": 8,
                "qwen3-moe-30b-a3b": 24, "stablelm-12b": 10,
                "command-r-35b": 10, "internvl2-1b": 12,
                "musicgen-large": 24}
#: T1's depths: the LayerNorm archs trained in bf16 at full width, batch 4
#: x 512, AdamW, remat on, cut to fit the card.  Measured peaks
#: (torch.cuda.max_memory_allocated; H100 80GB HBM3, 700 W): StableLM-2-12B
#: at 12 layers 63.896 GB, Command-R-35B at 2 layers 61.687 GB (its tied
#: 256,000 x 8,192 embedding is 2.1 B of its 3.5 B parameters); a layer
#: more is 0.278 B and 0.705 B parameters, 12 bytes each with AdamW
TRAIN_LAYERS = {"stablelm-12b": 12, "command-r-35b": 2}
#: the dense archs with LayerNorm, StableLM-2-12B (32/8 heads of 160) and
#: Command-R-35B (64/8 of 128, a tied 256,000-entry head, rope theta 8e6):
#: A3 at 2 layers in f32, A4 at full width and ``SERVE_LAYERS`` depth in
#: bf16, A5's shapes, T1 trained
LN_ARCHS = ("stablelm-12b", "command-r-35b")
#: L1's long-context layout: the ring of ``registry.LONG_CONTEXT_WINDOW``
#: slots that ``config_for_shape`` gives a dense arch at ``long_500k``, a
#: prompt past it and 16 decode steps
RING_WINDOW, RING_PROMPT, RING_STEPS = 8192, 9000, 16
#: L1's slot serve: 6 prompts past the ring on 4 lanes, 16 new tokens each
RING_LENS = (8300, 9000, 8650, 8821, 8417, 8963)


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
        if hasattr(fn, "bf16_launches"):    # the LSTM kernels' bf16 instances
            fn.bf16_launches = 0


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


def instance(mangled: str) -> str:
    """The template arguments of a mangled kernel name, in order, e.g.
    ``<16,512,int8>`` for ``lstm_seq_bwd_kernel<16, 512, int8_t>``,
    ``<bf16,1>`` for ``mamba_scan_kernel<__nv_bfloat16, true>`` (a bool
    argument prints 0 or 1), ``<f32,160>`` for
    ``flash_prefill_kernel<float, 160>`` or ``<1,1,int8,1>`` for
    ``lstm_seq_fwd_kernel<1, true, int8_t, true>``."""
    args = re.search(r"I((?:L[ib]\d+E|f|a|13__nv_bfloat16|S\d*_)+)E",
                     mangled)
    if not args:
        return ""
    # a repeated argument is a substitution (S_, S0_, ...); in these
    # kernels only __nv_bfloat16 is ever repeated (float, int8 are builtins)
    names = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}
    return "<" + ",".join(
        tok[0] or names.get(tok[1], "bf16") for tok in re.findall(
            r"L[ib](\d+)E|(f|a|13__nv_bfloat16|S\d*_)", args.group(1))) + ">"


def kernel_name(mangled: str) -> str:
    """The unqualified name of a mangled kernel, e.g. ``dq_tc`` for
    ``_ZN12_GLOBAL__N_15dq_tcILi64EEEv...``: the last of its length-prefixed
    names before the template arguments."""
    i, name = 2 + (mangled[2:3] == "N"), ""
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name


def kernel_device_ms(fn, calls: int, names: tuple[str, ...]
                     ) -> dict[str, tuple[float, int]]:
    """Mean device time of one launch, and the launches recorded, of each
    kernel whose name holds one of ``names``, from torch.profiler over
    ``calls`` calls of ``fn`` (after a warmup).  The profiler has been
    seen to drop some of a session's device events, and to record none in
    the first session after the training steps': the mean is over the
    launches recorded, and up to three sessions are tried; empty if none
    recorded any."""
    fn()
    torch.cuda.synchronize()
    out: dict[str, tuple[float, int]] = {}
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            for n in names:
                if n in e.key and e.device_time_total > 0 and e.count:
                    out[n] = (e.device_time_total / 1e3 / e.count, e.count)
        if out:
            break
    return out


def randn(*shape, gen, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).cuda()


#: above 0 while ``disarmed`` holds: the armed plain versions then run
_DISARMED = [0]


@contextlib.contextmanager
def disarmed():
    """Inside, the plain versions that ``tripwires`` armed run as they
    would unarmed: a hold checks a launch against its plain version (and
    the functions that version calls) in the middle of a serve that has
    them armed."""
    _DISARMED[0] += 1
    try:
        yield
    finally:
        _DISARMED[0] -= 1


@contextlib.contextmanager
def tripwires(*where):
    """Arm each ``(module, name)`` plain version to raise when a CUDA
    tensor reaches it (outside ``disarmed``): inside, every CUDA call must
    launch its kernel."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in where]

    def armed(name, fn):
        def call(*args, **kwargs):
            if not _DISARMED[0] and any(isinstance(a, torch.Tensor)
                                        and a.is_cuda for a in args):
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


def rwkv_slice(device, gen, counted, counts, only) -> dict:
    """The RWKV6 slice: K6 against its plain version, the 4-layer f32 model
    across plans and against its own forward, the bf16 RWKV6-3B at full
    width and ``SERVE_LAYERS`` depth
    served through ``launch/serve.py`` (counted, plain scans armed), and
    K6's times.  Returns K6's entry of the ``kernels`` line."""
    from repro_torch.analysis import TF32_FLOP_PER_S, bound, wkv6_fwd_work
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
    # the plain versions a CUDA tensor must not reach on the main paths
    plain_wkv = ((wkv6_k, "wkv6_plain"), (ref, "wkv6"),
                 (ref, "wkv6_stepwise"), (rwkv, "wkv_chunked"))

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
    del scan, xla, cache
    admission_f32("R2", m4, p4, plain_wkv, counted, counts)
    del p4
    torch.cuda.empty_cache()

    # --- R3. RWKV6-3B served at full width, bf16 ---------------------------
    cfg = dataclasses.replace(get_arch("rwkv6-3b"),
                              n_layers=SERVE_LAYERS["rwkv6-3b"])
    t0 = time.perf_counter()
    engine = serve_lm.build_engine(cfg, device, seed=0, batch_size=4,
                                   max_seq=500 + 16 + 1, engine="wave")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(engine.params))
    accounting("R3", cfg, n_params)
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
        with tripwires(*plain_wkv):
            served = serve_lm.serve(engine, reqs)
    finally:
        wkv6_k.wkv6, steps_lib.decode_step = kernel, decode
    got = counts()
    check(got == only(wkv6=2 * cfg.n_layers)
          and seen["launches"] == [cfg.n_layers] * 2,
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
    # was given (the layers' real r, k, v, logw, u and carried state):
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
    # Printed, not held to a tolerance: in bf16 the random layers turn a
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
    # --- S2. the slot engine on the same parameters -----------------------
    def hold_wkv(args, kwargs, out):
        """out at the bf16 tier, the f32 state at the f32 tier, as R3."""
        want = wkv6_k.wkv6_plain(*args, chunk=kwargs["chunk"])
        return max(close(out[0].float(), want[0].float(), "slot wkv6 out",
                         tol["bfloat16"]),
                   close(out[1], want[1], "slot wkv6 state", tol["float32"]))

    slot_slice("S2", cfg, engine.params, counted, counts, only,
               {"wkv6": (wkv6_k, "wkv6", hold_wkv)}, plain_wkv,
               [w["decode_ms_per_token"] for w in served["waves"]])
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
    (wkv6, mamba_scan), the attention kernels (flash_prefill: K8t;
    flash_prefill_bwd: K8b), the matrix products, the kernels inside the
    optimizer's span (``spans``, empty when the host was not traced) and
    the rest, each group that ran — and by kernel name with its
    launches."""
    def group(e) -> str:
        name = e.name.lower()
        for family in ("wkv6", "mamba_scan", "flash_prefill_bwd",
                       "flash_prefill"):
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


def accounting(phase: str, cfg, n_built: int) -> None:
    """P1: ``analysis.param_counts`` of ``cfg`` beside the parameters of
    the model the phase built.  The count is the JAX package's arithmetic,
    which books 4 d_model a layer for norms where the models hold 2
    (RMSNorm) or 4 (LayerNorm) and a final norm: it must be within
    4 d_model x (layers + 1) of the built model's."""
    from repro_torch.analysis import param_counts

    total, active = param_counts(cfg)
    slack = 4 * cfg.d_model * (cfg.n_layers + 1)
    check(abs(n_built - total) <= slack,
          f"P1 {phase}: analysis.param_counts({cfg.name}) {total:,} is "
          f"{n_built - total:+,} from the built model's {n_built:,}")
    print(f"[P1] {phase} {cfg.name}: analysis.param_counts {total:,} "
          f"total, {active:,} active a token; the built model {n_built:,} "
          f"({n_built - total:+,}, the norms' bookkeeping, within "
          f"{slack:,})")


def flops_share(phase: str, cfg, report: dict, med_ms: float,
                batch: int = 4, seq: int = 512) -> str:
    """P1: a training step's model FLOPs (``analysis.model_flops``: 6 x
    the active, non-embedding parameters x tokens) at ``batch`` x ``seq``
    and their share of the bf16 dense peak at a step of ``med_ms``, beside
    the share 6 x every parameter x tokens gave before; the model's
    parameters held to ``analysis.param_counts`` (``accounting``)."""
    from repro_torch.analysis import BF16_FLOP_PER_S, model_flops
    from repro_torch.configs.base import ShapeConfig

    accounting(phase, cfg, report["n_params"])
    mf = model_flops(cfg, ShapeConfig("step", seq, batch, "train"))
    old = 6 * report["n_params"] * batch * seq
    per_s = med_ms / 1e3 * BF16_FLOP_PER_S
    return (f"model FLOPs (analysis.model_flops: 6 x active non-embedding "
            f"parameters x tokens, {mf:.3e} a step) at {mf / per_s:.2%} of "
            f"the H100's 989 TFLOP/s bf16 dense peak (6 x all parameters x "
            f"tokens, {old:.3e}, gave {old / per_s:.2%})")


def print_step_profile(profiles: list[dict], unprofiled_ms: float
                       ) -> float | None:
    """Where the last two training steps' device time goes, from
    torch.profiler's device events.  The first traced the device alone:
    its busy time against its own wall gives the device's idle share, and
    its wall against the unprofiled steps' median the tracing's host cost.
    The second also traced the host, so the optimizer's span groups its
    kernels; its wall carries the host tracing's cost and is not used.
    Returns the device-alone step's busy ms (None if not measured)."""
    span = "adamw.update_"
    busy_alone = None
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
            busy_alone = busy
            print(f"[profile] training step {prof['step']} ({what}): wall "
                  f"{wall:.3f} ms ({wall - unprofiled_ms:+.3f} ms against the"
                  f" unprofiled median), device busy {busy:.3f} ms, idle "
                  f"{1 - busy / wall:.1%} of this step's wall; {groups} "
                  f"(AdamW in other)")
    return busy_alone


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
    from repro_torch.analysis import (TF32_FLOP_PER_S, bound, wkv6_bwd_work,
                                      wkv6_fwd_work)
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
    # 40 steps, as A8 trains Qwen2-0.5B: warmup 4 (8 steps have none)
    n_steps, L = 40, cfg.n_layers
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
    print(f"[train] {cfg.name}: {report['n_params'] / 1e9:.3f} B parameters "
          f"in {cfg.dtype}, batch 4 x 512, {n_steps} steps in {wall:.1f} s "
          f"(init included); launches {got['wkv6_traj']} K6t + "
          f"{got['wkv6_bwd']} K6b ({2 * L} + {L} a step), none of K6, no "
          "plain scan reached; every loss and grad_norm finite; peak "
          f"device memory {peak:.2f} GB (torch.cuda.max_memory_allocated)")
    print("[train] loss curve: "
          + ", ".join(f"{x:.3f}" for x in report["losses"]))
    print("[train] grad norms: "
          + ", ".join(f"{x:.3g}" for x in report["grad_norms"]))
    print(f"[train] each of step 1's {seen['n']} K6b launches (r "
          f"{seen['shape'][0]} {seen['shape'][1]}, C={seen['shape'][2]}) "
          f"against wkv6_bwd_plain on its own inputs: max abs err "
          f"{seen['err']:.3e} (dr, dk, dv at RWKV_TOL bf16 x max|grad| and "
          "one bf16 step at max|grad|, dlogw, du, ds0 at RWKV_GRAD_TOL f32)")
    print(f"[time] training step, {cfg.name}, batch 4 x 512, steps 2 to "
          f"{n_steps - 2}: median {med:.3f} ms, min {min(step_ms):.3f} ms "
          f"(host clock around the step, ending in the loss's copy to the "
          f"host); "
          f"{tokens / (med / 1e3):.1f} tokens/s; "
          + flops_share("R7", cfg, report, med))
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


def mamba_slice(device, gen, counted, counts, only) -> list[dict]:
    """The Mamba slice: K7 and K7t against their plain versions (M1); K7b
    against its plain version and torch autograd (M2); the attention-free
    Jamba stack at full width cut to 2 layers in f32, across plans and
    against its own forward, with its gradients (M3); the same stack in
    bf16 (3.12 B parameters) served through ``launch/serve.py`` and
    trained through ``launch/train.train``, counted, the plain scans armed
    to raise (M4); the three kernels' times (M5).  Returns their entries
    of the ``kernels`` line."""
    from repro_torch.analysis import bound, mamba_bwd_work, mamba_fwd_work
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
    plain_scans = plain_scan_arms()
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
    admission_f32("M3", m32, p32, plain_scans, counted, counts)
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
                                   max_seq=500 + 16 + 1, engine="wave")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(engine.params))
    accounting("M4", cfg, n_params)
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

    # --- S2. the slot engine on the same parameters -----------------------
    slot_slice("S2", cfg, engine.params, counted, counts, only,
               {"mamba_scan": kernel_holds()["mamba_scan"]}, plain_scans,
               [w["decode_ms_per_token"] for w in served["waves"]])
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
          + flops_share("M4", cfg, report, med))
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


def attention_slice(device, gen, counted, counts, only) -> list[dict]:
    """The dense attention slice: K8 against its plain version (A1); K9
    against its plain version (A2); Qwen2-0.5B at full width and depth in
    f32, across plans and prefill + decode against its own forward (A3);
    Qwen2-0.5B and Yi-9B (``SERVE_LAYERS`` depth) in bf16 served through
    ``launch/serve.py``,
    counted, the plain attention functions armed to raise, every launch
    then held against its plain version on its own inputs, and served
    again uncaptured for the times (A4); the two
    kernels' times beside SDPA's (A5); then attention training
    (``attention_train_slice``: A6 to A9).  Returns their entries of the
    ``kernels`` line."""
    from repro_torch.analysis import (BF16_FLOP_PER_S, bound, decode_work,
                                      prefill_work)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.launch import serve as serve_lm
    from repro_torch.models import attention, registry
    from repro_torch.optim.adamw import tree_leaves

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
    plain_attention = plain_attention_arms()
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
        # Qwen2-0.5B's served prefills, Yi-9B's, 8/8 x 160, a window of 64,
        # MusicGen-large's full multi-head 32/32 x 64 (g = 1 at dh 64),
        # InternVL2-1B's vision prefix ahead of 300 text tokens, the
        # LayerNorm archs' served prefills (StableLM-2-12B 32/8 x 160,
        # Command-R-35B 64/8 x 128) and L1's long prompt in the 8,192 ring
        (4, 500, 14, 2, 64, None, None, 0), (4, 468, 14, 2, 64, None, None, 0),
        (4, 500, 32, 4, 128, None, None, 0), (2, 500, 8, 8, 160, None, None, 0),
        (4, 500, 14, 2, 64, None, None, 64),
        (4, 500, 32, 32, 64, None, None, 0),
        (1, 556, 14, 2, 64, None, None, 0),
        (4, 500, 32, 8, 160, None, None, 0),
        (4, 500, 64, 8, 128, None, None, 0),
        (1, RING_PROMPT, 14, 2, 64, None, None, RING_WINDOW)]
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
    # under autograd the call runs K8t (attention training, A6 to A9):
    # the same output bits as K8, one K8t launch and no K8 one
    for dtype in (f32, bf16):
        q, k, v = attn_inputs(4, 500, 14, 2, 64, dtype, gen)
        want = fp.flash_prefill(q, k, v)
        before = (fp.flash_prefill.launches,
                  fp.flash_prefill_traj.launches)
        got = fp.flash_prefill(q.requires_grad_(), k, v)
        check(got.requires_grad and torch.equal(got.detach(), want)
              and (fp.flash_prefill.launches,
                   fp.flash_prefill_traj.launches)
              == (before[0], before[1] + 1),
              f"flash_prefill under autograd ({dtype}) did not run K8t "
              "alone, or its output differs from K8's")
        del got
    print(f"[K8] max abs err vs plain: f32 "
          f"{errs['flash_prefill'][f32]:.3e}, bf16 "
          f"{errs['flash_prefill'][bf16]:.3e} (vs round_p plain "
          f"{err_rp:.3e}, within rtol {tc_tol['rtol']:.4g} atol "
          f"{tc_tol['atol']:.4g}); f32 results within 2e-4 at q/k "
          "tiles (16, 64), (32, 32), (48, 16), (64, 2); bf16 within 3e-2 at "
          f"k_block {fp.TC_K_BLOCKS} at dh 64, 128, 160; under autograd "
          "one K8t launch, its output bit-equal to K8's (f32 and bf16)")

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
        (2, 32, 8, 517, 160, None, [300, 508]),
        # MusicGen-large's 32/32 x 64; InternVL2-1B's cache behind its
        # prefix; the LayerNorm archs' served caches, StableLM-2-12B's 32/8
        # x 160 and Command-R-35B's 64/8 x 128 (g = 8)
        (4, 32, 32, 517, 64, None, [0, 1, 300, 517]),
        (4, 14, 2, 773, 64, None, [557, 600, 700, 773]),
        (4, 32, 8, 517, 160, None, [0, 1, 65, 517]),
        (4, 64, 8, 517, 128, None, [0, 1, 300, 508])]
    e_lse = {f32: 0.0, bf16: 0.0}
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
            want, want_lse = da.decode_attn_plain(
                q, kc, vc, lens, block_s=bl.block_s, splits=bl.splits,
                with_lse=True)
            e = close(got.float(), want.float(),
                      f"decode_attn {(B, Hq, Hkv, S, dk)} {tuple(bl)} "
                      f"{dtype}", tol[dtype])
            # the log-sum-exp out (a cache split over ranks combines by
            # it): the output unchanged, the lse in f32 within f32's bound
            got_l, lse = da.decode_attn(q, kc, vc, lens, block_s=bs,
                                        with_lse=True)
            check(torch.equal(got_l, got), f"decode_attn "
                  f"{(B, Hq, Hkv, S, dk)} {dtype}: the output moved with "
                  "the lse out")
            e_lse[dtype] = max(e_lse[dtype], close(
                lse, want_lse, f"decode_attn lse {(B, Hq, Hkv, S, dk)} "
                f"{dtype}", tol[f32]))
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
    print(f"[K9] log-sum-exp out vs plain, every case: max abs err f32 "
          f"{e_lse[f32]:.3e}, bf16 inputs {e_lse[bf16]:.3e} (2e-4); the "
          "output bit-equal to the call without it")
    print(f"[K9] max abs err vs plain: f32 {errs['decode_attn'][f32]:.3e}, "
          f"bf16 {errs['decode_attn'][bf16]:.3e}; f32 results within 2e-4 "
          "at block_s 1, 16, 100 (32/4 x 128) and 128 (14/2 x 64); 32/4 x "
          "128 at block_s 128 raises (no launch in the table)")

    # --- A3. Qwen2-0.5B at full width and depth, f32 ----------------------
    cfg32 = dataclasses.replace(get_arch("qwen2-0.5b"), dtype="float32")
    model = registry.build(cfg32)
    p32 = model.init(torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(t.numel() for t in tree_leaves(p32))
    accounting("A3", cfg32, n_params)
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
    del full, outs, plain_full, plain_outs
    admission_f32("A3", model, p32, plain_attention, counted, counts)
    del p32, model
    torch.cuda.empty_cache()
    # the LayerNorm archs at full width, 2 layers, f32: K8 at dh 160 and
    # K9's split table at g = 8 against the plain plans, prefill + decode
    # against the forward
    for name in LN_ARCHS:
        model_f32_phase("A3", name, device, counted, counts, only)

    # --- A4. Qwen2-0.5B and Yi-9B in bf16, served --------------------------
    served_launches = {"flash_prefill": 0, "decode_attn": 0}
    attn_holds = {k: kernel_holds()[k] for k in served_launches}
    for name in ("qwen2-0.5b", "yi-9b"):
        cfg = get_arch(name)
        if name in SERVE_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[name])
        t0 = time.perf_counter()
        engine = serve_lm.build_engine(cfg, device, seed=0, batch_size=4,
                                       max_seq=SLOT_SEQ, engine="wave")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(engine.params))
        accounting("A4", cfg, n_params)
        print(f"[serve] {cfg.name}: {cfg.n_layers} x {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, {n_params / 1e9:.3f} B parameters "
              f"in {cfg.dtype}, drawn from seed 0 on the card in "
              f"{time.perf_counter() - t0:.1f} s")
        waves, got = wave_serve("A4", engine, slot_requests(cfg.vocab),
                                counted, counts, only, attn_holds,
                                plain_attention)
        for k in served_launches:
            served_launches[k] += got[k]
        if name == "qwen2-0.5b":
            # --- S1 and S3. the slot engine on the same parameters -------
            slot_slice("S1", cfg, engine.params, counted, counts, only,
                       attn_holds, plain_attention,
                       [w["decode_ms_per_token"] for w in waves],
                       chaos=True)
        del engine
        torch.cuda.empty_cache()
    # the LayerNorm archs at full width and ``SERVE_LAYERS`` depth through
    # both engines (at full depth Command-R-35B's 30.3 B parameters, 60.6
    # GB, fit beside its pools); their slot serves leave out chunked
    # admission and the comparisons with the wave engine at batch 1, which
    # S1 holds for the same code
    for name in LN_ARCHS:
        cfg = dataclasses.replace(get_arch(name),
                                  n_layers=SERVE_LAYERS[name])
        got = model_serve_phase("A4", cfg, device, counted, counts, only,
                                chaos=False, compare=False)
        for k in served_launches:
            served_launches[k] += got.get(k, 0)

    # --- A5. the kernels' times at the served shapes ----------------------
    rows = {}
    for name, (Hq, Hkv, dh) in (("qwen2-0.5b", (14, 2, 64)),
                                ("yi-9b", (32, 4, 128)),
                                ("musicgen-large", (32, 32, 64)),
                                ("stablelm-12b", (32, 8, 160)),
                                ("command-r-35b", (64, 8, 128))):
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
    # --- A6 to A9. attention training -------------------------------------
    return entries + attention_train_slice(device, gen, counted, counts,
                                           only)



def attn_grad_hold(got: torch.Tensor, want: torch.Tensor, what: str,
                   share: dict, one_step: bool = True) -> float:
    """Hold an attention gradient to its reference; return the max abs
    error.  f32 at K8's 2e-4 (tests/test_flash_prefill.py's kernel
    tolerance).  bf16 at K8's 3e-2 with its atol scaled by the reference's
    max abs (a gradient's scale is the inputs', not 1) and, with
    ``one_step`` (a reference that rounds where the kernel rounds, so that
    both sides sum in f32 and differ by the order of their sums), within
    one bf16 step at that max, 2^-7 max|want|; ``share`` keeps the largest
    error over max|want| of those."""
    if want.dtype == torch.float32:
        return close(got, want, what, dict(rtol=2e-4, atol=2e-4))
    m = float(want.float().abs().max())
    e = close(got.float(), want.float(), what,
              dict(rtol=3e-2, atol=3e-2 * m))
    if one_step:
        check(e <= 2.0 ** -7 * m, f"{what}: max abs err {e} is past one "
              f"bf16 step at max|want| {m}")
        share["bf16"] = max(share.get("bf16", 0.0), e / m if m else 0.0)
    return e


def attention_train_run(phase: str, cfg, n_steps: int, counted, counts,
                        only, arms, share: dict) -> dict:
    """``cfg`` trained in bf16 through ``launch/train.train`` (batch 4 x 512,
    AdamW, remat on, ``n_steps`` steps, weights from seed 0 on the card),
    counted, the plain attention and scan versions armed
    to raise: K8t twice and K8b once an attention layer a step and no K8; each
    K8b call of step 1 held against ``flash_prefill_bwd_plain`` on its own
    inputs; every loss and gradient norm finite; the last two steps under
    torch.profiler.  Prints the step time (host clock, steps 2 to ``n_steps`` -
    2), tokens/s, the model FLOPs' share of the bf16 peak, peak memory, the
    loss curve and the lm_head's share of a step.  Returns the launches and the
    report."""
    from repro_torch import steps as steps_lib
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.launch import train as train_lm

    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    kernel_bwd, plain_bwd = fp.flash_prefill_bwd, fp.flash_prefill_bwd_plain
    seen = {"n": 0, "err": 0.0, "shape": None}

    def checked_bwd(*args, **kwargs):
        """K8b as the training step calls it; each call of step 1 (the
        first ``n_attn``) held against the plain version on its own
        inputs, rounding as the instance does (``round_p`` in bf16).  The
        wrapper counts its calls through its module's name, which is this
        function while it is installed: the counts are carried across."""
        checked_bwd.launches = kernel_bwd.launches
        checked_bwd.tc_launches = kernel_bwd.tc_launches
        got = kernel_bwd(*args, **kwargs)
        kernel_bwd.launches = checked_bwd.launches
        kernel_bwd.tc_launches = checked_bwd.tc_launches
        if seen["n"] < n_attn:
            want = plain_bwd(*args, **kwargs,
                             round_p=args[0].dtype == torch.bfloat16)
            for n, a, b in zip(("dq", "dk", "dv"), got, want):
                seen["err"] = max(seen["err"], attn_grad_hold(
                    a, b, f"{phase} trained flash_prefill_bwd call "
                    f"{seen['n']} {n}", share))
            seen["n"] += 1
            seen["shape"] = (tuple(args[0].shape), tuple(args[1].shape),
                             args[0].dtype)
        return got

    train_step = steps_lib.train_step
    profiles = []
    fp.flash_prefill_bwd = checked_bwd
    steps_lib.train_step = profiling(train_step, n_steps, profiles)
    reset_counts(*counted)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with tripwires(*arms):
            report = train_lm.train(cfg, steps=n_steps, batch=4, seq=512,
                                    lr=3e-3, seed=0, device="cuda",
                                    log_every=1)
    finally:
        fp.flash_prefill_bwd, steps_lib.train_step = kernel_bwd, train_step
    wall = time.perf_counter() - t0
    got = counts()
    check(got == only(flash_prefill_traj=2 * n_attn * n_steps,
                      flash_prefill_bwd=n_attn * n_steps),
          f"{phase}: {n_steps} training steps launched {got}")
    check(seen["n"] == n_attn,
          f"{phase}: checked {seen['n']} K8b calls of step 1")
    n_tc = fp.flash_prefill_bwd.tc_launches
    check(n_tc == (got["flash_prefill_bwd"] if cfg.dtype == "bfloat16"
                   else 0),
          f"{phase}: {n_tc} of {got['flash_prefill_bwd']} K8b calls on the "
          "tensor cores")
    check(all(math.isfinite(x) for x in report["losses"]
              + report["grad_norms"]),
          f"{phase}: a loss or grad_norm is not finite: {report['losses']}, "
          f"{report['grad_norms']}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = report["step_ms"][1:-2]   # step 1 also ran the checks
    med = statistics.median(step_ms)
    tokens = report["tokens_per_step"]
    print(f"[{phase}] {cfg.name}: {cfg.n_layers} x {cfg.d_model}, "
          f"{report['n_params'] / 1e9:.3f} B parameters in {cfg.dtype}, batch"
          f" 4 x 512, {n_steps} steps in {wall:.1f} s (init included); "
          f"launches {got['flash_prefill_traj']} K8t + "
          f"{got['flash_prefill_bwd']} K8b calls ({2 * n_attn} + {n_attn} a "
          f"step; {n_tc} K8b on the tensor cores), none of K8, no plain "
          "attention or scan reached; every "
          f"loss and grad_norm finite; peak device memory {peak:.3f} GB "
          f"(torch.cuda.max_memory_allocated); {CARD['line']}")
    print(f"[{phase}] each of step 1's {seen['n']} K8b calls (q "
          f"{seen['shape'][0]}, k {seen['shape'][1]}, {seen['shape'][2]}) "
          f"against flash_prefill_bwd_plain (round_p in bf16) on its own "
          f"inputs: max abs err {seen['err']:.3e} (3e-2 x max|grad| and one "
          "bf16 step at max|grad|)")
    print(f"[{phase}] loss curve: "
          + ", ".join(f"{x:.3f}" for x in report["losses"]))
    print(f"[{phase}] grad norms: "
          + ", ".join(f"{x:.3g}" for x in report["grad_norms"]))
    print(f"[time] {phase} training step, {cfg.name}, batch 4 x 512, steps "
          f"2 to {n_steps - 2}: median {med:.3f} ms, min {min(step_ms):.3f} "
          "ms (host clock around the step, ending in the loss's copy to the "
          f"host; steps {n_steps - 1} and {n_steps} ran under the profiler); "
          f"{tokens / (med / 1e3):.1f} tokens/s; "
          + flops_share(phase, cfg, report, med))
    busy = print_step_profile(profiles, med)
    head = lm_head_ms(cfg, tokens)
    print(f"[profile] {phase} lm_head: the logits product (4 x 512 x "
          f"{cfg.d_model} by {max(cfg.n_codebooks, 1) * cfg.vocab}), the f32 "
          f"log-softmax and the "
          f"cross-entropy, forward and backward, timed alone with CUDA "
          f"events at the step's shapes: {head:.3f} ms"
          + (f", {head / busy:.1%} of the device-alone step's busy time"
             if busy else ""))
    return {"launches": got, "report": report, "median_ms": med}


def lm_head_ms(cfg, tokens: int) -> float:
    """Forward and backward of the lm_head and the loss at a training
    step's shapes, bf16 weights (CUDA events, median of 5 runs of 3): the
    step's largest matrix product (an audio model's K heads as one
    product of K x vocab columns, each codebook's log-softmax apart)."""
    from repro_torch import steps as steps_lib

    K = max(cfg.n_codebooks, 1)
    gen = torch.Generator().manual_seed(5)
    x = randn(4, tokens // 4, cfg.d_model, gen=gen).to(torch.bfloat16)
    w = randn(K * cfg.vocab, cfg.d_model, gen=gen,
              scale=cfg.d_model ** -0.5).to(torch.bfloat16)
    x.requires_grad_()
    w.requires_grad_()
    toks = torch.randint(0, cfg.vocab, (4, tokens // 4, K),
                         generator=gen).cuda()

    def step():
        logits = (x @ w.T).float().reshape(4, tokens // 4, K, cfg.vocab)
        loss = steps_lib._xent(logits[:, :-1], toks[:, 1:])
        return torch.autograd.grad(loss, (x, w))

    return time_ms(step, 3)


def attention_train_slice(device, gen, counted, counts, only) -> list[dict]:
    """Attention training: K8t and K8b against their plain versions and
    torch autograd (A6); Qwen2-0.5B at full width, 2 of 24 layers, f32:
    two steps' ``loss_fn`` gradients and the AdamW update between them on
    the card against the CPU, remat on and off (A7, ``grad_gate``); Qwen2-0.5B trained at full width and depth in bf16 for 40 steps
    through ``launch/train.train`` (A8); the two kernels' times beside
    their bounds, plain versions and SDPA forward + backward (and SDPA's
    backward alone), K8b's kernels' device times by the profiler, and
    ptxas's registers (A9).  Returns their entries of the ``kernels``
    line."""
    from repro_torch.analysis import (BF16_FLOP_PER_S, attn_bwd_work,
                                      attn_traj_work, bound)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_prefill as fp

    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    arms = plain_attention_arms() + plain_scan_arms()
    share: dict = {}
    errs = {"flash_prefill_traj": {f32: 0.0, bf16: 0.0},
            "flash_prefill_bwd": {f32: 0.0, bf16: 0.0}}
    lse_tol = dict(rtol=2e-4, atol=2e-4)

    # --- A6. K8t and K8b against their plain versions ---------------------
    # K8t's output bit-equal to K8's at the same tiles; its lse against the
    # plain version at K8's f32 2e-4 in both dtypes (an f32 value from f32
    # sums of exact products on both sides); K8b against the plain
    # backward on the same inputs (K8t's o and lse; in bf16 rounding p and
    # ds as the tensor-core instance does, round_p) and against torch
    # autograd of flash_prefill_plain (unrounded: in bf16 at 3e-2 x
    # max|grad| alone, the tolerance policy's tier; attn_grad_hold); two
    # runs of each bit-identical; every bf16 call on the tensor cores
    cases = [  # Qwen2's heads, OLMoE's, Yi's, StableLM's width, a ragged
        # S, a window of 64
        ("Qwen2", 4, 512, 14, 2, 64, 0), ("OLMoE", 4, 512, 16, 16, 128, 0),
        ("Yi", 4, 512, 32, 4, 128, 0), ("dh 160", 2, 512, 8, 8, 160, 0),
        ("ragged", 4, 300, 14, 2, 64, 0), ("window", 4, 512, 14, 2, 64, 64),
        # MusicGen-large's training heads: g = 1 at dh 64 (no reduction)
        ("MusicGen", 4, 512, 32, 32, 64, 0)]
    for label, B, S, Hq, Hkv, dh, w in cases:
        said = []
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[1]
            what = f"{label} B={B} S={S} {Hq}/{Hkv} x {dh} w={w} {name}"
            q, k, v = attn_inputs(B, S, Hq, Hkv, dh, dtype, gen)
            bl = fp.choose_blocks(S, dh, dtype)
            o8 = fp.flash_prefill(q, k, v, window=w)
            o, lse = fp.flash_prefill_traj(q, k, v, window=w)
            o2, lse2 = fp.flash_prefill_traj(q, k, v, window=w)
            check(torch.equal(o, o8), f"K8t {what}: output differs from K8's")
            check(torch.equal(o, o2) and torch.equal(lse, lse2),
                  f"K8t {what}: two runs differ")
            check(lse.dtype == f32 and lse.shape == (B, Hq, S),
                  f"K8t {what}: lse {lse.dtype} {tuple(lse.shape)}")
            _, p_lse = fp.flash_prefill_traj_plain(
                q, k, v, window=w, q_block=bl.q_block, k_block=bl.k_block,
                round_p=dtype == bf16)
            e_t = close(lse, p_lse, f"K8t {what} lse vs plain", lse_tol)
            errs["flash_prefill_traj"][dtype] = max(
                errs["flash_prefill_traj"][dtype], e_t)
            dout = randn(B, S, Hq, dh, gen=gen).to(dtype)
            tc0 = fp.flash_prefill_bwd.tc_launches
            got = fp.flash_prefill_bwd(q, k, v, o, lse, dout, window=w)
            again = fp.flash_prefill_bwd(q, k, v, o, lse, dout, window=w)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K8b {what}: two runs differ")
            n_tc = fp.flash_prefill_bwd.tc_launches - tc0
            check(n_tc == (2 if dtype == bf16 else 0),
                  f"K8b {what}: {n_tc} of 2 calls on the tensor cores")
            plain = fp.flash_prefill_bwd_plain(q, k, v, o, lse, dout,
                                               window=w,
                                               round_p=dtype == bf16)
            x = [t.clone().requires_grad_() for t in (q, k, v)]
            with torch.enable_grad():
                auto = torch.autograd.grad(fp.flash_prefill_plain(
                    *x, window=w, q_block=bl.q_block, k_block=bl.k_block),
                    x, dout)
            e_b = e_a = 0.0
            for n, g_, pl, au in zip(("dq", "dk", "dv"), got, plain, auto):
                check(g_.dtype == dtype and g_.shape == pl.shape,
                      f"K8b {what} {n}: {g_.dtype} {tuple(g_.shape)}")
                e_b = max(e_b, attn_grad_hold(g_, pl, f"K8b {what} {n} vs "
                                              "plain", share))
                e_a = max(e_a, attn_grad_hold(g_, au, f"K8b {what} {n} vs "
                                              "autograd", share,
                                              one_step=False))
            errs["flash_prefill_bwd"][dtype] = max(
                errs["flash_prefill_bwd"][dtype], e_b)
            said.append(f"{name}: K8t bit-equal to K8, lse vs plain "
                        f"{e_t:.3e}; K8b ({n_tc} of 2 calls on the tensor "
                        f"cores) vs plain{' round_p' if dtype == bf16 else ''}"
                        f" {e_b:.3e}, vs autograd of flash_prefill_plain "
                        f"{e_a:.3e}")
        print(f"[K8t/K8b] {label} B={B} S={S} {Hq}/{Hkv} x {dh} window={w}"
              f" (K8b tiles f32 {tuple(fp.choose_bwd_blocks(S, dh, f32))}, "
              f"bf16 {tuple(fp.choose_bwd_blocks(S, dh, bf16))}): "
              + "; ".join(said) + "; two runs bit-identical")
    print(f"[K8t/K8b] max abs err vs plain: K8t lse f32 "
          f"{errs['flash_prefill_traj'][f32]:.3e}, bf16 "
          f"{errs['flash_prefill_traj'][bf16]:.3e}; K8b f32 "
          f"{errs['flash_prefill_bwd'][f32]:.3e}, bf16 "
          f"{errs['flash_prefill_bwd'][bf16]:.3e}; bf16 gradients vs "
          f"their rounding plain versions within {share.get('bf16', 0.0):.3e}"
          f" x max|want| (held at one bf16 step, 2^-7 = {2.0 ** -7:.3e})")

    # --- A7. the f32 gate: Qwen2-0.5B at full width, 2 of 24 layers -------
    free_models("A7")
    grad_gate("A7", get_arch("qwen2-0.5b"), (2, 256), device, counted,
              counts, only, arms, both_remats=True)
    free_models("A8")

    # --- A8. Qwen2-0.5B trained at full width and depth, bf16 -------------
    n_steps = 40
    run = attention_train_run("A8", get_arch("qwen2-0.5b"), n_steps, counted,
                              counts, only, arms, share)
    launches = {k: run["launches"][k]
                for k in ("flash_prefill_traj", "flash_prefill_bwd")}
    free_models("A9")

    # --- A9. K8t's and K8b's times at the training shapes ------------------
    rows = {}
    for name, (B, S, Hq, Hkv, dh) in (
            ("qwen2-0.5b", (4, 512, 14, 2, 64)),
            ("olmoe-1b-7b", (4, 512, 16, 16, 128)),
            ("musicgen-large", (4, 512, 32, 32, 64)),
            # T1's training heads: the GQA reduction at dh 160, and g = 8
            ("stablelm-12b", (4, 512, 32, 8, 160)),
            ("command-r-35b", (4, 512, 64, 8, 128))):
        q, k, v = attn_inputs(B, S, Hq, Hkv, dh, bf16, gen)
        bl = fp.choose_blocks(S, dh, bf16)
        o, lse = fp.flash_prefill_traj(q, k, v)
        dout = randn(B, S, Hq, dh, gen=gen).to(bf16)
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, dout))
        for t in (qt, kt, vt):
            t.requires_grad_()

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
            return torch.autograd.grad(out, (qt, kt, vt), dot)

        lib = torch.autograd.grad(F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), (qt, kt, vt), dot)
        mine = fp.flash_prefill_bwd(q, k, v, o, lse, dout)
        e_lib = max(close(a.transpose(1, 2).float(), b.float(),
                          f"SDPA backward vs K8b at {name}",
                          dict(rtol=3e-2, atol=3e-2 * float(
                              b.float().abs().max())))
                    for a, b in zip(lib, mine))
        lib_fb = time_ms(sdpa_fwd_bwd, 10)
        lib_fb_graph = graph_ms(sdpa_fwd_bwd, 5)
        t_bound, by = bound(*attn_traj_work(B, S, Hq, Hkv, dh, bf16),
                            flop_rate=BF16_FLOP_PER_S)
        rows["flash_prefill_traj", name] = r = dict(
            ms=time_ms(lambda: fp.flash_prefill_traj(q, k, v), 20),
            graph_ms=graph_ms(lambda: fp.flash_prefill_traj(q, k, v)),
            plain_ms=time_ms(lambda: fp.flash_prefill_traj_plain(
                q, k, v, q_block=bl.q_block, k_block=bl.k_block,
                round_p=True), 1, repeats=3),
            library_ms=time_ms(sdpa_fwd, 20),
            library_graph_ms=graph_ms(sdpa_fwd), bound_ms=t_bound,
            bound_by=by)
        t_bound, by = bound(*attn_bwd_work(B, S, Hq, Hkv, dh, bf16),
                            flop_rate=BF16_FLOP_PER_S)
        rows["flash_prefill_bwd", name] = rb = dict(
            ms=time_ms(lambda: fp.flash_prefill_bwd(q, k, v, o, lse, dout),
                       10),
            graph_ms=graph_ms(lambda: fp.flash_prefill_bwd(
                q, k, v, o, lse, dout), 5),
            plain_ms=time_ms(lambda: fp.flash_prefill_bwd_plain(
                q, k, v, o, lse, dout, round_p=True), 1, repeats=3),
            library_ms=lib_fb, library_graph_ms=lib_fb_graph,
            bound_ms=t_bound, bound_by=by)
        ops_b = attn_bwd_work(B, S, Hq, Hkv, dh, bf16)[1]
        per_kernel = kernel_device_ms(
            lambda: fp.flash_prefill_bwd(q, k, v, o, lse, dout), 10,
            ("flash_prefill_bwd_dq_tc", "flash_prefill_bwd_dkv_tc",
             "flash_prefill_bwd_sum"))
        print(f"[time] flash_prefill_traj (K8t) {name} B={B} S={S} "
              f"{Hq}/{Hkv} x {dh} bf16 on the tensor cores: kernel "
              f"{r['ms']:.4f} ms back to back, {r['graph_ms']:.4f} ms in a "
              f"CUDA graph; plain {r['plain_ms']:.4f} ms; SDPA forward "
              f"(is_causal, enable_gqa) {r['library_ms']:.4f} ms, "
              f"{r['library_graph_ms']:.4f} ms in a graph; bound "
              f"{r['bound_ms']:.3e} ms ({r['bound_by']}, bf16 dense peak)")
        sdpa_bwd = rb["library_graph_ms"] - r["library_graph_ms"]
        print(f"[time] flash_prefill_bwd (K8b) {name} B={B} S={S} "
              f"{Hq}/{Hkv} x {dh} bf16 (tensor cores, "
              f"{tuple(fp.choose_bwd_blocks(S, dh, bf16))}): kernels "
              f"{rb['ms']:.4f} ms back to back, {rb['graph_ms']:.4f} ms in "
              f"a CUDA graph ({ops_b / rb['graph_ms'] / 1e9:.1f} TFLOP/s of "
              f"the five causal products); by kernel (torch.profiler over "
              f"10 calls, mean of the launches it recorded): " + (", ".join(
                  f"{k} {ms:.4f} ms ({n} launches)"
                  for k, (ms, n) in per_kernel.items())
                  or "not measured (no device event recorded)")
              + f"; plain (round_p) {rb['plain_ms']:.4f} ms; SDPA forward + "
              f"backward {rb['library_ms']:.4f} ms, "
              f"{rb['library_graph_ms']:.4f} ms in a graph (a yardstick: "
              f"its gradients vs K8b's {e_lib:.3e}); SDPA's backward alone "
              f"{sdpa_bwd:.4f} ms (its forward + backward graph less its "
              f"forward graph, timed apart); K8t + K8b in graphs "
              f"{r['graph_ms'] + rb['graph_ms']:.4f} ms, "
              f"{(r['graph_ms'] + rb['graph_ms']) / rb['library_graph_ms']:.2f}x"
              f" SDPA's; bound {rb['bound_ms']:.3e} ms ({rb['bound_by']}, "
              f"bf16 dense peak), kernels at "
              f"{rb['graph_ms'] / rb['bound_ms']:.1f}x it in a graph; "
              f"{CARD['line']}")
    for src, legend in (("flash_prefill", "K8t: flash_prefill_kernel "
                         "<dh,lse>, flash_prefill_tc_kernel <padded dh,"
                         "k_block,lse>"),
                        ("flash_prefill_bwd", "K8b: flash_prefill_bwd_dq_tc "
                         "and _dkv_tc <padded dh>, flash_prefill_bwd_sum "
                         "<IO>, the f32 flash_prefill_bwd_kernel <dh,dq>")):
        compiled = ""                  # the entry ptxas is reporting on
        for line in BUILD_LOGS.get(src, "").splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                compiled = entry.group(1)
            elif ("registers" in line or "spill" in line) and (
                    src == "flash_prefill_bwd"
                    or instance(compiled).endswith(",1>")):
                print(f"[time] {src} ({legend}) {kernel_name(compiled)}"
                      f"{instance(compiled)}: {line.strip()}")
    entries = []
    for kname, src in (("flash_prefill_traj", "flash_prefill.cu"),
                       ("flash_prefill_bwd", "flash_prefill_bwd.cu")):
        r = rows[kname, "qwen2-0.5b"]
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": "none: no TPU counterpart (the JAX package "
                        "differentiates its jnp flash_attention, "
                        "src/repro/models/attention.py:60)",
            "launches": launches[kname],
            "max_abs_err": errs[kname][bf16], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "graph_ms": r["graph_ms"],
            "library_graph_ms": r["library_graph_ms"]})
    return entries


def adamw_plain(opt, gnorm: torch.Tensor, p: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """The parameter after ``opt.update_``'s first step from zero moments,
    written out of place in the order of the JAX package's formula (the
    CPU tests' ``_adamw_out_of_place``), for a piece of a leaf: ``gnorm``
    is the global norm of every gradient."""
    f32 = torch.float32
    step = torch.tensor(1.0, dtype=f32)
    scale = torch.clamp(opt.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - torch.pow(torch.tensor(opt.b1, dtype=f32), step)
    bc2 = 1 - torch.pow(torch.tensor(opt.b2, dtype=f32), step)
    lr = torch.tensor(opt.lr, dtype=f32)
    g32 = g.float() * scale
    zero = torch.zeros_like(g32)
    m = opt.b1 * zero + (1 - opt.b1) * g32
    n = opt.b2 * zero + (1 - opt.b2) * g32 * g32
    u = (m / bc1) / (torch.sqrt(n / bc2) + opt.eps)
    u = u + opt.weight_decay * p.float()
    return (p.float() - lr * u).to(p.dtype)


def grad_gate(phase: str, full, batch: tuple[int, int], device, counted,
              counts, only, arms, both_remats: bool = False) -> None:
    """The f32 gate of LM training (A7, T1): ``full`` at full width, 2
    layers, in f32, a (B, S) batch of seed-7 tokens.  Step 1's ``loss_fn``
    loss and gradients on the card against the same model on the CPU (loss
    rtol 1e-5; every leaf rtol 1e-4, atol 1e-4 x its max|grad|); then one
    AdamW update (``optim/adamw.update_``, in place, lr 3e-3) of the card's
    parameters from its gradients, against the out-of-place formula
    (``adamw_plain``) on the card from the same gradients and the CPU's
    copy of the parameters before it, piece by piece (rtol 1e-6; the two
    are bit-equal on the CPU, tests/test_torch_train.py); then step 2 from
    the card's updated parameters on both sides, its loss and gradients
    held as step 1's.  (Updated each from its own gradients, the two sides
    would part: AdamW's first step moves an entry by about lr x g / (|g| +
    eps), so a gradient near eps = 1e-8 that rounds differently on the two
    devices moves its entry differently, by up to 2 lr.)  Each
    card step launches 2 K8t (1 with remat off) and 1 K8b an attention
    layer and no K8, the plain attention armed to raise.
    ``both_remats``: step 1 on the card also with remat off, its gradients
    against remat on's.  A function of its own, so that no gradient
    outlives it on the card."""
    from repro_torch import steps as steps_lib
    from repro_torch.models import registry
    from repro_torch.optim.adamw import (AdamW, global_norm, tree_leaves,
                                         tree_map)

    cfg2 = dataclasses.replace(full, n_layers=2, dtype="float32")
    L = cfg2.n_layers
    p_card = registry.build(cfg2).init(
        torch.Generator(device=device).manual_seed(0), device)
    p_cpu = tree_map(lambda t: t.detach().to("cpu", copy=True), p_card)
    for t in tree_leaves(p_card) + tree_leaves(p_cpu):
        t.requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg2.vocab, batch).astype(np.int32))
    opt = AdamW(lr=3e-3)

    def grads(params, remat: bool = True):
        reset_counts(*counted)
        b = {"tokens": toks.to(tree_leaves(params)[0].device)}
        loss, _ = steps_lib.loss_fn(params, cfg2, b, remat=remat)
        g = torch.autograd.grad(loss, tree_leaves(params))
        if loss.is_cuda:
            torch.cuda.synchronize()
        return loss.detach(), g, counts()

    def update(params, g) -> torch.Tensor:
        """One AdamW step from zero moments, which go with it: step 2
        needs only the parameters (Command-R-35B's f32 moments are 28
        GB)."""
        flat = iter(g)
        return opt.update_(tree_map(lambda _: next(flat), params),
                           opt.init(params), params)["grad_norm"]

    def pieces(a, b):
        """A card leaf and its CPU twin in pieces of 2^28 entries, each of
        the CPU's moved to the card as it comes, so that the comparison's
        temporaries fit beside the card's model."""
        return zip(a.detach().reshape(-1).split(1 << 28),
                   (x.to(device) for x in b.detach().reshape(-1).split(
                       1 << 28)))

    def held(step, loss_card, g_card, loss_cpu, g_cpu):
        e_loss = close(loss_card.cpu(), loss_cpu,
                       f"{phase} {full.name} step {step} loss, card vs CPU",
                       dict(rtol=1e-5, atol=0.0))
        e_grad = 0.0
        for a, b in zip(g_card, g_cpu):
            m = float(b.abs().max())
            for a_, b_ in pieces(a, b):
                e_grad = max(e_grad, close(
                    a_, b_,
                    f"{phase} {full.name} step {step} grads, card vs CPU",
                    dict(rtol=1e-4, atol=1e-4 * m)) / (m or 1))
        return e_loss, e_grad

    said, t_cpu = [], 0.0
    for step in (1, 2):
        with tripwires(*arms):
            loss_card, g_card, n_card = grads(p_card)
        check(n_card == only(flash_prefill_traj=2 * L, flash_prefill_bwd=L),
              f"{phase} {full.name} 2-layer f32 step {step} launched "
              f"{n_card}")
        if step == 1 and both_remats:
            with tripwires(*arms):
                _, g_off, n_off = grads(p_card, remat=False)
            check(n_off == only(flash_prefill_traj=L, flash_prefill_bwd=L),
                  f"{phase} {full.name} 2-layer f32 step (remat off) "
                  f"launched {n_off}")
            d_remat = max(close(a, b, f"{phase} grads, remat on vs off",
                                dict(rtol=1e-4,
                                     atol=1e-4 * float(b.abs().max())))
                          for a, b in zip(g_card, g_off))
            del g_off
            said.append(f"remat on vs off max abs diff {d_remat:.3e} (1 K8t"
                        f" + 1 K8b a layer with remat off)")
        t = time.perf_counter()
        loss_cpu, g_cpu, _ = grads(p_cpu)
        t_cpu += time.perf_counter() - t
        e_loss, e_grad = held(step, loss_card, g_card, loss_cpu, g_cpu)
        said.append(f"step {step}: loss {float(loss_card):.6f}, card vs CPU "
                    f"{e_loss:.3e}; every leaf's gradient within "
                    f"{e_grad:.3e} x its max|grad|")
        del g_cpu
        if step == 1:
            gnorm = global_norm(g_card)
            gn = update(p_card, g_card)
            check(torch.equal(gn, gnorm), f"{phase} {full.name} AdamW's "
                  f"grad norm {float(gn)} against {float(gnorm)}")
            e_p, bits = 0.0, True
            for a, before, g in zip(tree_leaves(p_card), tree_leaves(p_cpu),
                                    g_card):
                for (a_, b_), g_ in zip(pieces(a, before),
                                        g.reshape(-1).split(1 << 28)):
                    want = adamw_plain(opt, gnorm, b_, g_)
                    e_p = max(e_p, close(
                        a_, want, f"{phase} {full.name} AdamW's update in "
                        "place vs its formula", dict(rtol=1e-6, atol=0.0)))
                    bits = bits and torch.equal(a_, want)
            with torch.no_grad():      # step 2 from the same parameters
                for a, b in zip(tree_leaves(p_card), tree_leaves(p_cpu)):
                    b.copy_(a)
            said.append(f"AdamW's update in place on the card (grad norm "
                        f"{float(gn):.6g}) against its out-of-place formula:"
                        " " + ("bit-equal" if bits else f"within {e_p:.3e}")
                        + "; the updated parameters copied to the CPU")
        del g_card
    print(f"[{phase}] {full.name} at full width, 2 of {full.n_layers} "
          f"layers, f32 ({cfg2.n_heads}/{cfg2.n_kv_heads} heads of "
          f"{cfg2.head_dim}), B={batch[0]} S={batch[1]}, on the card against"
          f" the CPU (loss rtol 1e-5; gradients rtol 1e-4, atol 1e-4 x "
          f"max|grad|; AdamW's update rtol 1e-6): " + "; ".join(said)
          + f"; the CPU's two steps {t_cpu:.1f} s; launches a "
          f"step {2 * L} K8t + {L} K8b, no K8; no plain attention reached "
          "on the card")


def ln_train_slice(device, gen, counted, counts, only) -> dict:
    """T1: the LayerNorm archs (``LN_ARCHS``) trained at full width.  For
    each, the f32 gate at 2 layers (``grad_gate``, B=1 S=128); then
    ``attention_train_run`` in bf16 for 8 steps at batch 4 x 512, AdamW,
    remat on, at ``TRAIN_LAYERS`` depth: every K8b call of step 1 held
    against ``flash_prefill_bwd_plain(round_p=True)`` (at StableLM-2-12B's
    32/8 x 160 the GQA reduction at dh 160), 2 K8t + 1 K8b an attention
    layer a step, no K8, every K8b call on the tensor cores, the plain
    attention armed to raise, every loss and grad norm finite.  Returns the
    K8t and K8b launches of the bf16 runs."""
    from repro_torch.configs import get_arch

    arms = plain_attention_arms() + plain_scan_arms()
    share: dict = {}
    launched = {"flash_prefill_traj": 0, "flash_prefill_bwd": 0}
    for name in LN_ARCHS:
        full = get_arch(name)
        free_models(f"T1 {name}")
        grad_gate("T1", full, (1, 128), device, counted, counts, only, arms)
        free_models(f"T1 {name} bf16")
        cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS[name])
        print(f"[T1] {name}: {cfg.n_layers} of {full.n_layers} layers "
              "(TRAIN_LAYERS)")
        run = attention_train_run("T1", cfg, 8, counted, counts, only, arms,
                                  share)
        for k in launched:
            launched[k] += run["launches"][k]
        del run
    free_models("T1 done")
    return launched


#: the bf16 tier of the attention kernels (K8, K9: 3e-2), the least the
#: bf16 serving comparisons below stop at: greedy tokens of two runs whose
#: sums run in another order are compared up to the first token whose
#: top-2 logit margin in the reference is within this tolerance of its top
#: logit, or within the family's plan spread (``plan_spread``, measured on
#: the same prompts and independent of both runs; 32 random bf16 RWKV6
#: layers spread two plans' logits by O(1), phase R3)
MARGIN_TOL = dict(rtol=3e-2, atol=3e-2)
#: the card's name and power limit, as nvidia-smi prints them (set by main)
CARD = {"line": ""}
#: the slot phases' prompt lengths (8 requests, 16 new tokens each), lanes
#: and cache positions
SLOT_LENS = (412, 300, 377, 500, 333, 468, 451, 389)
N_SLOTS, SLOT_SEQ = 4, 500 + 16 + 1


@contextlib.contextmanager
def capturing(module, name: str, calls: list, hold):
    """Install a wrapper of the kernel ``module.name`` that holds each
    launch against its plain version as it comes, on the launch's own
    inputs before the model overwrites them (``hold(args, kwargs, out)``,
    ``disarmed``), and keeps the error in ``calls``, or the exception of
    a hold that failed (``held`` raises it: the slot engine contains a
    failing admission, which would hide it).  No launch's inputs are
    kept, so a model whose caches fill the card is held launch by launch.
    The wrapper counts its launches through its module's name, which is
    this function while it is installed: the counts are carried across."""
    kernel = getattr(module, name)
    attrs = [a for a in ("launches", "tc_launches") if hasattr(kernel, a)]

    def captured(*args, **kwargs):
        for a in attrs:
            setattr(captured, a, getattr(kernel, a))
        out = kernel(*args, **kwargs)
        for a in attrs:
            setattr(kernel, a, getattr(captured, a))
        try:
            with disarmed():
                calls.append(hold(args, kwargs, out))
        except Exception as err:             # noqa: BLE001 (see held)
            calls.append(err)
        return out

    for a in attrs:
        setattr(captured, a, getattr(kernel, a))
    setattr(module, name, captured)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def held(calls: dict, launched: dict, what: str) -> str:
    """The errors of every captured launch (``calls``, by kernel: each
    launch's max abs error against its plain version); each kernel's held
    launches must number its counted launches (``launched``).  Returns the
    errors, or says that none of the kernels launched."""
    out = []
    for k, errs in calls.items():
        failed = [e for e in errs if isinstance(e, Exception)]
        if failed:
            raise RuntimeError(f"{what}: {len(failed)} of {len(errs)} {k} "
                               f"launches failed their hold: {failed[0]}"
                               ) from failed[0]
        check(len(errs) == launched.get(k, 0),
              f"{what}: held {len(errs)} {k} launches, counted "
              f"{launched.get(k, 0)}")
        if errs:
            out.append(f"{k}: each of {len(errs)} launches vs plain, max "
                       f"abs err {max(errs):.3e}")
    return "; ".join(out) or f"none of {sorted(calls)} launched"


def plain_scan_arms() -> tuple:
    """The Mamba scan's plain versions, for ``tripwires``: the plain K7,
    K7t and K7b, JAX's reference scan and the chunk math they share."""
    from repro_torch.kernels import mamba_scan as ms

    return ((ms, "mamba_scan_plain"), (ms, "mamba_scan_traj_plain"),
            (ms, "mamba_scan_bwd_plain"), (ms, "mamba_scan_ref"),
            (ms, "_chunk_math"))


def plain_attention_arms() -> tuple:
    """Attention's plain versions, for ``tripwires``: the plain K8, K8t,
    K8b and K9, the model's blocked and einsum plans and the oracles."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ref
    from repro_torch.models import attention

    return ((fp, "flash_prefill_plain"), (da, "decode_attn_plain"),
            (attention, "flash_attention"), (attention, "_decode_einsum"),
            (ref, "prefill_attn"), (ref, "decode_attn"),
            (fp, "flash_prefill_traj_plain"), (fp, "flash_prefill_bwd_plain"))


def kernel_holds(attn_tol: dict = MARGIN_TOL) -> dict:
    """{kernel: (module, wrapper name, hold)} for the serving paths' kernels
    K7, K8 and K9: ``hold(args, kwargs, out)`` holds one captured launch
    against its plain version on the launch's own inputs (K8 and K9 at the
    launch's tiles and ``attn_tol``, by default the attention kernels' bf16
    tier, 3e-2; K7's output and state at MAMBA_TOL f32) and returns the
    max abs error."""
    from repro_torch.core import plans
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import mamba_scan as ms

    scan_tol = plans.MAMBA_TOL["float32"]

    def hold_fp(args, kwargs, out):
        bl = fp.choose_blocks(args[0].shape[1], args[0].shape[3],
                              args[0].dtype)
        want = fp.flash_prefill_plain(*args, window=kwargs.get("window", 0),
                                      q_block=bl.q_block, k_block=bl.k_block)
        return close(out.float(), want.float(), "a flash_prefill launch",
                     attn_tol)

    def hold_da(args, kwargs, out):
        B_, S_, Hkv_, dk_ = args[1].shape
        bl = da.choose_blocks(S_, B_, Hkv_, args[0].shape[1] // Hkv_, dk_,
                              args[0].dtype)
        want = da.decode_attn_plain(*args, block_s=bl.block_s,
                                    splits=bl.splits)
        return close(out.float(), want.float(), "a decode_attn launch",
                     attn_tol)

    def hold_scan(args, kwargs, out):
        want = ms.mamba_scan_plain(*args, kwargs["chunk"])
        return max(close(out[0], want[0], "a mamba_scan launch's y",
                         scan_tol),
                   close(out[1], want[1], "a mamba_scan launch's state",
                         scan_tol))

    return {"flash_prefill": (fp, "flash_prefill", hold_fp),
            "decode_attn": (da, "decode_attn", hold_da),
            "mamba_scan": (ms, "mamba_scan", hold_scan)}


def top2_margins(logits: torch.Tensor) -> list[list[tuple[float, float]]]:
    """(top logit, top-2 margin) of each row of each lane, on the host:
    logits (B, V) give one row a lane, an audio model's (B, K, V) one a
    codebook."""
    v = logits.float().topk(2, dim=-1).values.cpu()
    return [[(float(a), float(a - b)) for a, b in lane.reshape(-1, 2)]
            for lane in v.reshape(logits.shape[0], -1, 2)]


def last_logits(logits: torch.Tensor) -> torch.Tensor:
    """A B=1 prefill's last-position logits on the host, f32: (V,), or
    (K, V) for an audio model's (1, K, S, V)."""
    return logits[0, ..., -1, :].float().cpu()


def token_steps(tokens: np.ndarray) -> list[tuple[int, ...]]:
    """A Result's tokens, (m,) or (K, m) codebooks, as its m steps."""
    t = np.asarray(tokens)
    return [tuple(int(x) for x in col)
            for col in t.reshape(-1, t.shape[-1]).T]


def agreed(ref_tokens, margins, other_tokens, tol: dict = MARGIN_TOL,
           floor: float = 0.0) -> tuple[int, int]:
    """(k, n): the reference's token steps up to the first one with a row
    (a codebook's, for audio) whose top-2 margin is within ``tol`` of its
    top logit or within ``floor`` (k of them), and how many leading steps
    of ``other_tokens`` equal the reference's (n); tokens as a Result
    holds them, margins one list of rows a step (``top2_margins``)."""
    ref_tokens, other_tokens = token_steps(ref_tokens), token_steps(
        other_tokens)
    k = len(ref_tokens)
    for j, rows in enumerate(margins):
        if any(gap <= max(floor, tol["atol"] + tol["rtol"] * abs(top))
               for top, gap in rows):
            k = j
            break
    n = 0
    while n < len(ref_tokens) and n < len(other_tokens) \
            and ref_tokens[n] == other_tokens[n]:
        n += 1
    return k, n


def token_tail(cfg) -> tuple[int, ...]:
    """A step's token shape: (K,) for an audio model's codebooks, else ()."""
    return (cfg.n_codebooks,) if cfg.n_codebooks else ()


def slot_seq(cfg) -> int:
    """The slot phases' cache positions: ``SLOT_SEQ``, plus a vision
    model's prefix (the engines check a prompt's text alone against
    ``max_seq``, as the JAX package's do)."""
    return SLOT_SEQ + cfg.n_vis_tokens


def slot_requests(vocab: int, tail: tuple[int, ...] = ()) -> list:
    """The slot phases' requests: ``SLOT_LENS`` prompts drawn from seed 0,
    16 new tokens each; ``tail`` (K,) makes (K, S) codebook prompts."""
    from repro_torch.serving import Request

    prng = np.random.default_rng(0)
    return [Request(i, prng.integers(0, vocab, tail + (n,)).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate(SLOT_LENS)]


def slot_engine(model, params, chunk: int | None = None,
                max_seq: int | None = None, **kw):
    """A SlotEngine of ``N_SLOTS`` lanes of ``max_seq`` positions (by
    default ``slot_seq``): whole-prompt admission, or chunks of ``chunk``
    through 2 prefill lanes."""
    from repro_torch.serving import EngineConfig, SlotEngine

    return SlotEngine(model, params, config=EngineConfig(
        n_slots=N_SLOTS, max_seq=max_seq or slot_seq(model.cfg),
        queue_capacity=8,
        prefill_chunk_len=chunk, prefill_lanes=2, **kw))


def tokens_ok(results, cfg, what: str) -> None:
    from repro_torch.serving import FinishReason

    shape = token_tail(cfg) + (16,)
    check(all(r.tokens.shape == shape and int(r.tokens.min()) >= 0
              and int(r.tokens.max()) < cfg.vocab
              and r.finish_reason == FinishReason.LENGTH for r in results),
          f"{what}: tokens outside [0, vocab), not {shape} a request or not "
          "finished by length")


@contextlib.contextmanager
def watching(eng, first: dict, margins: dict):
    """While installed, record each request the slot engine ``eng``
    admits: its first-token logits (``first[uid]``, f32 on the host: the
    last row of its whole-prompt prefill or of its last chunk) and the
    (top logit, top-2 margin) of each of its tokens (``margins[uid, j]``,
    j = 0 from those logits, the others from the ticks)."""
    from repro_torch import steps as steps_lib

    mgr = eng.manager
    tick = eng.ticks["decode/base"]
    plan = eng.scheduler.plans["decode/base"]
    prefill, admit, advance = eng._prefill, mgr.admit, eng._advance_lane
    chunk_step = steps_lib.chunked_prefill_step
    seen = {}

    def w_prefill(p, c, b):
        logits, c = prefill(p, c, b)
        seen["logits"] = last_logits(logits)
        return logits, c

    def w_admit(index, req, *args, **kwargs):
        if "logits" in seen:                   # whole-prompt admission
            first[req.uid] = seen.pop("logits")
        margins[req.uid, 0] = top2_margins(first[req.uid][None])[0]
        return admit(index, req, *args, **kwargs)

    def w_advance(lane, now):
        seen["uid"] = lane.request.uid
        return advance(lane, now)

    def w_chunk(cfg_, p, c, b):
        logits, c = chunk_step(cfg_, p, c, b)
        first[seen["uid"]] = last_logits(logits)
        return logits, c

    def w_tick():
        live = [s for s in mgr.slots if s.occupied and s.remaining > 0]
        out = tick()
        m = top2_margins(out[2])
        for s in live:
            margins[s.request.uid, len(s.tokens)] = m[s.index]
        return out

    eng._prefill, mgr.admit, eng._advance_lane = w_prefill, w_admit, w_advance
    plan.fn, steps_lib.chunked_prefill_step = w_tick, w_chunk
    try:
        yield
    finally:
        eng._prefill, mgr.admit, eng._advance_lane = prefill, admit, advance
        plan.fn, steps_lib.chunked_prefill_step = tick, chunk_step


@contextlib.contextmanager
def plain_plans():
    """Every model family's plain plans in place of its kernels': blocked
    attention and einsum decode, chunked_xla WKV6, the plain Mamba
    scan.  The blocked attention takes all rows as one q block: its
    default of 512 must divide S (as the JAX function asserts), which a
    vision prefix's 256 rows ahead of 300 to 500 text tokens do not; the
    rows' sums are the same either way (a q block only groups rows)."""
    from repro_torch.models import attention, mamba, rwkv

    old = (attention.PREFILL_PLAN, attention.DECODE_PLAN, rwkv.WKV_PLAN,
           mamba.SCAN_PLAN, attention.flash_attention)
    blocked = attention.flash_attention
    attention.PREFILL_PLAN, attention.DECODE_PLAN = "blocked", "einsum"
    rwkv.WKV_PLAN, mamba.SCAN_PLAN = "chunked_xla", "scan"
    attention.flash_attention = lambda q, k, v, **kw: blocked(
        q, k, v, q_block=q.shape[1], **kw)
    try:
        yield
    finally:
        (attention.PREFILL_PLAN, attention.DECODE_PLAN, rwkv.WKV_PLAN,
         mamba.SCAN_PLAN, attention.flash_attention) = old


def plan_spread(eng, reqs, first: dict) -> float:
    """The family's plan spread: the largest difference between each
    request's first-token logits from ``eng``'s whole-prompt admission
    (``first``) and from the same B=1 prefill through the plain plans.
    Measured on the prompts the slot phases compare, it is the spread one
    change of summation order gives this model, and is independent of
    chunked admission, of the decode ticks and of the wave engine."""
    spread = 0.0
    with torch.no_grad(), plain_plans():
        for r in reqs:
            cache = eng.model.init_cache(1, eng.max_seq, eng.device)
            logits, _ = eng._prefill(eng.params, cache,
                                     eng._prefill_batch(r.prompt[None]))
            spread = max(spread, float((last_logits(logits)
                                        - first[r.uid]).abs().max()))
            del cache, logits
    return spread


def admission_f32(phase: str, model, params, arms, counted, counts) -> None:
    """The slot engine's chunked admission (chunks of 128, 2 prefill lanes)
    against its whole-prompt admission, on a phase's f32 model at full
    width (``params``, already drawn), over the slot phases' 8 requests,
    the plain versions in ``arms`` armed to raise.  In f32 two summation
    orders agree to CONSISTENCY_TOL, the tolerance the phase holds
    prefill + decode against the forward at: each request's first-token
    logits are held at it, and its 16 greedy tokens must equal the whole-
    prompt run's up to the first top-2 margin within it.  This is the
    card's check of prefill_chunk, chunk_prefill_attention and the scans
    resumed from carried state; in bf16 (phases S1, S2) random layers
    spread two orders' logits too far for one."""
    reqs = slot_requests(model.cfg.vocab, token_tail(model.cfg))
    runs = {}
    for mode, chunk in (("whole", None), ("chunked", 128)):
        eng = slot_engine(model, params, chunk)
        first, margins = {}, {}
        reset_counts(*counted)
        with tripwires(*arms), watching(eng, first, margins):
            results = eng.serve(reqs)
        launched = {k: v for k, v in counts().items() if v}
        tokens_ok(results, model.cfg,
                  f"{phase} {model.cfg.name} f32 {mode} slot serve")
        runs[mode] = (results, first, margins, launched)
        del eng
    (whole, f_w, m_w, n_w), (chunked, f_c, _, n_c) = (runs["whole"],
                                                      runs["chunked"])
    err = max(close(f_c[r.uid], f_w[r.uid],
                    f"{phase} f32 first-token logits of request {r.uid}, "
                    f"chunked vs whole-prompt admission", CONSISTENCY_TOL)
              for r in reqs)
    stops = []
    for r, w, c in zip(reqs, whole, chunked):
        k, n = agreed(w.tokens, [m_w[r.uid, j] for j in range(16)],
                      c.tokens, CONSISTENCY_TOL)
        check(n >= k, f"{phase} f32 chunked vs whole-prompt: request "
              f"{r.uid} differs at token {n}, before the first margin "
              f"within CONSISTENCY_TOL at {k}")
        stops.append(f"{r.uid}:{k}/{n}")
    print(f"[{phase}] {model.cfg.name} {model.cfg.n_layers} layers f32, slot "
          f"engine ({N_SLOTS} x {slot_seq(model.cfg)}): chunked admission "
          f"(128 and "
          f"powers of two, launches {n_c}) vs whole-prompt (launches {n_w}): "
          f"first-token logits of the 8 requests max abs err {err:.3e} "
          f"({CONSISTENCY_TOL}); tokens equal up to the whole-prompt run's "
          f"first top-2 margin within it (uid:margin stop/first difference, "
          f"16 = none) {' '.join(stops)}")


def slot_slice(phase: str, cfg, params, counted, counts, only,
               holds: dict, arms, wave_ms: list[float],
               chaos: bool = False, compare: bool = True, reqs=None,
               max_seq: int | None = None) -> dict:
    """The slot engine on one family at full width in bf16 (phases S1 to
    S4), over the parameters its slice already drew (``params``): the 8
    requests of ``slot_requests`` (or ``reqs``, 16 new tokens each),
    ``N_SLOTS`` lanes of ``slot_seq`` positions (or ``max_seq``).

    * the graph-ticked whole-prompt serve, counted (the launches its
      capture recorded, i.e. per replayed tick, and the eager prefill
      launches), the plain versions in ``arms`` armed to raise, every
      eager launch of the kernels in ``holds`` ({name: (module, attr,
      hold)}, ``hold(args, kwargs, out)`` returning the max abs error
      against the plain version) captured and held; mid-serve, one
      replayed tick with every lane active and one with a lane free, each
      bit-equal to the same tick run eagerly from a clone of the same
      state (logits, sampled, lane_ok, every cache leaf and pos; a free
      lane's cache rows and pos as before the tick), then the state
      restored;
    * the same requests on the same engine with an eager tick installed
      (tokens equal: same shapes, same kernels) and again graph-ticked,
      each tick timed (host clock, synchronized before and after) and the
      allocator's count read around every replay (it must not move);
    * chunked admission (chunks of 128, 2 prefill lanes), its launches of
      the kernels in ``holds`` captured and held, and the wave engine at
      batch 1, compared with the whole-prompt tokens up to the
      reference's first top-2 margin within MARGIN_TOL or within the
      plan spread (``plan_spread``); the sharp check of chunked admission
      is ``admission_f32``.  Without ``compare`` this part and the plan
      spread are left out.  A vision model's chunked engine must raise
      (its prefix is not sliceable, as in the JAX package) and is not
      served; an audio model's prompts, tokens and margins carry the
      codebook axis (``token_tail``);
    * with ``chaos``, a seeded FaultPlan (poisoned lanes through the
      static poison buffer, a prefill fault, a slow burst, a flood,
      retry_budget 1).
    Returns the decode ms a tick eager and replayed, and the plan
    spread."""
    from repro_torch.models import registry
    from repro_torch.obs.metrics import Metrics
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.serving import (FINISH_REASONS, Engine, EngineConfig,
                                     FaultPlan, FinishReason)
    from repro_torch.serving.tick import DecodeTick
    from repro_torch import steps as steps_lib

    from repro_torch.kernels import flash_prefill as fp

    model = registry.build(cfg)
    reqs = reqs or slot_requests(cfg.vocab, token_tail(cfg))
    seq = max_seq or slot_seq(cfg)
    name = f"{phase} {cfg.name}"

    def pools_ok(eng, what):
        for pool in (eng.pool, eng._scratch_pool):
            check(pool.stats.buffers_built == pool.stats.capacity,
                  f"{name} {what}: a pool built {pool.stats.buffers_built} "
                  f"buffers for capacity {pool.stats.capacity}")

    # --- the graph-ticked whole-prompt serve, counted and checked ---------
    reset_counts(*counted)
    t0 = time.perf_counter()
    eng = slot_engine(model, params, max_seq=seq)
    build_s = time.perf_counter() - t0
    built = counts()
    tick = eng.ticks["decode/base"]
    check(tick.graph is not None, f"{name}: no CUDA graph")
    # the warmup tick and the capture each ran the wrappers once
    check(built == only(**{k: 2 * v for k, v in
                           tick.captured_launches.items()}),
          f"{name}: the warmup and the capture launched {built}, the "
          f"capture recorded {tick.captured_launches}")
    mgr = eng.manager
    calls = {k: [] for k in holds}

    def replay_vs_eager(active: np.ndarray) -> dict:
        """One replayed tick against the same tick run eagerly from a clone
        of the same state, then the state put back in place; the free
        lanes' cache rows and pos must be as before the tick."""
        slots, pos = tree_leaves(mgr.cache["slots"]), mgr.cache["pos"]
        free = [int(i) for i in np.flatnonzero(~active)]
        kept = [t.select(1, i).clone() for t in slots for i in free] + \
            [pos[i].clone() for i in free]
        live = [*tree_leaves(mgr.cache), mgr.tokens, mgr.active, mgr.poison]
        saved = [t.clone() for t in live]
        c_cache = tree_map(lambda t: t.clone(), mgr.cache)
        c_batch = {k: v.clone() for k, v in mgr.tick_batch().items()}
        g_out = [t.clone() for t in tick()]
        g_state = [t.clone() for t in live]
        after = [t.select(1, i) for t in slots for i in free] + \
            [pos[i] for i in free]
        before = {k: len(v) for k, v in calls.items()}
        e_out = DecodeTick(tick.fn, params, c_cache, c_batch, graph=False)()
        res = {"lanes": int(active.sum()),
               "eager_calls": {k: len(v) - before[k]
                               for k, v in calls.items()},
               "outputs": all(torch.equal(a, b)
                              for a, b in zip(g_out, e_out)),
               "state": all(torch.equal(a, b) for a, b in zip(
                   g_state, [*tree_leaves(c_cache), *c_batch.values()])),
               "free_kept": all(torch.equal(a, b)
                                for a, b in zip(kept, after))}
        for t, s in zip(live, saved):
            t.copy_(s)
        return res

    first = {"whole": {}, "chunked": {}}       # first-token logits
    margins = {"whole": {}, "chunked": {}}
    equal = {}
    reset_counts(*counted)
    with contextlib.ExitStack() as stack:
        stack.enter_context(tripwires(*arms))
        for k, (mod, attr, hold) in holds.items():
            stack.enter_context(capturing(mod, attr, calls[k], hold))
        stack.enter_context(watching(eng, first["whole"],
                                     margins["whole"]))
        for _ in eng.stream(reqs):
            active = mgr.active_mask()
            which = "all" if active.all() else "some"
            if which in equal or not active.any() \
                    or eng.metrics.counter("serving/ticks").value < 2:
                continue
            equal[which] = replay_vs_eager(active)
    served = eng.take_finished()
    whole = [served[r.uid] for r in reqs]
    got = counts()
    # first: a hold that failed inside the engine's containment
    whole_held = held(calls, got, f"{name} whole-prompt serve")
    ticks_1 = eng.metrics.counter("serving/ticks").value
    check(set(equal) == {"all", "some"} and all(
        e["outputs"] and e["state"] and e["free_kept"]
        for e in equal.values()),
          f"{name}: a replayed tick differs from the eager tick on the same "
          f"state, or a free lane moved: {equal}")
    tokens_ok(whole, cfg, f"{name} whole-prompt serve")
    check(cfg.dtype != "bfloat16"
          or fp.flash_prefill.tc_launches == got["flash_prefill"],
          f"{name}: {fp.flash_prefill.tc_launches} of "
          f"{got['flash_prefill']} K8 launches on the tensor-core instance")
    pools_ok(eng, "whole-prompt serve")
    mgr.check_resident()
    eager_calls = {k: sum(e["eager_calls"].get(k, 0) for e in equal.values())
                   for k in got}
    ref_calls = {k: v for k, v in eager_calls.items() if v}
    prefill_launches = {k: got[k] - eager_calls[k] for k in got if got[k]}
    check(all(v > 0 for v in tick.captured_launches.values())
          and any(v > 0 for v in prefill_launches.values()),
          f"{name}: serve launched {got}")
    del calls
    replayed = {k: v * ticks_1 for k, v in tick.captured_launches.items()}
    print(f"[{phase}] {cfg.name} slot engine ({N_SLOTS} slots x "
          f"{seq}, bf16), built and captured in {build_s:.1f} s: "
          f"launches captured a tick {tick.captured_launches or 'none'} "
          f"(counted at capture, "
          f"not at replay: x {ticks_1} ticks = {replayed or 'none'} "
          f"replayed), eager launches of the serve {prefill_launches}; a "
          f"replayed tick with all {equal['all']['lanes']} lanes active and "
          f"one with {equal['some']['lanes']} active each bit-equal to the "
          f"eager tick from a clone of its state (logits, sampled, lane_ok, "
          f"every cache leaf, pos and tokens), the free lanes' cache rows "
          f"and pos unmoved; eager launches (the reference ticks' "
          f"{ref_calls or 'none'} among them) held: {whole_held}; "
          f"buffers_built and "
          f"the scratch pool at capacity, no resident buffer rebound")
    spread = plan_spread(eng, reqs, first["whole"]) if compare else None

    # --- eager-ticked, then graph-ticked again, each tick timed -----------
    pl = eng.scheduler.plans["decode/base"]

    def timed_serve(tk, allocs=None):
        ms_full = []

        def timed_tick():
            full = sum(s.occupied and s.remaining > 0
                       for s in mgr.slots) == N_SLOTS
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
            t0_ = time.perf_counter()
            out = tk()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0_
            if allocs is not None:
                allocs.append(torch.cuda.memory_stats()[
                    "allocation.all.allocated"] - a0)
            if full:
                ms_full.append(dt * 1e3)
            return out

        pl.fn = timed_tick
        try:
            results = eng.serve(reqs)
        finally:
            pl.fn = tick
        return results, ms_full

    eager_tick = DecodeTick(tick.fn, params, mgr.cache, mgr.tick_batch(),
                            graph=False)
    eager, eager_ms = timed_serve(eager_tick)
    del eager_tick
    allocs = []
    eng.metrics = Metrics()           # TTFT and TBT of this serve alone
    n_decided = len(eng.scheduler.decisions)
    again, graph_ms_ = timed_serve(tick, allocs)
    check(all(np.array_equal(a.tokens, b.tokens) and
              np.array_equal(a.tokens, c.tokens)
              for a, b, c in zip(whole, eager, again)),
          f"{name}: graph-ticked and eager-ticked tokens differ")
    check(allocs and all(a == 0 for a in allocs),
          f"{name}: allocations across replayed ticks {sorted(set(allocs))}")
    pools_ok(eng, "second serve")
    snap = eng.metrics.snapshot()
    print(f"[{phase}] {cfg.name}: the eager-ticked serve's tokens equal the "
          f"graph-ticked serves' (all {16 * len(reqs)}); "
          f"allocation.all.allocated unmoved across each of {len(allocs)} "
          f"replayed ticks")

    # --- chunked admission; the wave engine at batch 1 --------------------
    if compare:
        compared = [("slot vs the wave engine at batch 1", None, None, whole)]
        if cfg.n_vis_tokens:
            try:
                slot_engine(model, params, 128)
                refused = ""
            except ValueError as err:
                refused = str(err)
            check("vis-token" in refused, f"{name}: a chunked vision engine "
                  f"was built, or refused otherwise: {refused!r}")
            print(f"[{phase}] {cfg.name}: the chunked engine (128) raises "
                  f"ValueError, as the JAX package's does: {refused}")
        else:
            ceng = slot_engine(model, params, 128)
            calls = {k: [] for k in holds}
            reset_counts(*counted)
            with contextlib.ExitStack() as stack:
                stack.enter_context(tripwires(*arms))
                for k, (mod, attr, hold) in holds.items():
                    stack.enter_context(capturing(mod, attr, calls[k], hold))
                stack.enter_context(watching(ceng, first["chunked"],
                                             margins["chunked"]))
                chunked = ceng.serve(reqs)
            c_got = {k: v for k, v in counts().items() if v}
            chunk_held = held(calls, c_got, f"{name} chunked serve")
            tokens_ok(chunked, cfg, f"{name} chunked serve")
            pools_ok(ceng, "chunked serve")
            del calls
            n_chunks = ceng.metrics.histogram("serving/prefill_chunk_s").count
            del ceng
            compared.insert(0, ("chunked vs whole-prompt", whole,
                                margins["whole"], chunked))
        wave = Engine(model, params, config=EngineConfig(
            n_slots=1, max_seq=slot_seq(cfg), pool_capacity=1))
        w_margins: dict = {}
        w_prefill, w_decode = wave._prefill, steps_lib.decode_step
        order = iter(r.uid for r in reqs)
        state = {"uid": None, "j": 0}

        def w_watched_prefill(p, c, b):
            logits, c = w_prefill(p, c, b)
            state["uid"], state["j"] = next(order), 0
            w_margins[state["uid"], 0] = top2_margins(logits[..., -1, :])[0]
            return logits, c

        def w_watched_decode(cfg_, p, c, b):
            logits, c = w_decode(cfg_, p, c, b)
            state["j"] += 1
            w_margins[state["uid"], state["j"]] = top2_margins(logits)[0]
            return logits, c

        wave._prefill, steps_lib.decode_step = w_watched_prefill, \
            w_watched_decode
        try:
            with tripwires(*arms):
                waved = wave.serve(reqs)
        finally:
            steps_lib.decode_step = w_decode
        del wave
        compared[-1] = (compared[-1][0], waved, w_margins, whole)
        for what, ref_run, ref_m, other in compared:
            stops = []
            for r, o in zip(ref_run, other):
                k, n = agreed(r.tokens, [ref_m[r.uid, j] for j in range(16)],
                              o.tokens, floor=spread)
                check(n >= k, f"{name} {what}: request {r.uid} differs at "
                      f"token {n}, before the reference's first low margin "
                      f"at {k}")
                stops.append(f"{r.uid}:{k}/{n}")
            print(f"[{phase}] {cfg.name} {what}: tokens equal up to the "
                  f"reference's first top-2 margin within max(MARGIN_TOL, the "
                  f"plan spread {spread:.3e}) (uid:margin stop/first "
                  f"difference, 16 = none) {' '.join(stops)}")
        if not cfg.n_vis_tokens:
            d_first = max(float((first["chunked"][r.uid]
                                 - first["whole"][r.uid]).abs().max())
                          for r in reqs)
            print(f"[{phase}] {cfg.name} chunked admission: {n_chunks} chunks "
                  f"(128 and powers of two) launched {c_got}; held: "
                  f"{chunk_held}; first-token logits differ from whole-prompt "
                  f"admission's by up to {d_first:.3e} (printed, not held: in "
                  f"bf16 the plan spread, one change of summation order, is "
                  f"{spread:.3e}; the f32 check of the same admission is "
                  f"admission_f32)")

    # --- S3. a seeded FaultPlan on this engine's shapes --------------------
    if chaos:
        plan_f = FaultPlan.seeded(0, n_slots=N_SLOTS, ticks=40,
                                  uids=tuple(r.uid for r in reqs),
                                  n_poison=2, n_prefill=1, n_slow_burst=1,
                                  slow_extra_s=0.01, n_flood=1, flood_n=2)
        feng = slot_engine(model, params, faults=plan_f, retry_budget=1)
        for ev in feng.stream(reqs):
            check(ev.finish_reason is None
                  or ev.finish_reason in FINISH_REASONS,
                  f"S3: event with reason {ev.finish_reason}")
        done = feng.take_finished()
        reasons = {}
        for r, w in zip(reqs, whole):
            res = done[r.uid]
            check(res.finish_reason in FINISH_REASONS,
                  f"S3: request {r.uid} ended {res.finish_reason}")
            reasons[res.finish_reason] = reasons.get(res.finish_reason, 0) + 1
            if res.finish_reason == FinishReason.LENGTH:
                check(np.array_equal(res.tokens, w.tokens),
                      f"S3: request {r.uid}'s tokens differ from the "
                      "fault-free run's")
        pools_ok(feng, "chaos serve")
        check(not feng.manager.poison.any(), "S3: poison buffer left set")
        m = feng.metrics.snapshot()["counters"]
        kinds = sorted({type(f).__name__ for f in plan_f.faults})
        print(f"[S3] {cfg.name} under FaultPlan.seeded(0) ({kinds}, "
              f"retry_budget 1): reasons {reasons}, quarantined "
              f"{m['serving/quarantined']}, retries {m['serving/retries']}, "
              f"deadline_miss {m['serving/deadline_miss']}, "
              f"{len(done) - len(reqs)} flood requests retired; every "
              "'length' request's tokens equal the fault-free run's; "
              "buffers_built at capacity; the poison buffer clear")
        del feng

    # --- S4. times -------------------------------------------------------
    e_ms, g_ms = statistics.median(eager_ms), statistics.median(graph_ms_)
    h = snap["histograms"]
    decisions = {}
    for d in list(eng.scheduler.decisions)[n_decided:]:
        decisions[d.plan] = decisions.get(d.plan, 0) + 1
    print(f"[S4] {cfg.name} decode, 4 slots all active: eager tick "
          f"{e_ms:.3f} ms ({len(eager_ms)} ticks, min {min(eager_ms):.3f}), "
          f"replayed CUDA graph {g_ms:.3f} ms ({len(graph_ms_)} ticks, min "
          f"{min(graph_ms_):.3f}), {e_ms / g_ms:.1f}x; "
          + (f"the wave engine (4 lanes, this run) "
             f"{', '.join(f'{w:.3f}' for w in wave_ms)} ms/token; "
             if wave_ms else "") + f"host clock "
          f"around one tick, synchronized before and after; {CARD['line']}")
    print(f"[S4] {cfg.name} graph-ticked serve: serving/ttft_s p50 "
          f"{h['serving/ttft_s']['p50'] * 1e3:.3f} ms p99 "
          f"{h['serving/ttft_s']['p99'] * 1e3:.3f} ms; serving/tbt_s p50 "
          f"{h['serving/tbt_s']['p50'] * 1e3:.3f} ms p99 "
          f"{h['serving/tbt_s']['p99'] * 1e3:.3f} ms (the timed serve; "
          f"TTFT from admission to the first token on the host, as the JAX "
          f"package measures it); "
          f"scheduler decisions {decisions}")
    tick_costs(phase, cfg, g_ms, seq)
    del eng
    torch.cuda.empty_cache()
    return {"eager_ms": e_ms, "graph_ms": g_ms, "spread": spread}


def tick_costs(phase: str, cfg, graph_ms: float, seq: int) -> None:
    """P1: ``analysis.analytic_costs`` of one decode tick of ``N_SLOTS``
    lanes over a cache of ``seq`` positions (the JAX package's model: every
    weight read once, the caches read, the activations) and its roofline
    on one card, beside the replayed tick measured at ``graph_ms``."""
    from repro_torch.analysis import Roofline, analytic_costs
    from repro_torch.configs.base import ShapeConfig

    costs = analytic_costs(cfg, ShapeConfig("tick", seq, N_SLOTS,
                                            "decode"))
    roof = Roofline(costs["flops"], costs["bytes"])
    least = max(roof.t_compute, roof.t_memory) * 1e3
    print(f"[P1] {phase} {cfg.name} decode tick of {N_SLOTS} lanes over "
          f"{seq} positions: analysis.analytic_costs "
          f"{costs['flops']:.4e} FLOPs, {costs['bytes']:.4e} bytes; "
          f"roofline {least:.4f} ms ({roof.dominant}; bf16 peak, 3.35 TB/s)"
          f"; replayed tick {graph_ms:.3f} ms, {graph_ms / least:.1f}x it; "
          f"{CARD['line']}")


#: the MoE phases: OLMoE-1B-7B's and the Jamba cut's serves take the slot
#: phases' 8 requests; Qwen3-30B-A3B one wave of 4 requests of 128 to 256
#: tokens, 8 new tokens each
QWEN3_LENS, QWEN3_NEW = (201, 128, 256, 177), 8
#: ``moe.apply_moe`` on the card against the same call on the CPU, both in
#: f32 with TF32 off: two summation orders of the same products
MOE_DEVICE_TOL = dict(rtol=1e-5, atol=1e-5)


def free_models(what: str) -> None:
    """Collect what the earlier phases dropped and give the cached blocks
    back, then print what stays allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[{what}] earlier models freed: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")


def peak_memory(phase: str) -> None:
    print(f"[{phase}] peak memory (torch.cuda.max_memory_allocated) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; {CARD['line']}")


def kernel_counts(cfg) -> tuple[dict, dict]:
    """(a prefill's launches, a decode step's): one K8 an attention layer
    a prefill, one K9 an attention layer a decode step, one K7 a Mamba
    layer in both."""
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    n_ssm = cfg.n_layers - n_attn
    prefill = {"flash_prefill": n_attn, "mamba_scan": n_ssm}
    step = {"decode_attn": n_attn, "mamba_scan": n_ssm}
    return ({k: v for k, v in prefill.items() if v},
            {k: v for k, v in step.items() if v})


def wave_serve(phase: str, engine, reqs, counted, counts, only, holds: dict,
               arms) -> tuple[list[dict], dict]:
    """``reqs`` through ``launch/serve.serve`` on the wave engine
    ``engine``, counted, the plain versions in ``arms`` armed to raise,
    every launch of the kernels in ``holds`` captured and then held
    against its plain version on its own inputs (``kernel_holds``): each
    prefill and each decode step must launch ``kernel_counts``' kernels, a
    bf16 model's K8 launches all on the tensor-core instance, every logit
    finite, every token in the vocabulary, the pool at capacity.  Then
    the same requests again, nothing captured: the same launches and
    tokens.  Returns that serve's waves (prefill ms, decode ms/token, host
    clock) and the launches counted."""
    from repro_torch import steps as steps_lib
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.launch import serve as serve_lm

    cfg = engine.cfg
    name = f"{phase} {cfg.name}"
    new = reqs[0].max_new_tokens
    per_prefill, per_step = kernel_counts(cfg)
    calls = {k: [] for k in holds}
    seen = {"prefill": [], "decode": [], "finite": True}
    prefill, decode = engine._prefill, steps_lib.decode_step

    def launched(fn, *args):
        before = counts()
        logits, c = fn(*args)
        after = counts()
        seen["finite"] &= bool(torch.isfinite(logits).all())
        return logits, c, {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}

    def watched_prefill(p, c, b):
        logits, c, n = launched(prefill, p, c, b)
        seen["prefill"].append(n)
        return logits, c

    def watched_decode(cfg_, p, c, b):
        logits, c, n = launched(decode, cfg_, p, c, b)
        seen["decode"].append(n)
        return logits, c

    reset_counts(*counted)
    engine._prefill, steps_lib.decode_step = watched_prefill, watched_decode
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(tripwires(*arms))
            for k, (mod, attr, hold) in holds.items():
                stack.enter_context(capturing(mod, attr, calls[k], hold))
            served = serve_lm.serve(engine, reqs)
    finally:
        engine._prefill, steps_lib.decode_step = prefill, decode
    got = counts()
    n_waves = -(-len(reqs) // engine.batch_size)
    n_tc = fp.flash_prefill.tc_launches
    step_counts = sorted({tuple(sorted(d.items())) for d in seen["decode"]})
    check(seen["prefill"] == [per_prefill] * n_waves
          and seen["decode"] == [per_step] * (n_waves * new)
          and got == only(**{k: n_waves * per_prefill.get(k, 0)
                             + n_waves * new * per_step.get(k, 0)
                             for k in {*per_prefill, *per_step}}),
          f"{name} wave serve launched {got}; per prefill "
          f"{seen['prefill']}, per decode step {step_counts}")
    check(cfg.dtype != "bfloat16" or n_tc == got["flash_prefill"],
          f"{name}: {n_tc} of {got['flash_prefill']} K8 launches on the "
          "tensor-core instance")
    shape = token_tail(cfg) + (new,)
    check(all(r.tokens.shape == shape and int(r.tokens.min()) >= 0
              and int(r.tokens.max()) < cfg.vocab
              for r in served["results"]),
          f"{name}: served tokens outside [0, vocab) or not {shape} a "
          "request")
    check(seen["finite"], f"{name}: a served logit is not finite")
    check(served["pool"].buffers_built == served["pool"].capacity,
          f"{name}: the pool built {served['pool'].buffers_built} buffers")
    holds_said = held(calls, got, f"{name} wave serve")
    del calls
    print(f"[{phase}] {cfg.name} wave engine through launch/serve "
          f"({len(reqs)} requests, {new} new tokens, waves of "
          f"{engine.batch_size}): launches "
          f"{ {k: v for k, v in got.items() if v} }, {per_prefill} a prefill "
          f"and {per_step} a decode step, {n_tc} "
          f"K8 on the tensor-core instance; no plain version reached; every "
          f"logit finite; buffers_built = capacity; {holds_said}")
    reset_counts(*counted)
    with tripwires(*arms):
        timed = serve_lm.serve(engine, reqs)
    check(counts() == got, f"{name}: the second serve launched {counts()}")
    check(all(np.array_equal(a.tokens, b.tokens) for a, b in zip(
        timed["results"], served["results"])),
          f"{name}: the second serve's tokens differ from the first's")
    for i, w in enumerate(timed["waves"]):
        print(f"[time] {name} wave {i}: prefill {w['prefill_ms']:.3f} ms, "
              f"decode {w['decode_ms_per_token']:.3f} ms/token (host clock; "
              f"the captured serve's {served['waves'][i]['prefill_ms']:.3f} "
              f"and {served['waves'][i]['decode_ms_per_token']:.3f}); "
              f"{CARD['line']}")
    return timed["waves"], got


def weight_bytes(params: dict) -> int:
    """The bytes a decode step reads of ``params``: every leaf but the
    embedding table (of which it gathers a row a lane)."""
    from repro_torch.optim.adamw import tree_leaves

    return sum(t.numel() * t.element_size() for k, v in params.items()
               if k != "embed" for t in tree_leaves(v))


def moe_tick_share(phase: str, cfg, params, device, graph_tick_ms: float
                   ) -> None:
    """The MoE layers' share of a replayed decode tick of ``N_SLOTS``
    lanes, two ways: one MoE layer's drop-free dispatch at T = N_SLOTS in
    a CUDA graph (device time alone) times the MoE layers; and CUDA events
    around every ``apply_moe`` of one eager decode step, each started
    after a synchronize (its own work and its launch gaps).  Beside them
    the replayed tick and the bound of reading every weight once, the
    experts' and the rest's (under no_drop every expert's products run
    over its C = T rows, so a step reads every expert)."""
    from repro_torch.analysis import HBM_BYTES_PER_S
    from repro_torch.models import moe, registry

    model = registry.build(cfg)
    moe_slots = [s for s in range(cfg.period) if cfg.layer_is_moe(s)]
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    layer = {k: v[0] for k, v in params["blocks"][moe_slots[0]]["mlp"]
             .items()}
    gen = torch.Generator().manual_seed(26)
    x = randn(N_SLOTS, cfg.d_model, gen=gen).to(getattr(torch, cfg.dtype))
    one_ms = graph_ms(lambda: moe.apply_moe(layer, x, cfg, no_drop=True))
    cache = model.init_cache(N_SLOTS, SLOT_SEQ, device, per_lane_pos=True)
    batch = {"tokens": torch.zeros(N_SLOTS, dtype=torch.int32,
                                   device=device),
             "active": torch.ones(N_SLOTS, dtype=torch.bool, device=device)}
    spans, inner = [], moe.apply_moe

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    steps_ms, moe_ms = [], []
    moe.apply_moe = timed
    try:
        with torch.no_grad():
            for _ in range(4):
                spans.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.decode_step(params, cache, batch)
                torch.cuda.synchronize()
                steps_ms.append((time.perf_counter() - t0) * 1e3)
                moe_ms.append(sum(s.elapsed_time(e) for s, e in spans))
    finally:
        moe.apply_moe = inner
    check(len(spans) == n_moe, f"{phase}: {len(spans)} MoE layers timed, "
          f"the config has {n_moe}")
    expert = sum(t.numel() * t.element_size() for s in moe_slots
                 for k, t in params["blocks"][s]["mlp"].items()
                 if k != "router")
    total = weight_bytes(params)
    bound_ms = total / HBM_BYTES_PER_S * 1e3
    e_moe, e_step = statistics.median(moe_ms[1:]), statistics.median(
        steps_ms[1:])
    print(f"[time] {phase} {cfg.name} MoE share of a decode tick of "
          f"{N_SLOTS} lanes: one MoE layer (T={N_SLOTS}, drop-free, "
          f"{cfg.moe.n_experts} experts) {one_ms:.4f} ms in a CUDA graph, "
          f"x {n_moe} layers = {n_moe * one_ms:.3f} ms = "
          f"{100 * n_moe * one_ms / graph_tick_ms:.1f}% of the replayed tick "
          f"{graph_tick_ms:.3f} ms; eager decode step {e_step:.3f} ms (host "
          f"clock, synchronized), of it {e_moe:.3f} ms "
          f"({100 * e_moe / e_step:.1f}%) inside apply_moe (CUDA events, a "
          f"synchronize before each); "
          f"weights read a step {total / 1e9:.2f} GB ({expert / 1e9:.2f} GB "
          f"of experts), bound {bound_ms:.3f} ms at 3.35 TB/s, replayed tick "
          f"at {graph_tick_ms / bound_ms:.2f}x it; {CARD['line']}")
    del cache


def moe_f32_phase(device, counted, counts, only, arms) -> None:
    """X1: OLMoE-1B-7B at full width, 2 of 16 layers, in f32: prefill + 4
    decode steps against ``forward(inference=True)`` at CONSISTENCY_TOL
    with one K8 an attention layer a prefill and one K9 a decode step;
    chunked admission against whole-prompt (``admission_f32``);
    ``moe.apply_moe`` on the card against the same call on the CPU (the
    routing identical, the output and aux at MOE_DEVICE_TOL), drop-free
    and at capacity factor 0.5, at T = 4 and 256: the cumsum, scatter and
    gather on CUDA."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe, registry
    from repro_torch.optim.adamw import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b"), n_layers=2,
                              dtype="float32")
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    accounting("X1", cfg, n_params)
    L, B, S, K = cfg.n_layers, 2, 128, 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S + K)).astype(np.int32)).to(device)
    with torch.no_grad(), tripwires(*arms):
        reset_counts(*counted)
        full, aux = model.forward(params, {"tokens": toks}, inference=True)
        n_fwd = counts()
        cache = model.init_cache(B, S + K, device)
        reset_counts(*counted)
        logits, cache = model.prefill(params, cache, {"tokens": toks[:, :S]})
        n_pre = counts()
        err = close(logits[:, 0], full[:, S - 1], "X1 prefill vs forward",
                    CONSISTENCY_TOL)
        n_dec = []
        for t in range(S, S + K):
            reset_counts(*counted)
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": toks[:, t]})
            n_dec.append(counts())
            err = max(err, close(logits, full[:, t],
                                 f"X1 decode step at {t} vs forward",
                                 CONSISTENCY_TOL))
    check(n_fwd == only(flash_prefill=L) and n_pre == only(flash_prefill=L)
          and all(n == only(decode_attn=L) for n in n_dec),
          f"X1 launched forward {n_fwd}, prefill {n_pre}, decode {n_dec}")
    check(float(aux["moe_drop_frac"]) == 0.0,
          f"X1: drop-free forward dropped {float(aux['moe_drop_frac'])}")
    print(f"[X1] {cfg.name} at full width, {L} of 16 layers, f32, "
          f"{n_params / 1e9:.3f} B parameters: prefill {S} + {K} decode "
          f"steps vs forward(inference=True) max abs err {err:.3e} "
          f"({CONSISTENCY_TOL}); launches: forward {n_fwd['flash_prefill']} "
          f"K8, prefill {n_pre['flash_prefill']} K8, each decode step "
          f"{n_dec[0]['decode_attn']} K9 (one an attention layer); no plain "
          f"attention reached; aux "
          f"{ {k: round(float(v), 6) for k, v in aux.items()} }")
    del full, cache, logits
    admission_f32("X1", model, params, arms, counted, counts)

    layer = {k: v[0] for k, v in params["blocks"][0]["mlp"].items()}
    on_cpu = {k: v.cpu() for k, v in layer.items()}
    gen = torch.Generator().manual_seed(261)
    x = randn(256, cfg.d_model, gen=gen)
    tight = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    said = []
    for label, c, no_drop in (("drop-free", cfg, True),
                              ("capacity factor 0.5", tight, False)):
        for T in (N_SLOTS, 256):
            xs = x[:T]
            out, aux_d = moe.apply_moe(layer, xs, c, no_drop=no_drop)
            want, aux_h = moe.apply_moe(on_cpu, xs.cpu(), c, no_drop=no_drop)
            e_d = moe.route(layer["router"], xs, c)[3].cpu()
            e_h = moe.route(on_cpu["router"], xs.cpu(), c)[3]
            check(torch.equal(e_d, e_h), f"X1 apply_moe {label} T={T}: "
                  f"the card routes {int((e_d != e_h).any(1).sum())} tokens "
                  "to other experts than the CPU")
            e = close(out.cpu(), want, f"X1 apply_moe {label} T={T}",
                      MOE_DEVICE_TOL)
            for k in aux_h:
                close(aux_d[k].cpu(), aux_h[k], f"X1 {label} T={T} {k}",
                      MOE_DEVICE_TOL)
            said.append(f"{label} T={T}: drop share "
                        f"{float(aux_d['moe_drop_frac']):.4f}, out max abs "
                        f"err {e:.3e}")
    print(f"[X1] moe.apply_moe on the card vs on the CPU, layer 0 of the "
          f"model above ({cfg.moe.n_experts} experts, top-{cfg.moe.top_k}): "
          f"routing identical for every token, aux and outputs within "
          f"{MOE_DEVICE_TOL}: {'; '.join(said)}")
    del params, layer, on_cpu
    peak_memory("X1")


def moe_serve_phase(phase: str, cfg, device, counted, counts, only, arms,
                    holds: dict, vs_forward: bool = False) -> None:
    """X2 and X3: ``cfg`` at full width in bf16 through the wave engine
    (``wave_serve``: the 8 requests of ``slot_requests``, every K7/K8/K9
    launch held against plain) and the slot engine (``slot_slice``: whole
    and chunked admission, a replayed tick bit-equal to the eager one
    with all lanes active and with one free, allocations unmoved, the
    seeded FaultPlan, every eager launch held), then the MoE layers' share
    of the tick (``moe_tick_share``); with ``vs_forward`` the first-token
    logits of prefill + 4 decode steps against ``forward(inference=True)``,
    printed beside the plan spread."""
    from repro_torch.launch import serve as serve_lm
    from repro_torch.optim.adamw import tree_leaves

    free_models(phase)
    t0 = time.perf_counter()
    engine = serve_lm.build_engine(cfg, device, seed=0, batch_size=N_SLOTS,
                                   max_seq=SLOT_SEQ, engine="wave")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(engine.params))
    accounting(phase, cfg, n_params)
    print(f"[{phase}] {cfg.name}: {cfg.n_layers} x {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} of {cfg.moe.d_ff}, {n_params / 1e9:.3f} B "
          f"parameters in {cfg.dtype}, drawn from seed 0 on the card in "
          f"{time.perf_counter() - t0:.1f} s; peak memory of the draw "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    waves, _ = wave_serve(phase, engine, slot_requests(cfg.vocab), counted,
                          counts, only, holds, arms)
    res = slot_slice(phase, cfg, engine.params, counted, counts, only, holds,
                     arms, [w["decode_ms_per_token"] for w in waves],
                     chaos=True)
    moe_tick_share(phase, cfg, engine.params, device, res["graph_ms"])
    if vs_forward:
        from repro_torch.models import registry

        model = registry.build(cfg)
        S, K = 64, 4
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab, (2, S + K)).astype(np.int32)).to(device)
        with torch.no_grad(), tripwires(*arms):
            full, _ = model.forward(engine.params, {"tokens": toks},
                                    inference=True)
            cache = model.init_cache(2, S + K, device)
            logits, cache = model.prefill(engine.params, cache,
                                          {"tokens": toks[:, :S]})
            diffs = [float((logits[:, 0] - full[:, S - 1]).abs().max())]
            for t in range(S, S + K):
                logits, cache = model.decode_step(engine.params, cache,
                                                  {"tokens": toks[:, t]})
                diffs.append(float((logits - full[:, t]).abs().max()))
        print(f"[{phase}] {cfg.name} bf16, prefill {S} + {K} decode steps vs "
              f"forward(inference=True), max abs diff of the logits at each "
              f"position {', '.join(f'{d:.3e}' for d in diffs)} (printed, "
              f"not held: bf16 over {cfg.n_layers} random layers; the plan "
              f"spread of the slot phase, one change of summation order, is "
              f"{res['spread']:.3e})")
        del full, cache, logits
    del engine
    peak_memory(phase)


def moe_slice(device, counted, counts, only) -> None:
    """The MoE phases: X1 OLMoE-1B-7B in f32 at 2 layers
    (``moe_f32_phase``); X2 OLMoE-1B-7B in bf16 at full width
    (``SERVE_LAYERS`` depth) and
    X3 the Jamba hybrid cut to one period at 8 experts
    (``jamba_1_5_large_398b.ONE_PERIOD_8_EXPERTS``: attention, Mamba and
    MoE in one model, one cache and one captured tick) through both
    engines (``moe_serve_phase``); X4 Qwen3-30B-A3B in bf16 at full width
    (``SERVE_LAYERS`` depth) through the wave engine, one wave; X5 OLMoE-1B-7B at full
    width, 4 of its 16 layers, trained in bf16 at its capacity factor for
    8 steps (``attention_train_run``, with the router metrics of each
    step).  The plain attention and scan versions are armed to raise
    throughout; each phase prints its peak memory."""
    from repro_torch.analysis import HBM_BYTES_PER_S
    from repro_torch.configs import get_arch
    from repro_torch.configs import jamba_1_5_large_398b as jamba
    from repro_torch.launch import serve as serve_lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serving import Request

    arms = plain_attention_arms() + plain_scan_arms()
    holds = kernel_holds()
    attn = {k: holds[k] for k in ("flash_prefill", "decode_attn")}
    free_models("X1")
    moe_f32_phase(device, counted, counts, only, arms)
    moe_serve_phase("X2", dataclasses.replace(
        get_arch("olmoe-1b-7b"), n_layers=SERVE_LAYERS["olmoe-1b-7b"]),
        device, counted, counts, only, arms, attn)
    moe_serve_phase("X3", jamba.ONE_PERIOD_8_EXPERTS, device, counted,
                    counts, only, arms, holds, vs_forward=True)

    free_models("X4")
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b"),
                              n_layers=SERVE_LAYERS["qwen3-moe-30b-a3b"])
    t0 = time.perf_counter()
    engine = serve_lm.build_engine(cfg, device, seed=0, batch_size=N_SLOTS,
                                   max_seq=max(QWEN3_LENS) + QWEN3_NEW + 1,
                                   engine="wave")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(engine.params))
    accounting("X4", cfg, n_params)
    print(f"[X4] {cfg.name}: {cfg.n_layers} x {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} of {cfg.moe.d_ff}, {n_params / 1e9:.3f} B "
          f"parameters in {cfg.dtype}, drawn from seed 0 on the card in "
          f"{time.perf_counter() - t0:.1f} s; peak memory of the draw "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    prng = np.random.default_rng(0)
    reqs = [Request(i, prng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                    max_new_tokens=QWEN3_NEW)
            for i, n in enumerate(QWEN3_LENS)]
    wave_serve("X4", engine, reqs, counted, counts, only, attn, arms)
    print(f"[time] X4 {cfg.name}: weights read a decode step "
          f"{weight_bytes(engine.params) / 1e9:.2f} GB, bound "
          f"{weight_bytes(engine.params) / HBM_BYTES_PER_S * 1e3:.3f} ms at "
          f"3.35 TB/s")
    del engine
    peak_memory("X4")

    # --- X5. OLMoE-1B-7B trained: full width, 4 of its 16 layers ---------
    # the full depth (6.92 B parameters, ~83 GB with AdamW's f32 moments)
    # does not fit the card
    free_models("X5")
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b"), n_layers=4)
    run = attention_train_run("X5", cfg, 8, counted, counts, only, arms, {})
    for h in run["report"]["history"]:
        print(f"[X5] step {h['step']}: loss {h['loss']:.4f}, xent "
              f"{h['xent']:.4f}, moe_load_balance {h['moe_load_balance']:.4f},"
              f" moe_z_loss {h['moe_z_loss']:.4f}, moe_drop_frac "
              f"{h['moe_drop_frac']:.4f} (capacity factor "
              f"{cfg.moe.capacity_factor})")
    peak_memory("X5")


def model_f32_phase(phase: str, name: str, device, counted, counts,
                    only) -> None:
    """V1, U1 and A3's LayerNorm archs: ``name`` at full width, 2 layers,
    in f32, B=2: 500 positions (InternVL2-1B: drawn patch embeddings for
    its 256-token prefix, then 244 text tokens; MusicGen-large: 4
    codebooks; a text model: 500 tokens) then 4
    decode steps, through K8 and K9 and again through the plain plans
    (``blocked``, ``einsum``): the kernels' forward and each step's logits
    against the plain plans' at 2e-4; prefill + decode against
    ``forward(inference=True)`` at CONSISTENCY_TOL; one K8 a layer a
    forward or prefill and one K9 a decode step, none on the tensor
    cores; every K8 and K9 launch held against its plain version on its
    own inputs at 2e-4; the plain attention armed to raise.  For audio,
    chunked admission against whole-prompt admission (``admission_f32``,
    (4, S) prompts sliced on every codebook alike)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import attention, registry
    from repro_torch.optim.adamw import tree_leaves

    free_models(phase)
    arms = plain_attention_arms()
    f32_tol = dict(rtol=2e-4, atol=2e-4)
    holds = {k: v for k, v in kernel_holds(f32_tol).items()
             if k in ("flash_prefill", "decode_attn")}
    cfg = dataclasses.replace(get_arch(name), n_layers=2, dtype="float32")
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    accounting(phase, cfg, n_params)
    L, B, K, off = cfg.n_layers, 2, 4, cfg.n_vis_tokens
    S = 500 - off
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B,) + token_tail(cfg) + (S + K,)).astype(
            np.int32)).to(device)
    extra = {}
    if off:
        extra["vis_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, off, cfg.vis_dim)).astype(np.float32)).to(device)

    def at(full, i):
        """The forward's logits of text position i (every codebook)."""
        return full[:, :, i] if cfg.n_codebooks else full[:, off + i]

    tc = []                         # K8 launches on the tensor cores

    def run(prefill_plan: str, decode_plan: str):
        old = attention.PREFILL_PLAN, attention.DECODE_PLAN
        attention.PREFILL_PLAN, attention.DECODE_PLAN = (prefill_plan,
                                                         decode_plan)
        try:
            with torch.no_grad():
                reset_counts(*counted)
                full, _ = model.forward(params, {"tokens": toks, **extra},
                                        inference=True)
                n = [counts()]
                tc.append(fp.flash_prefill.tc_launches)
                cache = model.init_cache(B, off + S + K, device=device)
                reset_counts(*counted)
                first, cache = model.prefill(
                    params, cache, {"tokens": toks[..., :S], **extra})
                n.append(counts())
                tc.append(fp.flash_prefill.tc_launches)
                outs = [first[..., 0, :]]
                for t in range(K):
                    reset_counts(*counted)
                    logits, cache = model.decode_step(
                        params, cache, {"tokens": toks[..., S + t]})
                    n.append(counts())
                    outs.append(logits)
            torch.cuda.synchronize()
        finally:
            attention.PREFILL_PLAN, attention.DECODE_PLAN = old
        return full, outs, n

    calls = {k: [] for k in holds}
    with contextlib.ExitStack() as stack:
        stack.enter_context(tripwires(*arms[:2], *arms[4:]))
        for k, (mod, attr, hold) in holds.items():
            stack.enter_context(capturing(mod, attr, calls[k], hold))
        full, outs, n_k = run("flash_prefill", "decode_attn")
    check(n_k[:2] == [only(flash_prefill=L)] * 2
          and n_k[2:] == [only(decode_attn=L)] * K and tc == [0, 0],
          f"{phase} f32 launches (forward, prefill, decode steps): {n_k}, "
          f"{tc} of the forward's and prefill's K8 on the tensor cores")
    launched = {k: sum(n[k] for n in n_k) for k in holds}
    said = held(calls, launched, f"{phase} f32")
    del calls
    e2 = max(close(o, at(full, S - 1 + t), f"{phase} f32 step {t} vs forward",
                   CONSISTENCY_TOL) for t, o in enumerate(outs))
    plain_full, plain_outs, n_p = run("blocked", "einsum")
    check(all(n == only() for n in n_p), f"plain plans launched {n_p}")
    e1 = close(full, plain_full, f"{phase} f32 forward, flash_prefill vs "
               "blocked", f32_tol)
    e1d = max(close(a, b, f"{phase} f32 step {t}, kernels vs blocked/einsum",
                    f32_tol) for t, (a, b) in enumerate(zip(outs,
                                                            plain_outs)))
    front = (f"{off} drawn patch embeddings of {cfg.vis_dim} projected "
             f"ahead of {S} text tokens" if off else
             f"{cfg.n_codebooks} codebooks of {S} tokens"
             if cfg.n_codebooks else f"{S} tokens")
    print(f"[{phase}] {cfg.name} at full width, {L} of "
          f"{get_arch(name).n_layers} layers, f32 ({n_params / 1e9:.3f} B "
          f"parameters), B={B}, {front}: forward logits {tuple(full.shape)} "
          f"flash_prefill vs blocked max abs err {e1:.3e}, prefill + {K} "
          f"decode steps (tokens {tuple(toks[..., 0].shape)} a step) through "
          f"K8/K9 vs blocked/einsum {e1d:.3e} (2e-4); vs the forward: "
          f"{e2:.3e} ({CONSISTENCY_TOL}); {L} K8 launches a forward or "
          f"prefill, {L} K9 a decode step, none on the tensor cores; no "
          f"plain attention reached; {said} (2e-4)")
    del full, outs, plain_full, plain_outs
    if cfg.n_codebooks:
        admission_f32(phase, model, params, arms, counted, counts)
    del params, model
    peak_memory(phase)


def model_serve_phase(phase: str, cfg, device, counted, counts, only,
                      chaos: bool, compare: bool = True) -> dict:
    """V2, U2 and A4's LayerNorm archs: ``cfg`` at full width in bf16
    served through ``launch/serve``'s wave engine (``wave_serve``: the 8
    requests of ``slot_requests``, as (K, S) codebook prompts for audio
    and behind the zero patch embeddings of the vision prefix, waves of
    4; every K8 on the tensor cores and every K8/K9 launch held against
    its plain version) and the slot engine (``slot_slice``: whole-prompt admission,
    for audio chunked too and with ``chaos`` the seeded FaultPlan, for
    vision the chunked engine refused; a replayed tick bit-equal to the
    eager one; without ``compare`` neither chunked admission nor the
    comparisons with the wave engine at batch 1), the plain attention
    armed to raise.  Returns the wave serve's launches."""
    from repro_torch.analysis import HBM_BYTES_PER_S
    from repro_torch.launch import serve as serve_lm
    from repro_torch.optim.adamw import tree_leaves

    free_models(phase)
    arms = plain_attention_arms()
    holds = {k: v for k, v in kernel_holds().items()
             if k in ("flash_prefill", "decode_attn")}
    t0 = time.perf_counter()
    engine = serve_lm.build_engine(cfg, device, seed=0, batch_size=N_SLOTS,
                                   max_seq=slot_seq(cfg), engine="wave")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(engine.params))
    accounting(phase, cfg, n_params)
    front = (f"a {cfg.n_vis_tokens}-token vision prefix (zero patch "
             f"embeddings of {cfg.vis_dim}) ahead of each prompt"
             if cfg.n_vis_tokens else
             f"{cfg.n_codebooks} codebooks a step" if cfg.n_codebooks
             else f"{cfg.norm} norms")
    print(f"[{phase}] {cfg.name}: {cfg.n_layers} x {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"{front}, {n_params / 1e9:.3f} B parameters in {cfg.dtype}, drawn "
          f"from seed 0 on the card in {time.perf_counter() - t0:.1f} s; "
          f"cache {N_SLOTS} x {slot_seq(cfg)} positions")
    waves, got = wave_serve(phase, engine,
                            slot_requests(cfg.vocab, token_tail(cfg)),
                            counted, counts, only, holds, arms)
    slot_slice(phase, cfg, engine.params, counted, counts, only, holds, arms,
               [w["decode_ms_per_token"] for w in waves], chaos=chaos,
               compare=compare)
    print(f"[time] {phase} {cfg.name}: weights read a decode step "
          f"{weight_bytes(engine.params) / 1e9:.2f} GB, bound "
          f"{weight_bytes(engine.params) / HBM_BYTES_PER_S * 1e3:.3f} ms at "
          f"3.35 TB/s")
    del engine
    peak_memory(phase)
    return got


def make_batch_lm(cfg):
    """A stand-in for ``launch/train``'s ``SyntheticLM``, whose text-only
    batches the fronts cannot take (in both packages): built as it is,
    from the vocab and the seed, its ``batches(batch, seq)`` yields the
    port's ``registry.make_batch`` batches of ``cfg`` as numpy arrays,
    drawn on the host from seed + 1 ((B, K, seq) codebook ids for audio;
    seq - n_vis text ids beside n_vis patch embeddings for vision, held
    in f32, which ``embed_inputs`` casts back to bf16 exactly; the
    ``labels`` ride along unused, as in the JAX package)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import registry

    class MakeBatchLM:
        def __init__(self, vocab: int, seed: int = 0):
            self.gen = torch.Generator().manual_seed(seed + 1)

        def batches(self, batch: int, seq: int):
            shape = ShapeConfig("fronts", seq, batch, "train")
            while True:
                yield {k: (v.float() if v.is_floating_point() else v).numpy()
                       for k, v in registry.make_batch(cfg, shape,
                                                       self.gen).items()}

    return MakeBatchLM


def fronts_slice(device, counted, counts, only) -> dict:
    """The vision and audio fronts, each model freed before the next and
    each phase's peak memory printed: V1 InternVL2-1B and U1 MusicGen-large
    at full width, 2 layers, in f32 (``model_f32_phase``); V2
    InternVL2-1B and U2 MusicGen-large at full width and ``SERVE_LAYERS``
    depth in bf16 through both engines (``model_serve_phase``; U2 also
    under the seeded FaultPlan); V3 and U3 the same two trained at full
    width and depth in
    bf16 for 8 steps of batch 4 x 512 positions (``attention_train_run``,
    through ``launch/train.train`` with ``make_batch_lm`` in place of the
    text pipeline: two K8t and one K8b an attention layer a step, step 1's
    K8b calls held against plain, every K8b on the tensor cores).  Returns
    the served and trained launches of K8, K9, K8t and K8b, to add to the
    ``kernels`` line."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train as train_lm
    from repro_torch.models import registry

    launches = {"flash_prefill": 0, "decode_attn": 0,
                "flash_prefill_traj": 0, "flash_prefill_bwd": 0}
    arms = plain_attention_arms() + plain_scan_arms()
    for f32_phase, serve_phase, train_phase, name in (
            ("V1", "V2", "V3", "internvl2-1b"),
            ("U1", "U2", "U3", "musicgen-large")):
        model_f32_phase(f32_phase, name, device, counted, counts, only)
        cfg = get_arch(name)
        got = model_serve_phase(serve_phase, dataclasses.replace(
            cfg, n_layers=SERVE_LAYERS[name]), device, counted, counts,
            only, chaos=bool(cfg.n_codebooks))
        free_models(train_phase)
        specs = registry.input_specs(cfg, ShapeConfig("fronts", 512, 4,
                                                      "train"))
        print(f"[{train_phase}] {cfg.name} trained on registry.make_batch "
              f"batches: " + ", ".join(f"{k} {tuple(s.shape)} {s.dtype}"
                                       for k, s in specs.items()))
        text_lm = train_lm.SyntheticLM
        train_lm.SyntheticLM = make_batch_lm(cfg)
        try:
            run = attention_train_run(train_phase, cfg, 8, counted, counts,
                                      only, arms, {})
        finally:
            train_lm.SyntheticLM = text_lm
        peak_memory(train_phase)
        for k in launches:
            launches[k] += got.get(k, 0) + run["launches"].get(k, 0)
    return launches


def ring_requests(vocab: int) -> list:
    """L1's slot serve: ``RING_LENS`` prompts drawn from seed 0, 16 new
    tokens each."""
    from repro_torch.serving import Request

    prng = np.random.default_rng(0)
    return [Request(i, prng.integers(0, vocab, (n,)).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate(RING_LENS)]


def layouts_slice(device, counted, counts, only) -> None:
    """The JAX package's two other cache layouts, each model freed before
    the next and each phase's peak memory printed.

    * L1, the long-context ring: ``config_for_shape(qwen2-0.5b,
      long_500k)`` (a ring of ``RING_WINDOW`` slots), full width and
      depth, B=1.  In f32 a ``RING_PROMPT``-token prompt prefilled (one
      windowed K8 a layer), then ``RING_STEPS`` decode steps on the ring
      (JAX's grouped einsums: no launch), the prefill's and every step's
      logits held against ``forward(inference=True)`` over the whole
      sequence under the same window at CONSISTENCY_TOL.  In bf16 the
      slot engine over 4 lanes of the ring (``slot_slice``: whole-prompt
      admission of ``RING_LENS`` prompts; a replayed tick, the ring
      wrapping inside it, bit-equal to the eager one; ``buffers_built``
      at capacity).
    * Q1, the int8 cache: Yi-9B at full width, ``SERVE_LAYERS`` depth, in
      bf16, ``kv_quant`` against the full bf16 cache on the same
      parameters, the JAX package's tests/test_kv_quant.py at full width:
      2 rows, a 16-token prefill and 4 decode steps, each step within 8%
      of the full cache's logits' scale and its greedy argmax identical
      under the seeded 0.4 margin; ``analysis.cache_bytes`` under 0.6x;
      then the slot engine over the int8 cache (``slot_slice``).
    The plain K8 and K9 are armed to raise throughout; the ring and int8
    decodes run JAX's grouped einsums, as the JAX package does."""
    from repro_torch import analysis
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import registry
    from repro_torch.optim.adamw import tree_leaves

    arms = plain_attention_arms()
    kernels_armed = (*arms[:2], *arms[4:])   # not the einsums the layouts run
    holds = {k: v for k, v in kernel_holds().items()
             if k in ("flash_prefill", "decode_attn")}

    # --- L1. the ring, f32: prefill past the window, then decode ----------
    free_models("L1")
    cfg = dataclasses.replace(registry.config_for_shape(
        get_arch("qwen2-0.5b"), INPUT_SHAPES["long_500k"]), dtype="float32")
    check(cfg.sliding_window == registry.LONG_CONTEXT_WINDOW == RING_WINDOW,
          f"L1: config_for_shape gave a window of {cfg.sliding_window}")
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    accounting("L1", cfg, sum(t.numel() for t in tree_leaves(params)))
    L, S, K = cfg.n_layers, RING_PROMPT, RING_STEPS
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, S + K)).astype(np.int32)).to(device)
    steps = []
    with torch.no_grad(), tripwires(*kernels_armed):
        reset_counts(*counted)
        full, _ = model.forward(params, {"tokens": toks}, inference=True)
        n_fwd, tc_fwd = counts(), fp.flash_prefill.tc_launches
        cache = model.init_cache(1, S + K, device=device)
        slots = cache["slots"][0]["k"].shape[2]
        reset_counts(*counted)
        first, cache = model.prefill(params, cache, {"tokens": toks[:, :S]})
        n_pre = counts()
        outs = [first[:, 0]]
        for t in range(K):
            reset_counts(*counted)
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": toks[:, S + t]})
            steps.append(counts())
            outs.append(logits)
        torch.cuda.synchronize()
    check(slots == RING_WINDOW, f"L1: the ring has {slots} slots")
    check(n_fwd == n_pre == only(flash_prefill=L) and tc_fwd == 0
          and all(n == only() for n in steps),
          f"L1 f32 launches: forward {n_fwd}, prefill {n_pre}, decode "
          f"steps {steps}")
    err = max(close(o, full[:, S - 1 + t], f"L1 f32 position {S - 1 + t} "
                    "vs the windowed forward", CONSISTENCY_TOL)
              for t, o in enumerate(outs))
    print(f"[L1] {cfg.name} at long_500k (config_for_shape: sliding window "
          f"{cfg.sliding_window}), {L} x {cfg.d_model}, f32, B=1: prefill "
          f"of {S} tokens into a ring of {slots} slots ({L} windowed K8 "
          f"launches, as the forward), then {K} decode steps on the ring "
          f"(positions {S} to {S + K - 1} at slots {S % slots} to "
          f"{(S + K - 1) % slots}; the grouped einsums, no launch): logits "
          f"of the prefill and every step vs forward(inference=True) over "
          f"{S + K} tokens under the same window max abs err {err:.3e} "
          f"({CONSISTENCY_TOL}); no plain K8 or K9 reached")
    del full, outs, cache, params, model
    peak_memory("L1")

    # --- L1. the ring, bf16, through the slot engine ----------------------
    free_models("L1")
    cfg = registry.config_for_shape(get_arch("qwen2-0.5b"),
                                    INPUT_SHAPES["long_500k"])
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    print(f"[L1] {cfg.name} bf16 slot engine over a ring of "
          f"{cfg.sliding_window} slots a lane: {len(RING_LENS)} prompts of "
          f"{min(RING_LENS)} to {max(RING_LENS)} tokens; its K8 launches are "
          f"not held one by one here (A1 holds K8 at S={RING_PROMPT}, window "
          f"{RING_WINDOW}, against its plain version)")
    slot_slice("L1", cfg, params, counted, counts, only, {}, kernels_armed,
               [], compare=False, reqs=ring_requests(cfg.vocab),
               max_seq=max(RING_LENS) + 16)
    del params, model
    peak_memory("L1")

    # --- Q1. the int8 cache against the full cache ------------------------
    free_models("Q1")
    cfg_f = dataclasses.replace(get_arch("yi-9b"),
                                n_layers=SERVE_LAYERS["yi-9b"])
    cfg_q = dataclasses.replace(cfg_f, kv_quant=True)
    m_f, m_q = registry.build(cfg_f), registry.build(cfg_q)
    params = m_q.init(torch.Generator(device=device).manual_seed(0), device)
    accounting("Q1", cfg_q, sum(t.numel() for t in tree_leaves(params)))
    ratio = (analysis.cache_bytes(cfg_q, 2, 4096)
             / analysis.cache_bytes(cfg_f, 2, 4096))
    check(ratio < 0.6, f"Q1: the int8 cache is {ratio:.3f} of the full one")
    L, B, S, K = cfg_q.n_layers, 2, 16, 4
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg_q.vocab, (B, S + K)).astype(np.int32)).to(device)
    rels, n = [], {}
    with torch.no_grad(), tripwires(*kernels_armed):
        cq, cf = m_q.init_cache(B, 32, device), m_f.init_cache(B, 32, device)
        check(cq["slots"][0]["k"].dtype == torch.int8
              and cq["slots"][0]["k_scale"].dtype == torch.float32,
              "Q1: the quantized cache is not int8 codes and f32 scales")
        reset_counts(*counted)
        m_q.prefill(params, cq, {"tokens": toks[:, :S]})
        n["prefill int8"] = counts()
        reset_counts(*counted)
        m_f.prefill(params, cf, {"tokens": toks[:, :S]})
        n["prefill full"] = counts()
        for t in range(S, S + K):
            reset_counts(*counted)
            dq, cq = m_q.decode_step(params, cq, {"tokens": toks[:, t]})
            n["decode int8"] = counts()
            reset_counts(*counted)
            df, cf = m_f.decode_step(params, cf, {"tokens": toks[:, t]})
            n["decode full"] = counts()
            dqn, dfn = dq.float().cpu().numpy(), df.float().cpu().numpy()
            rel = float(np.abs(dqn - dfn).max() / (np.abs(dfn).max() + 1e-9))
            check(rel < 0.08, f"Q1 step {t}: int8 vs full {rel:.4f} of the "
                  "logits' scale")
            # test_kv_quant's seeded target, 0.4 x max|df| above each row's
            # runner-up in both outputs: greedy argmax must be identical
            rng = np.random.default_rng(t)
            target = rng.integers(0, dfn.shape[-1], size=dfn.shape[0])
            bias = np.zeros_like(dfn)
            for bi, tok in enumerate(target):
                bias[bi, tok] = (dfn[bi].max() - dfn[bi, tok]
                                 + 0.4 * np.abs(dfn).max())
            check(np.array_equal(np.argmax(dqn + bias, -1),
                                 np.argmax(dfn + bias, -1))
                  and np.array_equal(np.argmax(dfn + bias, -1), target),
                  f"Q1 step {t}: greedy argmax differs under the margin")
            rels.append(rel)
    check(n["prefill int8"] == n["prefill full"] == only(flash_prefill=L)
          and n["decode int8"] == only()
          and n["decode full"] == only(decode_attn=L),
          f"Q1 launches: {n}")
    print(f"[Q1] {cfg_q.name} at full width, {L} of "
          f"{get_arch('yi-9b').n_layers} layers, bf16, kv_quant (int8 codes, "
          f"f32 scales a token and kv head) vs the full bf16 cache on the "
          f"same parameters, B={B}: prefill {S} tokens ({L} K8 each), "
          f"{K} decode steps (full: {L} K9 a step; int8: the grouped "
          f"einsums, no launch): max|dq - df| / max|df| "
          f"{', '.join(f'{r:.4f}' for r in rels)} (< 0.08); greedy argmax "
          f"identical under test_kv_quant's seeded 0.4 margin at every step; "
          f"analysis.cache_bytes int8 / full at 2 x 4096: {ratio:.4f} (< 0.6)")
    del cq, cf
    slot_slice("Q1", cfg_q, params, counted, counts, only, holds,
               kernels_armed, [], compare=False)
    del params
    peak_memory("Q1")


#: P2's shapes, the kernel table's: the paper's 2 x 32 LSTM at T=128 and
#: batch 64; RWKV6-3B's heads, 160 rows x T=512 of 64 x 64 (its serving
#: chunk as the sweep's coarsest); the Jamba width, B=4 x T=512 at d_inner
#: 16384 and d_state 16
P2_SHAPES = {"lstm": {"batch": 64, "seq_len": 128},
             "rwkv6": {"seq_len": 512, "n_bh": 160, "dk": 64, "dv": 64,
                       "target": 32},
             "mamba": {"batch": 4, "seq_len": 512, "d_inner": 16384,
                       "d_state": 16}}
#: the wrapper each family's profile points launch
P2_KERNELS = {"lstm": "lstm_seq", "rwkv6": "wkv6", "mamba": "mamba_scan"}


def profiler_slice(device, counted, counts, only, shapes=P2_SHAPES,
                   train_args=("--arch", "qwen2-0.5b")) -> dict:
    """The analysis and profiler half (P2 to P4; P1 runs inside the serving
    and training phases, ``accounting``, ``flops_share``, ``tick_costs``).

    * P2: ``obs/profile.profile_families`` over the three families at
      ``shapes`` on the card, counted (warmup 1 and 2 timed calls a point,
      each one launch of K2/K4, K6 or K7); every point's kernel held
      against its plain version on the same inputs, at its plan's f32
      policy (``core/plans.py``), and
      timed with CUDA events back to back and in a CUDA graph beside its
      host-clock measurement and its ``model_s``; the ``model_vs_measured``
      rows; the profile saved under ``build/``, reloaded and compared.
    * P3: the Fig 7 scheduler with the five LSTM plans calibrated with
      ``profile=profile.best_latencies()``: no K2 launched for
      ``fused_seq`` during ``calibrate``, its base latency the profile's;
      then 32 single-window requests (``classify.latencies_ms``) through
      the plan it chooses, held to ``sequential`` at the plan's policy.
    * P4: ``launch.train.main(train_args + --steps 4 --ckpt-every 2
      --ckpt-dir build/p4_ckpt)``, counted (K8t twice and K8b once an
      attention layer a step); steps 2 and 4 written; the step-4
      checkpoint restored onto the card and onto the CPU, each bit-equal
      to the trained parameters.
    Returns the launches of P2 and P4 by wrapper name and P2's max abs
    errors."""
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.mobirnn_lstm import LSTMConfig
    from repro_torch.core import lstm, plans
    from repro_torch.core.scheduler import (Plan, Scheduler,
                                            SyntheticLoadSensor)
    from repro_torch.data import har
    from repro_torch.launch import classify
    from repro_torch.launch import train as train_lm
    from repro_torch.obs import profile as profile_lib
    from repro_torch.optim.adamw import tree_leaves, tree_map

    families = tuple(shapes)
    # --- P2. the measured profile ----------------------------------------
    reset_counts(*counted)
    t0 = time.perf_counter()
    prof = profile_lib.profile_families(families, hook_kwargs=shapes,
                                        device=device)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launched = counts()
    per_family = {f: sum(p.family == f for p in prof.points)
                  for f in families}
    want = only(**{P2_KERNELS[f]: 3 * n for f, n in per_family.items()})
    check(launched == want, f"P2: the sweep launched {launched}, "
          f"{want} expected (3 a point)")
    check(all(n >= 1 for n in per_family.values()),
          f"P2: a family profiled no point: {per_family}")
    print(f"[P2] profile_families{families} on {prof.key}: "
          f"{len(prof.points)} points ({per_family}) in {sweep_s:.1f} s; "
          f"launches {dict((k, v) for k, v in launched.items() if v)}")
    errs: dict[str, float] = {}
    cands = profile_lib.candidates(families, hook_kwargs=shapes,
                                   device=device)
    check([(c.family, c.point) for c in cands]
          == [(p.family, p.point) for p in prof.points],
          "P2: the candidates differ from the profiled points")
    for c, pt, r in zip(cands, prof.points,
                        profile_lib.model_vs_measured(prof)):
        name = P2_KERNELS[c.family]
        tol = plans.get_family(c.family).tol(c.plan, "float32")
        got, want_out = c.fn(*c.args), c.plain(*c.args)
        err = max(close(g.float(), w.float(), f"P2 {name} {c.point}", tol)
                  for g, w in zip(got, want_out))
        errs[name] = max(errs.get(name, 0.0), err)
        ev_ms = time_ms(lambda: c.fn(*c.args), 20)
        g_ms = graph_ms(lambda: c.fn(*c.args), 10)
        print(f"[P2] {c.family} {c.plan} {c.point}: measured "
              f"{pt.measured_s * 1e3:.4f} ms (host clock around a "
              f"synchronized call, best of 2), CUDA events "
              f"{ev_ms:.4f} ms back to back, {g_ms:.4f} ms in a CUDA graph; "
              f"model_s {pt.model_s * 1e3:.4e} ms (analysis stream costs "
              f"at the f32 CUDA-core and HBM rates), measured/model "
              f"{r['ratio']:.1f}, graph/model {g_ms / (pt.model_s * 1e3):.1f}"
              f"; {name} against its plain version: max abs err {err:.3e}; "
              f"{CARD['line']}")
    del cands
    path = REPO / "build" / "device_profile.json"
    path.parent.mkdir(exist_ok=True)
    prof.save(str(path))
    loaded = profile_lib.DeviceProfile.load(str(path))
    check(loaded.to_json() == prof.to_json() and loaded.key == prof.key,
          "P2: the saved profile reloads differently")
    print(f"[P2] saved {path.relative_to(REPO)} and reloaded it equal; "
          f"best latencies {prof.best_latencies()}")

    # --- P3. the Fig 7 scheduler calibrated from the profile ---------------
    cfg = LSTMConfig()
    _, test = har.make_har(n_train=1, n_test=32, seed=0)
    windows = torch.tensor(test.x, device=device)
    params = lstm.LSTMClassifier(
        cfg, generator=torch.Generator().manual_seed(0)).to(device).params()
    best = prof.best_latencies()
    sched = Scheduler(SyntheticLoadSensor(0.0),
                      viable=lstm.plan_viability(cfg, 1, cfg.seq_len))
    for name, fn in lstm.FORWARD_PLANS.items():
        sched.register(Plan(name, fn))
    reset_counts(*counted)
    with torch.inference_mode():
        sched.calibrate(params, windows[:1], cfg, profile=best)
    torch.cuda.synchronize()
    cal = counts()
    check(cal["lstm_seq"] == 0 and cal["lstm_seq_traj"] == 0,
          f"P3: calibrate(profile=) launched {cal}; fused_seq must not run")
    check(sched.plans["fused_seq"].base_latency_s == best["fused_seq"],
          "P3: fused_seq's base latency is not the profile's")
    chosen = sched.choose().plan
    reset_counts(*counted)
    with torch.inference_mode():
        times, logits = classify.latencies_ms(lstm.FORWARD_PLANS[chosen],
                                              params, windows, cfg)
        want_logits = lstm.FORWARD_PLANS["sequential"](params, windows, cfg)
    torch.cuda.synchronize()
    served = counts()
    tol = plans.get_family("lstm").tol(chosen, "float32")
    err = close(logits, want_logits, f"P3 {chosen} vs sequential", tol)
    if chosen == "fused_seq":
        check(served == only(lstm_seq=33),
              f"P3: 32 requests and a warmup through fused_seq launched "
              f"{served}")
    print(f"[P3] Scheduler(viable=plan_viability) over "
          f"{list(lstm.FORWARD_PLANS)}, calibrate(profile=best_latencies): "
          f"fused_seq seeded at {best['fused_seq'] * 1e3:.4f} ms from the "
          f"profile without a launch (calibrate launched "
          f"{dict((k, v) for k, v in cal.items() if v)}); base latencies "
          + ", ".join(f"{n} {p.base_latency_s * 1e3:.4f} ms"
                      for n, p in sched.plans.items())
          + f"; chose {chosen}; 32 single-window requests through it p50 "
          f"{statistics.median(times):.4f} ms (launches "
          f"{dict((k, v) for k, v in served.items() if v)}), against "
          f"sequential max abs err {err:.3e} at {tol}; {CARD['line']}")

    # --- P4. checkpoints of the trainer ----------------------------------
    ckdir = REPO / "build" / "p4_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    reset_counts(*counted)
    t0 = time.perf_counter()
    report = train_lm.main([*train_args, "--device", device.type,
                            "--steps", "4", "--ckpt-every", "2",
                            "--ckpt-dir", str(ckdir), "--log-every", "1"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = counts()
    tcfg = train_lm.get_arch(train_args[1] + (
        "-reduced" if "--reduced" in train_args else ""))
    n_attn = sum(tcfg.layer_kind(i) == "attn" for i in range(tcfg.n_layers))
    check(trained == only(flash_prefill_traj=2 * n_attn * 4,
                          flash_prefill_bwd=n_attn * 4),
          f"P4: 4 training steps launched {trained}")
    files = sorted(f.name for f in ckdir.iterdir())
    check(files == ["ckpt_00000002.json", "ckpt_00000002.npz",
                    "ckpt_00000004.json", "ckpt_00000004.npz"],
          f"P4: the checkpoint directory holds {files}")
    params = tree_map(lambda t: t.detach(), report.pop("params"))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))

    def bits(t: torch.Tensor) -> torch.Tensor:
        width = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}[t.element_size()]
        return t.view(width)

    held = []
    for where in (device, torch.device("cpu")):
        template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                  device=where), params)
        t0 = time.perf_counter()
        got = ckpt.restore(str(ckdir), template)
        restore_s = time.perf_counter() - t0
        pairs = list(zip(tree_leaves(got), tree_leaves(params)))
        check(len(pairs) == len(tree_leaves(params)) and all(
            g.device.type == where.type and g.dtype == p.dtype
            and torch.equal(bits(g.cpu()), bits(p.cpu())) for g, p in pairs),
            f"P4: the checkpoint restored onto {where} is not bit-equal to "
            "the trained parameters")
        held.append(f"{where.type} in {restore_s:.1f} s")
        del got, template
    shutil.rmtree(ckdir, ignore_errors=True)
    print(f"[P4] launch.train.main({' '.join(train_args)} --steps 4 "
          f"--ckpt-every 2): {tcfg.name} ({tcfg.n_layers} x {tcfg.d_model}, "
          f"{tcfg.dtype}, {n_bytes / 1e9:.3f} GB of parameters) in "
          f"{train_s:.1f} s, launches "
          f"{dict((k, v) for k, v in trained.items() if v)}; wrote {files}; "
          f"step 4 restored bit-equal to the trained parameters onto "
          f"{' and '.join(held)}; {CARD['line']}")
    launches = {name: launched[name] + trained[name] for name in launched}
    return {"launches": launches, "errs": errs}


def host_ms(fn, repeats: int = 5) -> float:
    """Median over ``repeats`` of the host clock around one call ending in
    ``torch.cuda.synchronize()``, after a warmup call."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def figure_model_rows(fz, cfg) -> list[tuple[str, float, float]]:
    """The JAX benchmark's Fig 3 to Fig 6 model rows (its
    ``bench_fig3_factorization``, ``bench_fig4_speedup``,
    ``bench_fig5_complexity`` and ``bench_fig6_multithread``) under the
    paper's profiles of the cost model ``fz``: (row, seconds, ratio)."""
    in_dim, out = cfg.input_dim + cfg.hidden, 4 * cfg.hidden
    gpu_fine = fz.factorize_gate(fz.MOBILE_GPU, in_dim, out, 1)
    cpu = fz.factorize_gate(fz.MOBILE_CPU1, in_dim, out, out)
    best = fz.best_cols_per_unit(fz.MOBILE_GPU, in_dim, out)
    gpu = fz.factorize_gate(fz.MOBILE_GPU, in_dim, out, best)
    best4 = fz.best_cols_per_unit(fz.MOBILE_CPU4, in_dim, out)
    mt = fz.factorize_gate(fz.MOBILE_CPU4, in_dim, out, best4)
    rows = [("fig3/model_mobile_gpu_fine_vs_cpu (gpu_fine/cpu)", gpu_fine,
             gpu_fine / cpu),
            ("fig4/model_mobirnn_speedup (cpu/gpu)", gpu, cpu / gpu),
            ("fig6/model_multithread_cpu (gpu/mt)", mt, gpu / mt)]
    for hidden in (32, 64, 128, 256):
        for layers in (1, 2, 3):
            c = cfg.with_complexity(hidden, layers)
            d_in, o = c.input_dim + hidden, 4 * hidden
            b = fz.best_cols_per_unit(fz.MOBILE_GPU, d_in, o)
            t_gpu = layers * fz.factorize_gate(fz.MOBILE_GPU, d_in, o, b)
            t_cpu = layers * fz.factorize_gate(fz.MOBILE_CPU1, d_in, o, o)
            rows.append((f"fig5/model_h{hidden}_l{layers} (speedup)", t_gpu,
                         t_cpu / t_gpu))
    return rows


def factorization_slice(device, counted, counts, only) -> dict:
    """F1: MobiRNN's Figs 2 and 3 on the card.  The paper's classifier
    (2 x 32, T=128 x 9 sensors, B=1, f32, weights from seed 0) on one
    window through five factorizations of the same cell:
    ``forward_sequential`` over ``lstm_cell_fine(unit_cols=1)`` (Fig 2b,
    one work unit a gate column), ``unit_cols=10`` (the JAX benchmark's
    packed_10col), ``lstm_cell_fused`` (one packed unit, plain torch),
    ``fused_cell`` (T x L = 256 K1 launches) and ``fused_seq`` (1 K2
    launch).  Each run's logits held to ``sequential`` at LSTM_TOL, its
    launches counted on one call (none for the plain ones), and timed on
    the host clock (median of 5 synchronized calls) beside the modelled
    time of ``core/factorization.H100``: T x sum over layers of
    ``factorize_gate(H100, D + H, 4H, cols)``, for ``fused_seq`` one unit
    holding the whole window.  Holds the paper's ordering on the card:
    per-column > 10-column > packed plain > ``fused_cell`` > ``fused_seq``
    (the model's ratio to the measurement is printed, not held).  Prints
    the host cost a launch (``fused_cell``'s window over its 256 launches)
    beside ``H100.enqueue_overhead_s``, and the Fig 3 to Fig 6 model rows
    under the paper's four profiles.  Returns the launches of the counted
    calls and the times."""
    from repro_torch.configs.mobirnn_lstm import LSTMConfig
    from repro_torch.core import cell as cell_lib
    from repro_torch.core import factorization as fz
    from repro_torch.core import lstm
    from repro_torch.optim.adamw import tree_map

    cfg = LSTMConfig()
    T, L, H, D = cfg.seq_len, cfg.n_layers, cfg.hidden, cfg.input_dim
    params = tree_map(lambda t: t.to(device),
                      lstm.init_params(torch.Generator().manual_seed(0), cfg))
    x = torch.randn(1, T, D, generator=torch.Generator().manual_seed(1)
                    ).to(device)
    in_dims = [(D if i == 0 else H) + H for i in range(L)]

    def fine(cols):
        def cell(p, i, c, h):
            return cell_lib.lstm_cell_fine(p, i, c, h, unit_cols=cols)
        return lambda: lstm.forward_sequential(params, x, cfg, cell_fn=cell)

    def modelled(cols) -> float:
        if cols is not None:
            return T * sum(fz.factorize_gate(fz.H100, d, 4 * H, cols)
                           for d in in_dims)
        flops = T * sum(2.0 * d * 4 * H for d in in_dims)
        byts = 4 * (sum((d + 1) * 4 * H for d in in_dims) + T * D
                    + cfg.n_classes)
        return fz.unit_time(fz.H100, 1, flops, byts)

    runs = [("per-column (Fig 2b)", fine(1), 1, {}),
            ("10-column", fine(10), 10, {}),
            ("packed plain (Fig 2c)",
             lambda: lstm.forward_sequential(params, x, cfg), 4 * H, {}),
            ("fused_cell", lambda: lstm.forward_fused_kernel(params, x, cfg),
             4 * H, {"lstm_cell": T * L}),
            ("fused_seq", lambda: lstm.forward_fused_seq(params, x, cfg),
             None, {"lstm_seq": 1})]
    times, launched = {}, {}
    with torch.inference_mode():
        want = lstm.forward_sequential(params, x, cfg)
        for label, fn, cols, expect in runs:
            reset_counts(*counted)
            got = fn()
            torch.cuda.synchronize()
            got_counts = counts()
            check(got_counts == only(**expect),
                  f"F1 {label}: one window launched {got_counts}, "
                  f"{expect or 'no hand kernel'} expected")
            launched.update(expect)
            err = close(got, want, f"F1 {label} vs sequential")
            times[label] = host_ms(fn)
            model_ms = modelled(cols) * 1e3
            print(f"[F1] {label}: {times[label]:.3f} ms a window (host "
                  f"clock, median of 5 synchronized calls), modelled "
                  f"{model_ms:.3f} ms on {fz.H100.name} "
                  f"({'one unit a window' if cols is None else f'{cols} columns a unit'}"
                  f"), measured/model {times[label] / model_ms:.3f}; "
                  f"launches {expect or 'none of the hand kernels'}; logits "
                  f"vs sequential max abs err {err:.3e}; {CARD['line']}")
    order = [label for label, *_ in runs]
    check(all(times[a] > times[b] for a, b in zip(order, order[1:])),
          f"F1: the paper's ordering does not hold on the card: {times}")
    per_launch_us = times["fused_cell"] / (T * L) * 1e3
    print(f"[F1] ordering held: " + " > ".join(
        f"{label} {times[label]:.3f}" for label in order) + " ms; "
          f"fused_cell's host cost a launch {per_launch_us:.2f} us "
          f"({times['fused_cell']:.3f} ms / {T * L}) beside "
          f"H100.enqueue_overhead_s {fz.H100.enqueue_overhead_s * 1e6:.2f}"
          f" us; {CARD['line']}")
    for row, t, ratio in figure_model_rows(fz, cfg):
        print(f"[F1] {row}: {t * 1e6:.3f} us, {ratio:.3f}x (the paper's "
              "profiles, modelled)")
    return {"launches": launched, "times": times}


def spec_leaves(tree) -> list:
    """The PartitionSpecs of a spec tree (dicts and lists), in order."""
    from repro_torch.partitioning import PartitionSpec

    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [s for t in tree for s in spec_leaves(t)]


def mesh_slice(device, counted, counts, only) -> dict:
    """D1: logical-axis partitioning on the one-device mesh.

    * The trainer: ``launch/train.train`` on Qwen2-0.5B at full width and
      depth, bf16, 2 steps of 4 x 512, once as it runs (inside
      ``use_rules`` on the 1 x 1 host mesh; the activation specs its
      ``constrain`` calls resolve are counted) and once with the rules
      context left out (its ``use_rules`` replaced by a null context):
      losses and ``grad_norm``s bit-equal, every wrapper's launches equal
      (K8t twice and K8b once an attention layer a step).
    * The slot engine: Qwen2-0.5B's first 4 slot requests served with the
      engine built, its decode tick captured and the serve run inside
      ``use_rules``, and again outside: tokens equal, the captured
      launches and the eager ones equal.
    * The abstract trees: ``abstract_params()`` and ``abstract_cache(128,
      32768)`` of every arch at full width (Jamba-1.5-Large's 398 B and
      Command-R-35B included), their specs resolved on the host mesh and
      on the abstract (16, 16) production mesh, with
      ``torch.cuda.memory_allocated()`` unchanged across the sweep; the
      production mesh itself refused on one card.
    Returns the launches of the partitioned runs."""
    from repro_torch import partitioning as pt
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lm
    from repro_torch.models import registry

    cfg = get_arch("qwen2-0.5b")
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    host = pt.make_rules(mesh_lib.make_host_mesh(device=torch.device(
        device.type, torch.cuda.current_device())))
    check(host.mesh.shape == {"data": 1, "model": 1},
          f"D1: the host mesh is {host.mesh.shape}")
    resolved = {"n": 0}
    spec_for = pt.AxisRules.spec_for

    def counting(self, axes, shape):
        resolved["n"] += 1
        return spec_for(self, axes, shape)

    free_models("D1")
    runs, launched, specs = {}, {}, {}
    pt.AxisRules.spec_for = counting
    try:
        for partitioned in (True, False):
            reset_counts(*counted)
            resolved["n"] = 0
            if not partitioned:
                train_lm.use_rules = lambda rules: contextlib.nullcontext()
            t0 = time.perf_counter()
            rep = train_lm.train(cfg, steps=2, batch=4, seq=512,
                                 device=device.type, log_every=1)
            torch.cuda.synchronize()
            launched[partitioned] = counts()
            specs[partitioned] = resolved["n"]
            runs[partitioned] = (rep["losses"], rep["grad_norms"],
                                 time.perf_counter() - t0, rep["step_ms"])
            del rep
            free_models("D1")
    finally:
        pt.AxisRules.spec_for = spec_for
        train_lm.use_rules = pt.use_rules
    want = only(flash_prefill_traj=2 * n_attn * 2,
                flash_prefill_bwd=n_attn * 2)
    check(launched[True] == launched[False] == want,
          f"D1 trainer: launches inside the rules {launched[True]}, outside "
          f"{launched[False]}, {want} expected")
    check(runs[True][:2] == runs[False][:2],
          f"D1 trainer: losses and grad_norms inside the rules "
          f"{runs[True][:2]} differ from outside {runs[False][:2]}")
    n_leaves = specs[False]           # the parameters' placement alone
    check(specs[True] > n_leaves,
          f"D1 trainer: constrain resolved no spec inside the rules "
          f"({specs[True]} resolutions, {n_leaves} for the parameters)")
    print(f"[D1] launch.train.train({cfg.name}, {cfg.dtype}, 2 steps of 4 x "
          f"512): "
          f"inside use_rules on the 1 x 1 host mesh {runs[True][2]:.1f} s "
          f"(steps {', '.join(f'{t:.1f}' for t in runs[True][3])} ms; "
          f"{specs[True] - n_leaves} activation specs resolved by "
          f"constrain), outside {runs[False][2]:.1f} s (steps "
          f"{', '.join(f'{t:.1f}' for t in runs[False][3])} ms): losses "
          f"{runs[True][0]} and grad_norms {runs[True][1]} bit-equal; "
          f"launches {dict((k, v) for k, v in want.items() if v)} both; "
          f"{CARD['line']}")

    # --- the slot engine, its tick captured inside the rules --------------
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    reqs = slot_requests(cfg.vocab)[:4]
    served = {}
    for inside in (True, False):
        reset_counts(*counted)
        t0 = time.perf_counter()
        with pt.use_rules(host) if inside else contextlib.nullcontext():
            eng = slot_engine(model, params)
            tick = eng.ticks["decode/base"]
            check(tick.graph is not None,
                  f"D1 slot engine (rules {inside}): no CUDA graph")
            results = eng.serve(reqs)
        torch.cuda.synchronize()
        tokens_ok(results, cfg, f"D1 slot engine (rules {inside})")
        served[inside] = ([r.tokens for r in results],
                          dict(tick.captured_launches), counts(),
                          time.perf_counter() - t0)
        del eng, tick, results
    check(all(np.array_equal(a, b) for a, b in zip(served[True][0],
                                                     served[False][0])),
          "D1 slot engine: tokens inside the rules differ from outside")
    check(served[True][1:3] == served[False][1:3],
          f"D1 slot engine: captured and eager launches inside the rules "
          f"{served[True][1:3]} differ from outside {served[False][1:3]}")
    print(f"[D1] SlotEngine({cfg.name}, {cfg.dtype}, {N_SLOTS} slots of "
          f"{slot_seq(cfg)}): 4 requests served with the tick captured "
          f"inside use_rules ({served[True][3]:.1f} s) and outside "
          f"({served[False][3]:.1f} s): tokens equal, captured launches "
          f"{served[True][1]} a tick both, eager launches "
          f"{dict((k, v) for k, v in served[True][2].items() if v)} both; "
          f"{CARD['line']}")
    del params, model
    free_models("D1")

    # --- the abstract trees at full width ---------------------------------
    prod = pt.make_rules(mesh_lib.abstract_production_mesh())
    try:
        mesh_lib.make_production_mesh(device=device.type)
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    check("needs 256 devices" in refused,
          f"D1: make_production_mesh on one card gave {refused!r}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sizes = []
    for name in sorted(ARCHS):
        m = registry.build(name)
        trees = (m.abstract_params(), m.abstract_cache(128, 32768))
        sharded = 0
        for vals, axes in trees:
            pt.tree_specs(axes, vals, host)
            sharded += sum(bool(s) for s in spec_leaves(
                pt.tree_specs(axes, vals, prod)))
        sizes.append(f"{name} {pt.param_count(trees[0][0]):,} parameters, "
                     f"{pt.bytes_of(trees[0][0]) / 1e9:.3f} GB, cache "
                     f"{pt.bytes_of(trees[1][0]) / 1e9:.3f} GB, "
                     f"{sharded} leaves sharded on (16, 16)")
    sweep_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(after == before, f"D1: the abstract sweep allocated "
          f"{after - before} bytes on the card")
    print(f"[D1] abstract_params/abstract_cache(128, 32768) of {len(ARCHS)} "
          f"archs at full width, specs resolved on the 1 x 1 host mesh and "
          f"the abstract (16, 16) mesh in {sweep_s:.1f} s, "
          f"torch.cuda.memory_allocated() {before} before and after; "
          f"make_production_mesh refused ({refused.split(' —')[0]}): "
          + "; ".join(sizes))
    return {"launches": {k: launched[True][k] + served[True][2][k]
                         for k in launched[True]}}


#: D2's ranks: a (1, 4) mesh of gloo ranks sharing the one card
D2_WORLD = 4
#: D2's time-mix and MoE configs (full width), its batch and sequence
D2_ARCHS = ("rwkv6-3b", "olmoe-1b-7b")
D2_B, D2_S = 4, 512
#: the f32 bounds of the JAX package's tests/test_distributed.py: the MoE
#: forward and gradients, the time-mix output and state, its shift
EP_TOL, EP_GRAD_TOL = dict(rtol=2e-4, atol=2e-4), dict(rtol=3e-4, atol=3e-4)
SEQPAR_TOL, SHIFT_TOL = dict(rtol=4e-4, atol=4e-4), dict(rtol=1e-5, atol=1e-5)
#: an MoE output or gradient in bf16: within this share of the largest
BF16_SHARE = 3e-2


def d2_leaves(mesh, tree, axes):
    """``tree``'s tensors as DTensors on ``mesh`` by logical ``axes`` (a
    tree of axes tuples, or one for a tensor), as differentiable leaves.
    Every rank holds the same full tensors, so ``device_put`` sends
    nothing."""
    from repro_torch import partitioning as pt
    from repro_torch.optim.adamw import tree_map

    rules = pt.make_rules(mesh)
    placed = pt.device_put(tree, pt.tree_shardings(axes, tree, rules))
    return tree_map(lambda t: t.detach().requires_grad_(), placed)


def leaf_names(tree, prefix: str = "") -> list[str]:
    """The names of ``tree``'s leaves in ``tree_leaves``' order (dict keys
    sorted), nested keys joined by dots."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def tmix_f64_grads(p, cfg, x, xp, s0) -> list:
    """The gradients of D2's time-mix loss, sum(out^2) + sum(shift^2) +
    sum(state^2), in float64 over the whole sequence: the port's plain
    time-mix (``_apply_tmix_local`` at ``chunked_xla``) with its f32 casts
    (``rwkv.F32``, ``common.F32``) raised to float64 for the call, on
    float64 copies of the inputs.  The truth D2's two f32 paths are
    measured against: leaves of x, params in ``tree_leaves``' order."""
    from repro_torch.models import common, rwkv
    from repro_torch.optim.adamw import tree_leaves, tree_map

    saved = rwkv.F32, common.F32
    rwkv.F32 = common.F32 = torch.float64
    try:
        whole = [t.detach().double().requires_grad_() for t in (x, xp, s0)]
        q = tree_map(lambda t: t.detach().double().requires_grad_(), p)
        out, sh, st = rwkv._apply_tmix_local(q, cfg, *whole,
                                             plan="chunked_xla")
        check(out.dtype == sh.dtype == st.dtype == torch.float64,
              "D2 f64 time-mix: not computed in float64")
        return list(torch.autograd.grad(
            (out ** 2).sum() + (sh ** 2).sum() + (st ** 2).sum(),
            whole + tree_leaves(q)))
    finally:
        rwkv.F32, common.F32 = saved


def d2_tmix(mesh, dtype, dev, arch: str) -> dict:
    """RWKV6-3B's time-mix at full width through the sequence-parallel path
    on ``mesh`` against one K6 over the whole sequence on this rank; in
    f32 also the gradients.  Returns this rank's errors, launches and
    collectives."""
    from repro_torch import analysis
    from repro_torch import partitioning as pt
    from repro_torch.configs import get_arch
    from repro_torch.core import plans
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wkv6_k
    from repro_torch.models import rwkv
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = get_arch(arch)
    gen = torch.Generator(device=dev).manual_seed(7)     # alike on every rank
    p = pt.split(rwkv.init_tmix_annot(gen, cfg, dtype, dev))[0]
    p = {k: v + 0.1 * torch.randn(v.shape, generator=gen, device=dev)
         if k in ("maa_x", "maa", "u") else v for k, v in p.items()}
    B, S, d = D2_B, D2_S, cfg.d_model
    H, dh = rwkv.n_heads(cfg), cfg.ssm.head_dim
    x = (torch.randn(B, S, d, generator=gen, device=dev) * 0.5).to(dtype)
    xp = (torch.randn(B, d, generator=gen, device=dev) * 0.5).to(dtype)
    s0 = torch.randn(B, H, dh, dh, generator=gen, device=dev) * 0.3
    m = mesh.shape["model"]
    j = mesh.device_mesh.get_local_rank("model")
    mine = slice(j * S // m, (j + 1) * S // m)
    axes = [("batch", "seq_model", None), ("batch", None),
            ("batch", None, None, None)]
    p_axes = tree_map(lambda t: (None,) * t.dim(), p)
    rules = pt.make_rules(mesh)
    counted = (wkv6_k.wkv6, wkv6_k.wkv6_traj, wkv6_k.wkv6_bwd)
    arms = ((wkv6_k, "wkv6_plain"), (wkv6_k, "wkv6_traj_plain"),
            (wkv6_k, "wkv6_bwd_plain"), (ref, "wkv6"), (ref, "wkv6_traj"),
            (ref, "wkv6_stepwise"), (rwkv, "wkv_chunked"))

    def seqpar(grad: bool):
        xs = d2_leaves(mesh, [x, xp, s0], axes)
        dp = d2_leaves(mesh, p, p_axes)
        reset_counts(*counted)
        with pt.use_rules(rules), tripwires(*arms), \
                torch.set_grad_enabled(grad):
            got = {}
            out = analysis.count_collectives(
                lambda: got.update(o=rwkv.apply_tmix(dp, cfg, *xs)))
        launches = {fn.__name__: fn.launches for fn in counted}
        return got["o"], out, launches, xs + tree_leaves(dp)

    with torch.no_grad():
        want = rwkv.apply_tmix(p, cfg, x, xp, s0)
    (out, shift, state), colls, launched, _ = seqpar(False)
    tol = SEQPAR_TOL if dtype == torch.float32 \
        else plans.RWKV_TOL["bfloat16"]
    errs = {"out": close(out.to_local(), want[0][:, mine], "D2 out", tol),
            "state": close(state.to_local(), want[2], "D2 state", tol),
            "shift": close(shift.to_local(), want[1], "D2 shift",
                           SHIFT_TOL if dtype == torch.float32 else tol)}
    if dev.type == "cuda":
        check(launched == {"wkv6": 1, "wkv6_traj": 0, "wkv6_bwd": 0},
              f"D2 seqpar {dtype} launches {launched}, one K6 expected")
    res = {"errs": errs, "collectives": colls, "launches": launched}
    if dtype != torch.float32:
        return res

    # the gradients of sum(out^2) + sum(state^2) + sum(shift^2): every
    # rank's loss holds its shard of out and the replicated outputs whole
    (out, shift, state), _, _, leaves = seqpar(True)
    loss = sum((t.to_local() ** 2).sum() for t in (out, shift, state))
    got = torch.autograd.grad(loss, leaves)
    launched = {fn.__name__: fn.launches for fn in counted}
    whole = [t.clone().requires_grad_() for t in (x, xp, s0)]
    one = tree_map(lambda t: t.clone().requires_grad_(), p)
    o1, sh1, st1 = rwkv.apply_tmix(one, cfg, *whole)
    want = torch.autograd.grad((o1 ** 2).sum() + (sh1 ** 2).sum()
                               + (st1 ** 2).sum(), whole + tree_leaves(one))
    check(len(got) == len(want), "D2 seqpar: the leaves differ")
    # both sides run K6t and K6b (over 4 x 128 tokens and the carry's
    # products, and over 512), the same f32 sums in another order: each
    # leaf held at 3e-4 with the atol scaled by its max|grad|, as A7 holds
    # two orders of f32 sums.  At full width the one-device path is itself
    # off the float64 truth by more than 3e-4 absolute on leaves of
    # max|grad| 1e2 to 5e3 (up to 7e-3 on tm_w1's): the witness below
    rtol = 3e-4
    gerr = 0.0                          # the worst error over its max|grad|
    for i, (g, w) in enumerate(zip(got, want)):     # x, x_prev, s0, params
        w = w[:, mine] if i == 0 else w
        m = float(w.abs().max())
        gerr = max(gerr, close(g.to_local(), w, f"D2 grad of leaf {i}",
                               dict(rtol=rtol, atol=rtol * m)) / (m or 1))
    if dev.type == "cuda":
        check(launched == {"wkv6": 0, "wkv6_traj": 1, "wkv6_bwd": 1},
              f"D2 seqpar grads launches {launched}: K6t and K6b expected")
    res["errs"]["grads"] = gerr
    res["grad_launches"] = launched
    # the witness of that bound: both f32 paths against the float64 truth,
    # each leaf's worst errors and, at the entry where the two paths
    # differ most, each path's error there
    truth = tmix_f64_grads(p, cfg, x, xp, s0)
    witness = {}
    for i, (name, g, w, t) in enumerate(zip(
            ["x", "x_prev", "s0"] + leaf_names(p), got, want, truth)):
        g, w = g.to_local().double(), w.double()
        t = t[:, mine] if i == 0 else t
        w = w[:, mine] if i == 0 else w
        at = int((g - w).abs().argmax())
        witness[name] = {
            "max_grad": float(t.abs().max()),
            "seqpar_vs_one": float((g - w).abs().max()),
            "seqpar_vs_f64": float((g - t).abs().max()),
            "one_vs_f64": float((w - t).abs().max()),
            "at_worst": [float((g - t).flatten()[at]),
                         float((w - t).flatten()[at])]}
    res["witness"] = witness
    return res


def d2_moe(mesh, dtype, dev, arch: str) -> dict:
    """OLMoE-1B-7B's MoE layer at full width through the expert-parallel
    path on ``mesh`` (E / m experts a rank) against the dense path on this
    rank, drop-free and at the training capacity, forward and gradients.
    Returns this rank's errors and collectives."""
    from repro_torch import analysis
    from repro_torch import partitioning as pt
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.optim.adamw import tree_map

    cfg = get_arch(arch)
    gen = torch.Generator(device=dev).manual_seed(11)
    p = moe.init_moe(gen, cfg, dtype, dev)
    x = torch.randn(D2_B, D2_S, cfg.d_model, generator=gen,
                    device=dev).to(dtype)
    E_loc = cfg.moe.n_experts // mesh.shape["model"]
    j = mesh.device_mesh.get_local_rank("model")
    mine = slice(j * E_loc, (j + 1) * E_loc)
    p_axes = {k: ("experts", None, None) if k != "router" else (None, None)
              for k in p}
    rules = pt.make_rules(mesh)
    f32 = dtype == torch.float32
    res = {"errs": {}, "collectives": {}}
    for no_drop in (True, False):
        tag = "no_drop" if no_drop else "capacity"
        dx = d2_leaves(mesh, x, ("batch", "seq", None))
        dp = d2_leaves(mesh, p, p_axes)
        with pt.use_rules(rules):
            got = {}
            colls = analysis.count_collectives(lambda: got.update(
                o=moe.apply_moe(dp, dx, cfg, no_drop=no_drop)))
        out, aux = got["o"]
        one = tree_map(lambda t: t.clone().requires_grad_(), p)
        x1 = x.clone().requires_grad_()
        want, want_aux = moe.apply_moe(one, x1, cfg, no_drop=no_drop)
        # the output is replicated: every rank's loss holds it whole
        g = torch.autograd.grad((out.to_local().float() ** 2).sum(),
                                [dp[k] for k in sorted(p)] + [dx])
        w = torch.autograd.grad((want.float() ** 2).sum(),
                                [one[k] for k in sorted(p)] + [x1])
        pairs = [(k, a.to_local(), b[mine] if k != "router" else b)
                 for k, a, b in zip(sorted(p), g, w)]
        pairs.append(("x", g[-1].to_local(), w[-1]))
        out, want = out.to_local().detach(), want.detach()
        check(aux["moe_drop_frac"].to_local().item()
              == want_aux["moe_drop_frac"].item(),
              f"D2 EP {tag}: drop fractions differ")
        if f32:
            errs = {"out": close(out, want, f"D2 EP {tag} out", EP_TOL)}
            for k in ("moe_load_balance", "moe_z_loss"):
                errs[k] = close(aux[k].to_local().detach(),
                                want_aux[k].detach(), f"D2 EP {tag} {k}",
                                EP_TOL)
            # JAX's gradient bound as the rtol, the atol scaled by each
            # leaf's max|grad| (full-width sums over 2048 tokens, in
            # another order: the combine's psum), as A7 holds gradients
            errs["grads"] = max(
                close(a, b, f"D2 EP {tag} grad {k}",
                      dict(rtol=EP_GRAD_TOL["rtol"],
                           atol=EP_GRAD_TOL["atol"] * float(b.abs().max())))
                / float(b.abs().max() or 1) for k, a, b in pairs)
        else:
            errs = {}
            for k, a, b in [("out", out, want)] + pairs:
                err = float((a.float() - b.float()).abs().max())
                scale = float(b.float().abs().max())
                check(err <= BF16_SHARE * scale,
                      f"D2 EP {tag} bf16 {k}: max abs err {err:.3e} over "
                      f"{BF16_SHARE} x max {scale:.3e}")
                errs[k] = err
        res["errs"][tag] = errs
        res["collectives"][tag] = colls
        del dx, dp, got, out, aux, one, x1, want, want_aux, g, w, pairs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


def d2_rank(rank: int, world: int, tmp: str, device_type: str = "cuda",
            archs: tuple[str, str] = D2_ARCHS) -> None:
    """One rank of D2: joins the gloo group in ``tmp``, builds the (1,
    world) mesh, runs ``d2_tmix`` and ``d2_moe`` in f32 and bf16 and writes
    its results to ``tmp/rank<rank>.json``.  A failed check raises here,
    and the rank exits nonzero."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = mesh_lib.group_mesh(("data", "model"), (1, world), dev)
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            res[f"tmix {name}"] = d2_tmix(mesh, dtype, dev, archs[0])
            res[f"moe {name}"] = d2_moe(mesh, dtype, dev, archs[1])
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def expected_collectives(cfg_t, cfg_m, world: int, j: int, dtype) -> dict:
    """What rank ``j`` of the (1, ``world``) mesh sends in one seqpar call
    and one EP call: 7 permutes of the shift, the two rounds' (D, A) and
    the exclusive pair (a round's last ranks send nothing) and 2
    all-reduces of (state, shift); the EP combine in the model dtype and
    the dropped count."""
    item = torch.finfo(dtype).bits // 8
    H, dh = cfg_t.d_model // cfg_t.ssm.head_dim, cfg_t.ssm.head_dim
    shift = D2_B * cfg_t.d_model * item
    D, A = D2_B * H * dh * 4, D2_B * H * dh * dh * 4
    strides = [2 ** i for i in range(math.ceil(math.log2(world)))]
    sends = sum(j < world - s for s in strides) + (j < world - 1)
    return {"tmix": {"collective-permute": [3 + 2 * len(strides),
                                            shift + sends * (D + A)],
                     "all-reduce": [2, A + shift]},
            "moe": {"all-reduce": [2, D2_B * D2_S * cfg_m.d_model * item
                                   + 4]}}


def _spawn_ranks(target, world: int, args: tuple, limit: float) -> list:
    """Run ``target(rank, world, tmp, *args)`` on ``world`` spawned ranks,
    killing them past ``limit`` seconds; each rank's JSON results."""
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target, args=(r, world, tmp, *args))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=max(limit - (time.perf_counter() - t0), 1))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"the ranks of {target.__name__} "
              f"exited {codes}")
        ranks = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
    return ranks


def multidevice_slice(device, counted, world: int = D2_WORLD,
                      archs: tuple[str, str] = D2_ARCHS) -> dict:
    """D2: the multi-device paths on ``world`` gloo ranks sharing the one
    card, as a (1, world) mesh: each rank draws the full-width parameters
    and inputs from one seed, runs RWKV6-3B's sequence-parallel time-mix
    (d 2560, 40 heads of 64, B 4 x S 512, 128 tokens a rank) and
    OLMoE-1B-7B's expert-parallel MoE layer (64 experts, top 8, d 2048, ff
    1024, 16 experts a rank, 4 x 512 tokens) in f32 and bf16, and holds
    them against the single-device paths on the full inputs: the time-mix
    at JAX's f32 bounds (its gradients too) and the rwkv6 family's bf16
    tolerance, one K6 a rank forward and one K6t and one K6b under
    autograd with the plain scans armed to raise; the MoE drop-free and at
    the training capacity, forward and gradients at JAX's f32 bounds and
    bf16 within 3e-2 of the largest value.  The time-mix's f32 gradients
    are also taken in float64 (``tmix_f64_grads``): seqpar must be off
    that truth by at most twice what the one-device path is, on every
    leaf.  Each rank's collectives are held to the count and the bytes
    the paths send.  No time is printed:
    four ranks on one card say nothing of the paths' speed on four.
    Returns the launches of the ranks, summed."""
    from repro_torch.configs import get_arch

    ranks = _spawn_ranks(d2_rank, world, (device.type, archs), 600)
    cfg_t, cfg_m = get_arch(archs[0]), get_arch(archs[1])
    launches = {fn.__name__: 0 for fn in counted}
    for j, res in enumerate(ranks):
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            want = expected_collectives(cfg_t, cfg_m, world, j, dtype)
            t, m = res[f"tmix {name}"], res[f"moe {name}"]
            check(t["collectives"] == want["tmix"],
                  f"D2 rank {j} seqpar {name}: collectives "
                  f"{t['collectives']}, {want['tmix']} expected")
            for tag, colls in m["collectives"].items():
                check(colls == want["moe"],
                      f"D2 rank {j} EP {name} {tag}: collectives {colls}, "
                      f"{want['moe']} expected")
            for k, n in list(t["launches"].items()) + list(
                    t.get("grad_launches", {}).items()):
                launches[k] += n
            print(f"[D2] rank {j} {name}: seqpar {cfg_t.name} time-mix "
                  f"(B {D2_B} x S {D2_S}, {D2_S // world} tokens a rank) "
                  f"max abs err {t['errs']}, launches {t['launches']}"
                  f"{', grads ' + str(t['grad_launches']) if 'grad_launches' in t else ''}"
                  f"; collectives {t['collectives']}; EP {cfg_m.name} MoE "
                  f"({cfg_m.moe.n_experts // world} experts a rank) max abs "
                  f"err {m['errs']}; collectives {m['collectives']}")
    # the witness of the gradient bound: each leaf's errors against the
    # float64 truth over the ranks, and at the entry where seqpar and one
    # device differ most (from that rank).  Seqpar must be no farther
    # from the truth than twice the one-device path (K6t/K6b over the
    # whole sequence): what the two then disagree by is f32 rounding
    for name in ranks[0]["tmix float32"]["witness"]:
        ws = [res["tmix float32"]["witness"][name] for res in ranks]
        w = max(ws, key=lambda e: e["seqpar_vs_one"])
        sp = max(e["seqpar_vs_f64"] for e in ws)
        one = max(e["one_vs_f64"] for e in ws)
        print(f"[D2] witness, f32 grad of {name}: max|grad| "
              f"{max(e['max_grad'] for e in ws):.6e}; seqpar vs one device "
              f"{w['seqpar_vs_one']:.3e}; vs f64: seqpar {sp:.3e}, one "
              f"device {one:.3e}; at the entry where the two differ most, "
              f"off f64 by {w['at_worst'][0]:.3e} and "
              f"{w['at_worst'][1]:.3e}")
        check(sp <= 2 * one, f"D2 witness {name}: seqpar off f64 by "
              f"{sp:.3e}, more than twice the one-device path's {one:.3e}")
    print(f"[D2] {world} gloo ranks on one card as a (1, {world}) mesh: "
          f"every rank's outputs, gradients, launches and collectives held; "
          f"no time taken (NCCL across cards is not run); {CARD['line']}")
    return {"launches": launches}


#: D3: the trainer on 2 gloo ranks sharing the card, as (data=2, model=1)
D3_ARCH, D3_WORLD = "qwen2-0.5b", 2
D3_BATCH, D3_SEQ, D3_STEPS, D3_BF16_STEPS = 4, 512, 4, 2
#: PERF.md section 2's gate for LM training on the card (gradients card vs
#: CPU at 1e-4): each step's loss and grad_norm on the ranks, relative to
#: the one-device trainer's on the same seed and batches
D3_TOL = 1e-4
#: D3's serve on the (data=1, model=2) mesh: 4 prompts of 64 tokens, 4
#: decode steps, a cache of 128 slots; the port's prefill + decode
#: tolerance (tests/test_torch_train_ranks.py's SERVE_TOL)
D3_SERVE_B, D3_PROMPT, D3_DECODE, D3_CACHE = 4, 64, 4, 128
D3_SERVE_TOL = 3e-4


def d3_predicted(cfg, world: int) -> dict:
    """What a training step of ``cfg`` sends on each rank of the (data =
    ``world``, model = 1) host mesh, from the parameters' specs: each leaf
    that the rules shard over 'data' (FSDP) is all-gathered where a
    ``shard_map`` body takes it (a layer's twice, the remat recompute
    gathering again; the embedding twice, for the lookup and the tied
    head; each call this rank's shard of a layer) and reduce-scattered
    once a use in the backward (the whole layer's gradient); each
    replicated bias is all-reduced once a layer in the backward (its
    gradient summed over 'data'); the norms' scales, used by DTensor ops,
    once a leaf (their gradients' partial sums); the loss's sum twice
    (forward, backward) and the gradient norm once, 4 bytes each.
    {kind: [calls, bytes]}."""
    from repro_torch import partitioning as pt
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer

    rules = pt.make_rules(mesh_lib.Mesh(("data", "model"), (world, 1)))
    values, axes = transformer.abstract_params(cfg)
    specs = pt.tree_specs(axes, values, rules)
    out = {"all-gather": [0, 0], "reduce-scatter": [0, 0],
           "all-reduce": [0, 0]}

    def add(kind, calls, nbytes):
        out[kind][0] += calls
        out[kind][1] += nbytes

    leaves = []
    pt._map(lambda v, spec: leaves.append((v, spec)),
            lambda x: isinstance(x, torch.Tensor), values, specs)
    n_groups = cfg.n_layers // cfg.period
    for (v, spec), path in zip(leaves, _leaf_paths(values)):
        full = v.numel() * v.element_size()
        data = any(pt.sharded_over(spec, d, rules.mesh, "data")
                   for d in range(v.dim()))
        if path[0] == "blocks":
            if data:
                add("all-gather", 2 * n_groups, 2 * full // world)
                add("reduce-scatter", n_groups, full)
            elif path[-1] in ("bq", "bk", "bv"):
                add("all-reduce", n_groups, full)
            else:                                  # the norms' scales
                add("all-reduce", 1, full)
        elif data:                                 # the embedding
            add("all-gather", 2, 2 * full // world)
            add("reduce-scatter", 2, 2 * full)
        else:                                      # the final norm
            add("all-reduce", 1, full)
    add("all-reduce", 3, 12)
    return out


def _leaf_paths(tree, prefix=()) -> list:
    """The key paths of a tree's tensors, in ``partitioning._map``'s
    order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaf_paths(v, prefix
                                                                + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, prefix + (i,))]
    return [prefix]


def d3_rank(rank: int, world: int, tmp: str, device_type: str, arch: str,
            runs: tuple) -> None:
    """One rank of D3: joins the gloo group in ``tmp`` and, for each
    (dtype name, steps) of ``runs`` in turn, trains ``arch`` through
    ``launch/train.train`` on the (data=``world``, model=1) host mesh (the
    parameters and AdamW moments DTensors, embed over 'data'), the plain
    attention versions armed to raise on CUDA tensors; counts each step's
    launches and collectives, keeps the K8b calls of step 1 and, after
    the run, holds each against its plain version on its own inputs; then
    ``serve_run``.  Writes ``tmp/rank<rank>.json`` ({dtype name: results,
    "serve": the serve's}); a failed check
    raises here and the rank exits nonzero."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import analysis
    from repro_torch import steps as steps_lib
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.launch import train as train_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    counted = (fp.flash_prefill, fp.flash_prefill_traj, fp.flash_prefill_bwd)
    kernel_bwd, train_step = fp.flash_prefill_bwd, steps_lib.train_step

    def one_run(dtype_name: str, steps: int) -> dict:
        cfg = dataclasses.replace(get_arch(arch), dtype=dtype_name)
        per_step, colls, captured = [], [], []
        record = {"on": False}

        def capture(*args, **kwargs):
            """K8b as the step calls it; step 1's calls kept (inputs and
            outputs) for the hold after the run.  Its launch counts are
            carried to the wrapper's."""
            capture.launches = kernel_bwd.launches
            capture.tc_launches = kernel_bwd.tc_launches
            got = kernel_bwd(*args, **kwargs)
            kernel_bwd.launches = capture.launches
            kernel_bwd.tc_launches = capture.tc_launches
            if record["on"]:
                captured.append(([a.detach().clone() if isinstance(
                    a, torch.Tensor) else a for a in args], kwargs,
                    [g.clone() for g in got]))
            return got

        def counted_step(*args, **kwargs):
            """A training step with its launches and collectives counted
            (step 1's K8b calls kept)."""
            before = {fn.__name__: fn.launches for fn in counted}
            record["on"] = not per_step
            res = {}
            got = analysis.count_collectives(
                lambda: res.update(out=train_step(*args, **kwargs)))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            per_step.append({fn.__name__: fn.launches - before[fn.__name__]
                             for fn in counted})
            colls.append({k: list(v) for k, v in sorted(got.items())})
            return res["out"]

        fp.flash_prefill_bwd = capture
        steps_lib.train_step = counted_step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        try:
            with tripwires(*plain_attention_arms()):
                rep = train_lm.train(cfg, steps=steps, batch=D3_BATCH,
                                     seq=D3_SEQ, lr=3e-3, seed=0,
                                     device=device_type, log_every=1)
        finally:
            fp.flash_prefill_bwd = kernel_bwd
            steps_lib.train_step = train_step
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else 0.0)
        share, err = {}, 0.0
        for i, (args, kwargs, got) in enumerate(captured):
            want = fp.flash_prefill_bwd_plain(
                *args, **kwargs, round_p=args[0].dtype == torch.bfloat16)
            for n, a, b in zip(("dq", "dk", "dv"), got, want):
                err = max(err, attn_grad_hold(
                    a, b, f"D3 rank {rank} {dtype_name} K8b call {i} {n}",
                    share))
        return {"losses": rep["losses"], "grad_norms": rep["grad_norms"],
                "step_ms": rep["step_ms"], "mesh": rep["mesh"],
                "launches": per_step, "collectives": colls,
                "peak_gb": peak, "k8b_checked": len(captured),
                "k8b_err": err}

    def serve_run() -> dict:
        """Prefill and ``D3_DECODE`` decode steps of ``arch`` (f32) on the
        (data=1, model=``world``) mesh over the group, the plain attention
        armed: the heads and the cache's sequence split over 'model', K8 on
        each rank's heads and K9 over its slice of the cache (its
        log-sum-exp combining the slices), each counted; the gathered
        logits against the same steps on one device."""
        from repro_torch import partitioning as pt
        from repro_torch.kernels import decode_attn as da
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models import registry, transformer

        cfg = dataclasses.replace(get_arch(arch), dtype="float32")
        model = registry.build(cfg)
        params, axes = pt.split(model.init_annot(
            torch.Generator(device=dev).manual_seed(0), dev))
        gen = torch.Generator(device=dev).manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (D3_SERVE_B, D3_PROMPT),
                             generator=gen, device=dev)
        nxt = torch.randint(0, cfg.vocab, (D3_DECODE, D3_SERVE_B),
                            generator=gen, device=dev)
        with torch.no_grad():
            cache = model.init_cache(D3_SERVE_B, D3_CACHE, dev)
            want = [model.prefill(params, cache, {"tokens": toks})[0][:, 0]]
            want += [model.decode_step(params, cache, {"tokens": t})[0]
                     for t in nxt]
        rules = pt.make_rules(mesh_lib.group_mesh(
            ("data", "model"), (1, world), device_type))
        put = lambda t, ax: pt.device_put(t, rules.sharding_for(ax, t.shape))
        dp = pt.device_put(params, pt.tree_shardings(axes, params, rules))
        c_vals, c_axes = pt.split(transformer.init_cache_annot(
            cfg, D3_SERVE_B, D3_CACHE, dev))
        dc = pt.device_put(c_vals, pt.tree_shardings(c_axes, c_vals, rules))
        k8, k9 = fp.flash_prefill.launches, da.decode_attn.launches
        with pt.use_rules(rules), torch.no_grad(), \
                tripwires(*plain_attention_arms()):
            got = [model.prefill(dp, dc, {"tokens": put(
                toks, ("batch", "seq"))})[0][:, 0]]
            k8 = fp.flash_prefill.launches - k8
            got += [model.decode_step(dp, dc, {"tokens": put(
                t, ("batch",))})[0] for t in nxt]
            k9 = da.decode_attn.launches - k9
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            err = max(err, close(pt.full_tensor(g), w, f"D3 rank {rank} "
                                 f"serve step {i}", dict(
                                     rtol=D3_SERVE_TOL, atol=D3_SERVE_TOL)))
        return {"flash_prefill": k8, "decode_attn": k9, "err": err,
                "split": {"heads": cfg.n_heads % world == 0,
                          "cache_seq": D3_CACHE % world == 0}}

    try:
        results = {name: one_run(name, steps) for name, steps in runs}
        results["serve"] = serve_run()
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def train_ranks_slice(device, world: int = D3_WORLD, arch: str = D3_ARCH
                      ) -> dict:
    """D3: the trainer on several ranks.  Qwen2-0.5B at full width and
    depth trained through ``launch/train.train`` on ``world`` gloo ranks
    spawned on the card as (data=``world``, model=1): the parameters and
    AdamW moments DTensors placed FSDP-style, batch 4 x 512 (2 rows a
    rank), remat on, weights from seed 0.  f32, ``D3_STEPS`` steps: each
    step's loss and grad_norm within ``D3_TOL`` relative of the one-device
    trainer's on the same seed and batches; each rank launches 2L K8t and
    L K8b a step and no K8, the plain attention armed to raise; step 1's
    K8b calls held against their plain version; each rank's collectives a
    step, by kind and bytes, equal to ``d3_predicted``; peak memory a
    rank.  Then bf16, ``D3_BF16_STEPS`` steps: the losses printed beside
    the one-device trainer's, held to no bound.  Then each rank's serve
    on (data=1, model=``world``) (``serve_run``): L K8 and ``D3_DECODE`` x
    L K9 launches a rank, the logits within ``D3_SERVE_TOL`` of one
    device.  Nothing is timed: ranks
    sharing one card over gloo say nothing of a multi-card step.  Returns
    the launches of the ranks' f32 and bf16 runs and serves, summed."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_lm

    launches = {"flash_prefill_traj": 0, "flash_prefill_bwd": 0}
    runs = (("float32", D3_STEPS), ("bfloat16", D3_BF16_STEPS))
    t0 = time.perf_counter()
    by_rank = _spawn_ranks(d3_rank, world, (device.type, arch, runs), 900)
    print(f"[D3] {world} ranks, {arch}, f32 {D3_STEPS} steps then bf16 "
          f"{D3_BF16_STEPS} of {D3_BATCH} x {D3_SEQ}: "
          f"{time.perf_counter() - t0:.1f} s of command (spawn, draws, "
          "training, the K8b holds)")
    free_models("D3")
    for dtype_name, n_steps in runs:
        cfg = dataclasses.replace(get_arch(arch), dtype=dtype_name)
        n_attn = sum(cfg.layer_kind(i) == "attn"
                     for i in range(cfg.n_layers))
        ranks = [res[dtype_name] for res in by_rank]
        one = train_lm.train(cfg, steps=n_steps, batch=D3_BATCH, seq=D3_SEQ,
                             lr=3e-3, seed=0, device=device.type,
                             log_every=1)
        del one["params"]
        want = d3_predicted(cfg, world)
        for j, res in enumerate(ranks):
            check(res["mesh"] == {"data": world, "model": 1},
                  f"D3 rank {j}: mesh {res['mesh']}")
            print(f"[D3] rank {j} {dtype_name} losses {res['losses']} "
                  f"(one device {one['losses']}); grad_norm "
                  f"{res['grad_norms']} (one device {one['grad_norms']})")
            if dtype_name == "float32":
                for i, (a, b, ga, gb) in enumerate(zip(
                        res["losses"], one["losses"], res["grad_norms"],
                        one["grad_norms"])):
                    check(abs(a - b) <= D3_TOL * abs(b),
                          f"D3 rank {j} step {i + 1}: loss {a} vs one "
                          f"device {b} (rel {abs(a - b) / abs(b):.2e})")
                    check(abs(ga - gb) <= D3_TOL * abs(gb),
                          f"D3 rank {j} step {i + 1}: grad_norm {ga} vs "
                          f"one device {gb}")
                gap = {k: max(abs(a - b) / abs(b)
                              for a, b in zip(res[k], one[k]))
                       for k in ("losses", "grad_norms")}
                print(f"[D3] rank {j} f32 worst relative gap: loss "
                      f"{gap['losses']:.3e}, grad_norm "
                      f"{gap['grad_norms']:.3e} (bound {D3_TOL})")
            for i, got in enumerate(res["launches"]):
                if device.type == "cuda":
                    check(got == {"flash_prefill": 0,
                                  "flash_prefill_traj": 2 * n_attn,
                                  "flash_prefill_bwd": n_attn},
                          f"D3 rank {j} step {i + 1}: launches {got}")
                for k in launches:
                    launches[k] += got[k]
            check(res["k8b_checked"] == n_attn,
                  f"D3 rank {j}: {res['k8b_checked']} K8b calls of step 1 "
                  "held")
            print(f"[D3] rank {j} {dtype_name}: step 1's {n_attn} K8b calls "
                  f"vs plain, max abs err {res['k8b_err']:.3e}; peak memory "
                  f"{res['peak_gb']:.3f} GB (torch.cuda.max_memory_allocated"
                  f", this rank's process); {CARD['line']}")
            for i, got in enumerate(res["collectives"]):
                print(f"[D3] rank {j} {dtype_name} step {i + 1} collectives "
                      f"{got} (predicted {want})")
                check(got == want, f"D3 rank {j} step {i + 1}: collectives "
                      f"{got}, {want} predicted")
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    for j, res in enumerate(by_rank):
        srv = res["serve"]
        if device.type == "cuda":
            check(srv["flash_prefill"] == n_attn
                  and srv["decode_attn"] == n_attn * D3_DECODE,
                  f"D3 rank {j} serve: launches K8 {srv['flash_prefill']}, "
                  f"K9 {srv['decode_attn']}")
        for k in ("flash_prefill", "decode_attn"):
            launches[k] = launches.get(k, 0) + srv[k]
        print(f"[D3] rank {j} serve on (data=1, model={world}), split "
              f"{srv['split']}: prefill {D3_SERVE_B} x {D3_PROMPT} + "
              f"{D3_DECODE} decode steps, f32; {srv['flash_prefill']} K8 "
              f"and {srv['decode_attn']} K9 launches (log-sum-exp out, "
              f"combined over 'model'); logits vs one device max abs err "
              f"{srv['err']:.3e} ({D3_SERVE_TOL})")
    return launches


def dryrun_slice(device, jobs: int = 8, limit: float = 420.0) -> dict:
    """D4: the production-mesh dry run, ``python -m
    repro_torch.launch.dryrun`` in a process of its own (its ``fake``
    group of 256 or 512 ranks cannot share one with D2's and D3's): every
    arch x input shape on pod1 and one case a family on pod2, ``jobs``
    cases at a time, each traced on meta DTensors over a mesh of the
    card's device type.  Every case must pass; each one's trace seconds,
    the three roofline terms (modelled from published rates: the H100's
    bf16 peak, HBM rate, NVLink 4 and NDR links; nothing timed), the
    dominant term, collective bytes by kind and argument bytes a rank are
    printed, and the collective term must be non-zero.  Returns the
    records."""
    import tempfile

    from repro_torch.configs import ARCHS, INPUT_SHAPES

    pod2 = ("rwkv6-3b,train_4k,pod2", "qwen2-0.5b,decode_32k,pod2",
            "olmoe-1b-7b,prefill_32k,pod2",
            "jamba-1.5-large-398b,long_500k,pod2",
            "internvl2-1b,train_4k,pod2", "musicgen-large,prefill_32k,pod2")
    cases = [f"{a},{s},pod1" for a in ARCHS for s in INPUT_SHAPES] + \
        list(pod2)
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--device", device.type, "--out", tmp, "--force", "--jobs",
               str(jobs)] + [a for c in cases for a in ("--case", c)]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=limit)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"D4: the dry run exited "
              f"{proc.returncode}: {proc.stdout[-3000:]} "
              f"{proc.stderr[-3000:]}")
        records = {}
        for c in cases:
            arch, shape, mesh = c.split(",")
            with open(f"{tmp}/{arch}__{shape}__{mesh}.json") as f:
                records[c] = json.load(f)
    for c, rec in records.items():
        r = rec["roofline"]
        check(rec["ok"] and r["t_collective_s"] > 0,
              f"D4 {c}: collective term {r['t_collective_s']}")
        print(f"[D4] {c}: traced in {rec['trace_s']} s; modelled terms "
              f"(published rates, not measured) compute "
              f"{r['t_compute_s']:.3e} s, memory {r['t_memory_s']:.3e} s, "
              f"collective {r['t_collective_s']:.3e} s, dominant "
              f"{r['dominant']}; collective bytes a rank "
              f"{rec['collective_bytes']}; argument bytes a rank "
              f"{rec['argument_bytes']:,}; launches {rec['launches']}")
    print(f"[D4] {len(records)} cases ({len(cases) - len(pod2)} on pod1, "
          f"{len(pod2)} on pod2) in {wall:.1f} s of command, {jobs} at a "
          f"time; {CARD['line']}")
    return records


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

    from repro_torch.analysis import BF16_FLOP_PER_S, bound
    from repro_torch.configs.mobirnn_lstm import LSTMConfig
    from repro_torch.core import factorization, lstm, plans
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
               mamba_k.mamba_scan_bwd, fp_k.flash_prefill,
               fp_k.flash_prefill_traj, fp_k.flash_prefill_bwd,
               da_k.decode_attn)

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
    CARD["line"] = card
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    sm_clock_hz = float(clocks.stdout.strip().splitlines()[0]) * 1e6
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    # --- 1. build ---------------------------------------------------------
    t_start = t0 = time.perf_counter()
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

    # --- 3e. the bf16 instances -------------------------------------------
    # K1, K2/K2t, K3 and the int8 stack over bf16 x against their plain
    # versions: a bf16 result within one bf16 step of the plain one (2^-7
    # of its largest entry), the f32 trajectories at TOL, an int8 stack's
    # f32 dw and db at GRAD_TOL.  Each bf16 instance equals its f32
    # instance run on the widened operands, bit for bit, its bf16 outputs
    # rounded once: a bf16 value widens to f32 exactly, so the bf16
    # instances run the f32 multiply-add chains (and K3's recompute is K2t's)
    BF16 = torch.bfloat16
    bf16_errs = {n: 0.0 for n in ("lstm_cell", "lstm_seq", "lstm_seq_traj",
                                  "lstm_seq_bwd", "lstm_seq_q8",
                                  "lstm_seq_q8_traj", "lstm_seq_bwd_q8")}

    def step_err(got, want, what: str) -> float:
        """The max abs error of a bf16 result, checked against one bf16
        step of the plain version's largest entry."""
        e = float((got.float() - want.float()).abs().max())
        check(got.dtype == want.dtype == BF16
              and e <= 2.0 ** -7 * float(want.float().abs().max()),
              f"{what}: max abs err {e} past one bf16 step of "
              f"{float(want.float().abs().max())}")
        return e

    def widened(*ts):
        return [t.float() if t.dtype == BF16 else t for t in ts]

    def same_bits(got, f32, what: str) -> None:
        """``got`` (bf16 instance) against ``f32`` (the f32 instance on the
        widened operands): equal after rounding each of f32's bf16
        counterparts once."""
        check(all(torch.equal(g, r.to(g.dtype)) for g, r in zip(got, f32)),
              f"{what}: the bf16 instance differs from the f32 instance on "
              "the widened operands")

    for B, D, H in [(1, 9, 32), (1, 32, 32), (64, 9, 32), (64, 32, 32),
                    (5, 9, 20), (1, 9, 64), (1, 64, 64)]:
        w = randn(D + H, 4 * H, gen=gen, scale=(D + H) ** -0.5).to(BF16)
        b = randn(4 * H, gen=gen, scale=0.1).to(BF16)
        x = randn(B, 3, D, gen=gen).to(BF16)[:, 1]
        c = randn(B, H, gen=gen).to(BF16)
        h = randn(B, H, gen=gen).to(BF16)
        got = cell_k.lstm_cell(w, b, x, c, h)
        err = max(step_err(g, r, f"lstm_cell bf16 B={B} D={D} H={H}")
                  for g, r in zip(got, cell_k.lstm_cell_plain(w, b, x, c, h)))
        again = cell_k.lstm_cell(w, b, x, c, h)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"lstm_cell bf16 B={B} D={D} H={H}: two runs differ")
        same_bits(got, cell_k.lstm_cell(*widened(w, b, x, c, h)),
                  f"lstm_cell bf16 B={B} D={D} H={H}")
        bf16_errs["lstm_cell"] = max(bf16_errs["lstm_cell"], err)
        print(f"[K1 bf16] lstm_cell B={B} D={D} H={H}: max abs err "
              f"{err:.3e}; two runs and the f32 instance on the widened "
              "operands bit-identical")

    def fits_f32(L_, P_, H_, B_, T_, mode="fwd") -> bool:
        return seq_k.choose_batch_block(B_, T_, L_, P_, H_, mode=mode) \
            is not None

    bf16_cases = cases + [("2x64 T=128 B=1", (2, 64, 64, 1, 128), {}),
                          ("3x64 T=128 B=1", (3, 64, 64, 1, 128), {})]
    for label, shape, kw in bf16_cases:
        w, b, x = seq_case(*shape)
        L_, P_, H_, B_, T_ = shape
        wb, bb, xb = w.to(BF16), b.to(BF16), x.to(BF16)
        table = seq_k.choose_batch_block(B_, T_, L_, P_, H_, dtype_bytes=2,
                                         w_dtype_bytes=2)
        got = seq_k.lstm_seq(wb, bb, xb, **kw)
        err = max(step_err(g, r, f"lstm_seq bf16 {label}") for g, r in
                  zip(got, seq_k.lstm_seq_plain(wb, bb, xb)))
        traj = seq_k.lstm_seq_traj(wb, bb, xb, **kw)
        terr = max(close(g, r, f"lstm_seq_traj bf16 {label}") for g, r in
                   zip(traj[2:], ref.lstm_seq_traj(wb, bb, xb)[2:]))
        check(torch.equal(traj[0], got[0]) and torch.equal(traj[1], got[1]),
              f"lstm_seq_traj bf16 {label}: final (c, h) differ from the "
              "plain launch")
        if fits_f32(*shape):
            same_bits(traj, seq_k.lstm_seq_traj(*widened(wb, bb, xb), **kw),
                      f"lstm_seq_traj bf16 {label}")
        wq, s = ref.quantize_q8(w)
        gq = seq_k.lstm_seq_q8(w, b, xb, **kw)
        qerr = max(step_err(g, r, f"lstm_seq_q8 bf16 x {label}") for g, r in
                   zip(gq, seq_k.lstm_seq_q8_plain(wq, s, b, xb)))
        tq = seq_k.lstm_seq_q8_traj(wq, s, b, xb, **kw)
        tqerr = max(close(g, r, f"lstm_seq_q8_traj bf16 x {label}")
                    for g, r in zip(tq[2:], seq_k.lstm_seq_q8_traj_plain(
                        wq, s, b, xb)[2:]))
        check(torch.equal(tq[0], gq[0]) and torch.equal(tq[1], gq[1]),
              f"lstm_seq_q8_traj bf16 x {label}: final (c, h) differ")
        same_bits(tq, seq_k.lstm_seq_q8_traj(wq, s, b, xb.float(), **kw),
                  f"lstm_seq_q8_traj bf16 x {label}")
        for name, e in (("lstm_seq", err), ("lstm_seq_traj", terr),
                        ("lstm_seq_q8", qerr), ("lstm_seq_q8_traj", tqerr)):
            bf16_errs[name] = max(bf16_errs[name], e)
        home = seq_k.weight_home(L_, P_, H_, kw.get("block_b",
                                                    table.block_b))
        print(f"[K2 bf16] {label}: the bf16 table picks {tuple(table)} "
              f"(block_b, time_chunk), {home} weights; lstm_seq {err:.3e}, "
              f"lstm_seq_traj {terr:.3e} (f32 trajectories); int8 over bf16 "
              f"x {qerr:.3e}, trajectories {tqerr:.3e}; final (c, h) of the "
              "trajectory launches equal the plain launches'"
              + ("; the f32 instance on the widened operands bit-identical"
                 if fits_f32(*shape) else
                 "; the f32 stack fits no block here"))
    w, b, x = seq_case(2, 32, 32, 3, 50)
    for q8 in (False, True):
        ops = (w, b, x.to(BF16)) if q8 else (w.to(BF16), b.to(BF16),
                                              x.to(BF16))
        base = wave_runs(*ops, q8, block_b=1)
        for block_b, tc in ((1, None), (1, 8), (1, 1), (2, None), (4, 8),
                            (16, None)):
            got = wave_runs(*ops, q8, block_b=block_b, time_chunk=tc)
            check(all(torch.equal(g, r) for g, r in zip(
                (*got[0], *got[1]), (*base[0], *base[1]))),
                  f"bf16 q8={q8} tile {block_b} tc {tc} differs from tile 1")
    print("[K2 bf16] 2x32 B=3 T=50, bf16 and int8 over bf16 x: tile 1 "
          "(register weights, whole, 8- and 1-step chunks, two runs) and "
          "tiles 2, 4, 16 (shared weights) give the same bits, forward and "
          "trajectories")

    def f32_chunk(shape, block_b, tc) -> int | None:
        """A time chunk at which the f32 backward fits ``block_b`` rows:
        ``tc`` when it does, else 1 (gradients do not depend on it)."""
        L_, P_, H_, B_, T_ = shape
        ok = seq_k.working_set_bytes(T_, L_, P_, H_, block_b, mode="bwd",
                                     time_chunk=tc) <= \
            factorization.H100_SMEM_PER_BLOCK
        return tc if ok else 1

    for label, shape, tiles in bwd_cases:
        w, b, x, dc, dh = bwd_case(*shape)
        L_, P_, H_, B_, T_ = shape
        ops = [t.to(BF16) for t in (w, b, x, dc, dh)]
        tiles = tiles or tuple(seq_k.choose_batch_block(
            B_, T_, L_, P_, H_, dtype_bytes=2, w_dtype_bytes=2, mode="bwd"))
        kw = dict(block_b=tiles[0], time_chunk=tiles[1])
        _, _, ct, ht = seq_k.lstm_seq_traj(*ops[:3], **kw)
        got = bwd_k.lstm_seq_bwd(*ops[:3], ct, ht, *ops[3:], **kw)
        err = max(step_err(g, r, f"lstm_seq_bwd bf16 {label} {n}")
                  for n, g, r in zip(("dw", "db", "dx"), got,
                                     bwd_k.lstm_seq_bwd_plain(
                                         *ops[:3], ct, ht, *ops[3:])))
        again = bwd_k.lstm_seq_bwd(*ops[:3], ct, ht, *ops[3:], **kw)
        check(all(torch.equal(g, r) for g, r in zip(got, again)),
              f"lstm_seq_bwd bf16 {label}: two calls differ")
        f32_kw = dict(block_b=tiles[0],
                      time_chunk=f32_chunk(shape, tiles[0], tiles[1]))
        same_bits(got, bwd_k.lstm_seq_bwd(*widened(*ops[:3]), ct, ht,
                                          *widened(*ops[3:]), **f32_kw),
                  f"lstm_seq_bwd bf16 {label}")
        # the int8 stack over bf16 x: f32 dw, db; bf16 dx
        wq, s = ref.quantize_q8(w)
        _, _, ctq, htq = seq_k.lstm_seq_q8_traj(wq, s, b, ops[2], **kw)
        gq = bwd_k.lstm_seq_bwd_q8(wq, s, b, ops[2], ctq, htq, *ops[3:],
                                   **kw)
        pq = bwd_k.lstm_seq_bwd_plain(wq, b, ops[2], ctq, htq, *ops[3:],
                                      scales=s)
        qerr = max(close(gq[0], pq[0], f"lstm_seq_bwd_q8 bf16 x {label} dw",
                         GRAD_TOL),
                   close(gq[1], pq[1], f"lstm_seq_bwd_q8 bf16 x {label} db",
                         GRAD_TOL),
                   step_err(gq[2], pq[2], f"lstm_seq_bwd_q8 bf16 x {label} "
                            "dx"))
        same_bits(gq, bwd_k.lstm_seq_bwd_q8(
            wq, s, b, ops[2].float(), ctq, htq, *widened(*ops[3:]),
            **f32_kw), f"lstm_seq_bwd_q8 bf16 x {label}")
        bf16_errs["lstm_seq_bwd"] = max(bf16_errs["lstm_seq_bwd"], err)
        bf16_errs["lstm_seq_bwd_q8"] = max(bf16_errs["lstm_seq_bwd_q8"],
                                           qerr)
        print(f"[K3 bf16] {label} tiles {tiles}: max abs err {err:.3e} vs "
              f"plain (dw, db, dx bf16), int8 over bf16 x {qerr:.3e}; two "
              "calls and the f32 instances on the widened operands "
              "bit-identical")
    for B_, block_b, T_, chunks in [(1, 1, 128, (None, 1, 48)),
                                    (64, 1, 128, (None, 1, 48)),
                                    (37, 8, 50, (1, 3, 4))]:
        w, b, x, dc, dh = bwd_case(2, 32, 32, B_, T_)
        ops = [t.to(BF16) for t in (w, b, x, dc, dh)]
        outs = []
        for tc in chunks:
            _, _, ct, ht = seq_k.lstm_seq_traj(*ops[:3], block_b=block_b,
                                               time_chunk=tc)
            outs.append(bwd_k.lstm_seq_bwd(*ops[:3], ct, ht, *ops[3:],
                                           block_b=block_b, time_chunk=tc))
        check(all(torch.equal(g, r) for out in outs[1:]
                  for g, r in zip(out, outs[0])),
              f"lstm_seq_bwd bf16 B={B_} T={T_}: time_chunk {chunks} differ")
        print(f"[K3 bf16] gradients bit-identical across time_chunk {chunks}"
              f" (B={B_}, block_b={block_b}, T={T_})")

    # the bf16 serving path: all five plans through classify.serve with a
    # bf16 config, counted, the plain versions (K1's too) armed
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    bf16_tol = plans.LSTM_TOL["bfloat16"]

    def policy16(plan: str) -> dict:
        """The bf16 tolerance against bf16 ``sequential``: LSTM_TOL's, or
        Q8_BAND for the int8 plan (whose band is f32-only in the family)."""
        return plans.Q8_BAND if plan == "fused_seq_q8" else bf16_tol

    def bf16_counts() -> dict:
        return {fn.__name__: fn.bf16_launches for fn in counted
                if hasattr(fn, "bf16_launches")}

    reset_counts(*counted)
    with tripwires(*plain_versions, (cell_k, "lstm_cell_plain")):
        served16 = classify.serve(cfg16, device, requests=32, plan="auto",
                                  seed=0)
    launches16 = counts()
    serve16_bf16 = bf16_counts()
    print(f"[bf16] serving path launches: {launches16}, on bf16 instances "
          f"{serve16_bf16}")
    for name in ("lstm_cell", "lstm_seq", "lstm_seq_q8"):
        check(serve16_bf16[name] == launches16[name] > 0,
              f"{name}: {serve16_bf16[name]} of {launches16[name]} bf16 "
              "serving launches on the bf16 instance")
    check(all(launches16[n] == 0 for n in (
        "lstm_seq_traj", "lstm_seq_bwd", "lstm_seq_q8_traj",
        "lstm_seq_bwd_q8")), "bf16 serving launched a training kernel")
    check(served16["logits"].shape == (32, cfg.n_classes)
          and served16["logits"].dtype == BF16
          and bool(torch.isfinite(served16["logits"]).all()),
          "bf16 served logits are not finite bf16 (32, 6)")
    p16 = lstm.LSTMClassifier(
        cfg16, generator=torch.Generator().manual_seed(0)).to(device).params()
    with torch.inference_mode():
        asked16 = har_windows(32).to(BF16)
        close(served16["logits"].float(), torch.cat([
            lstm.forward_sequential(p16, asked16[j:j + 1], cfg16)
            for j in range(32)]).float(),
            f"bf16 served through {served16['served']} vs sequential",
            policy16(served16["served"]))
        windows16 = har_windows(64).to(BF16)
        ref16 = lstm.forward_sequential(p16, windows16, cfg16).float()
        for name, fwd in lstm.FORWARD_PLANS.items():
            e = close(fwd(p16, windows16, cfg16).float(), ref16,
                      f"bf16 {name} batch of 64", policy16(name))
            print(f"[bf16] {name}: batch of 64 within {policy16(name)} of "
                  f"bf16 sequential (max abs err {e:.3e})")
        for B_ in (1, 64):
            for fwd, want in ((lstm.forward_fused_seq, only(lstm_seq=1)),
                              (lstm.forward_fused_seq_q8,
                               only(lstm_seq_q8=1)),
                              (lstm.forward_fused_kernel,
                               only(lstm_cell=T * L))):
                reset_counts(*counted)
                fwd(p16, windows16[:B_], cfg16)
                check(counts() == want and all(
                    bf16_counts()[n] == want[n] for n in bf16_counts()),
                      f"bf16 {fwd.__name__} B={B_}: {counts()}, "
                      f"{bf16_counts()}")
                check(seq_k.lstm_seq.reg_launches == want["lstm_seq"]
                      and seq_k.lstm_seq_q8.reg_launches
                      == want["lstm_seq_q8"],
                      f"bf16 {fwd.__name__} B={B_}: not on the register home")
    print(f"[bf16] launches per forward: fused_seq 1 and fused_seq_q8 1 "
          f"(register weights), fused_cell {T * L} (T x L), at B=1 and 64, "
          "all on the bf16 instances")
    print(f"[bf16] HAR p50 of one window: fused_seq "
          f"{served16['table']['fused_seq']['p50_ms']:.3f} ms (f32 "
          f"{served['table']['fused_seq']['p50_ms']:.3f}), fused_seq_q8 "
          f"{served16['table']['fused_seq_q8']['p50_ms']:.3f}, fused_cell "
          f"{served16['table']['fused_cell']['p50_ms']:.3f}; scheduler chose "
          f"{served16['chosen']} ({card})")

    # 2 x 64 in bf16: the halved stack serves in one K2 launch a request
    cfg64_16 = dataclasses.replace(wide64, dtype="bfloat16")
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        reset_counts(*counted)
        with tripwires(*plain_versions, (cell_k, "lstm_cell_plain")):
            served64_16 = classify.serve(cfg64_16, device, requests=16,
                                         plan="fused_seq", seed=0)
        got = counts()
        got16 = bf16_counts()
    finally:
        trace_lib.set_tracer(old)
    events = [r["attrs"] for r in sink.records
              if r["name"] == "plan/dispatch"]
    calls = 2 * (1 + 16)
    check(got == only(lstm_seq=calls) and got16["lstm_seq"] == calls
          and events and all("fallback" not in e for e in events),
          f"2 x 64 bf16 fused_seq: {got}, {got16}, {events[:1]}")
    p64_16 = lstm.LSTMClassifier(
        cfg64_16, generator=torch.Generator().manual_seed(0)
    ).to(device).params()
    with torch.inference_mode():
        asked64_16 = har_windows(16).to(BF16)
        e = close(served64_16["logits"].float(), torch.cat([
            lstm.forward_sequential(p64_16, asked64_16[j:j + 1], cfg64_16)
            for j in range(16)]).float(), "2 x 64 bf16 fused_seq", bf16_tol)
    p64_tile = seq_k.choose_batch_block(1, T, 2, 64, 64, dtype_bytes=2,
                                        w_dtype_bytes=2)
    print(f"[bf16] 2 x 64, B=1: fused_seq 1 bf16 K2 launch a request at tile "
          f"{tuple(p64_tile)} (p50 "
          f"{served64_16['table']['fused_seq']['p50_ms']:.3f} ms, max abs "
          f"err {e:.3e} vs bf16 sequential) beside f32 fused_seq on "
          f"fused_cell, {T * L} launches (p50 "
          f"{served64['fused_seq']['table']['fused_seq']['p50_ms']:.3f} ms)")

    # the bf16 training paths: 20 train_har steps through fused_seq and
    # fused_seq_q8, counted, the plain versions armed
    runs16, train16, train16_bf16 = {}, {}, {}
    for plan in ("fused_seq", "fused_seq_q8"):
        sink = trace_lib.ListSink()
        old = trace_lib.set_tracer(trace_lib.Tracer(sink))
        try:
            reset_counts(*counted)
            with tripwires(*plain_versions):
                runs16[plan] = train_har.train(
                    cfg16, device, plan=plan, steps=20, batch=64,
                    n_train=512, n_test=256, latency_cases=0, seed=0)
            train16[plan] = counts()
            train16_bf16[plan] = bf16_counts()
        finally:
            trace_lib.set_tracer(old)
        suffix = "_q8" if plan == "fused_seq_q8" else ""
        want = only(**{f"lstm_seq{suffix}_traj": 20,
                       f"lstm_seq_bwd{suffix}": 20, f"lstm_seq{suffix}": 2})
        check(train16[plan] == want and all(
            train16_bf16[plan][n] == want[n] for n in train16_bf16[plan]),
              f"20 bf16 {plan} steps launched {train16[plan]}, bf16 "
              f"{train16_bf16[plan]}")
        losses = runs16[plan]["losses"]
        check(len(losses) == 20 and all(map(math.isfinite, losses))
              and losses[-1] < losses[0],
              f"bf16 {plan} losses not finite or not falling: {losses}")
        events = [r["attrs"] for r in sink.records
                  if r["name"] == "plan/dispatch" and r["attrs"]["train"]]
        check(len(events) == 20 and all(
            "fallback" not in e and e["bwd_block_b"] >= 1 for e in events),
              f"a bf16 {plan} training call left its kernels: {events[:1]}")
        print(f"[bf16 train] {plan}: 20 steps, 2 launches a step on the bf16"
              f" instances ({train16[plan]}); losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; median step "
              f"{statistics.median(runs16[plan]['step_ms']):.3f} ms")
    seq16 = train_har.train(cfg16, device, plan="sequential", steps=20,
                            batch=64, n_train=512, n_test=256,
                            latency_cases=0, seed=0)
    grad16 = plans.LSTM_GRAD_TOL["bfloat16"]
    for plan in ("fused_seq", "fused_seq_q8"):
        for i in range(3):
            check(math.isclose(runs16[plan]["losses"][i], seq16["losses"][i],
                               rel_tol=grad16["rtol"],
                               abs_tol=grad16["atol"]),
                  f"bf16 step {i + 1}: {plan} loss "
                  f"{runs16[plan]['losses'][i]} vs sequential "
                  f"{seq16['losses'][i]}")
        print(f"[bf16 train] first 3 {plan} losses "
              f"{runs16[plan]['losses'][:3]} agree with bf16 sequential's "
              f"{seq16['losses'][:3]} at {grad16}")
    # 2 x 64 bf16 trains on fused_cell: the f32 dW accumulators alone fill
    # a block
    wp = lstm.LSTMClassifier(
        cfg64_16, generator=torch.Generator().manual_seed(2)
    ).to(device).params()
    xs = randn(4, 16, cfg.input_dim, gen=gen).to(BF16)
    ys = torch.randint(0, cfg.n_classes, (4,), generator=gen).to(device)
    sink = trace_lib.ListSink()
    old = trace_lib.set_tracer(trace_lib.Tracer(sink))
    try:
        reset_counts(*counted)
        got = torch.autograd.grad(lstm.loss_fn(
            wp, xs, ys, cfg64_16, forward=lstm.forward_fused_seq),
            tree_leaves(wp))
        wide_launches = counts()
    finally:
        trace_lib.set_tracer(old)
    events = [r["attrs"] for r in sink.records
              if r["name"] == "plan/dispatch"]
    check(wide_launches == only(lstm_cell=16 * 2)
          and cell_k.lstm_cell.bf16_launches == 16 * 2
          and len(events) == 1 and events[0].get("fallback") == "fused_cell",
          f"2 x 64 bf16 fused_seq training step: {wide_launches}, {events}")
    want = torch.autograd.grad(lstm.loss_fn(wp, xs, ys, cfg64_16),
                               tree_leaves(wp))
    for g, r in zip(got, want):
        close(g.float(), r.float(), "2 x 64 bf16 grads vs sequential",
              grad16)
    print("[bf16 train] 2 x 64 (the bf16 backward fits no block): a "
          "fused_seq step runs on the bf16 K1 with the event and bf16 "
          "sequential's grads")

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
    with torch.no_grad():
        # the bf16 instances beside their f32 instances (this call's rows
        # above): back to back and in a CUDA graph, the bound at 2 bytes an
        # element (the trajectories 4) and at the bf16 peak (the inputs'
        # type; the kernels' FMAs are f32), the plain version and the
        # library in bf16 (nn.LSTM / nn.LSTMCell moved to bf16; its
        # difference from the kernel printed beside, not gated)
        def lib_err(got, want) -> float:
            return max(float((g.float() - r.float()).abs().max())
                       for g, r in zip(got, want))

        def cell_row16(B: int, lw: dict, extra: bool = False) -> dict:
            H = lw["b"].numel() // 4
            D = lw["w"].shape[0] - H
            x = randn(B, D, gen=gen).to(BF16)
            c = randn(B, H, gen=gen).to(BF16)
            h = randn(B, H, gen=gen).to(BF16)
            lib = torch.nn.LSTMCell(D, H).to(device).requires_grad_(False)
            lib.weight_ih.copy_(lw["w"][:D].T)
            lib.weight_hh.copy_(lw["w"][D:].T)
            lib.bias_ih.copy_(lw["b"])
            lib.bias_hh.zero_()
            lib = lib.to(BF16)
            call = lambda: cell_k.lstm_cell(lw["w"], lw["b"], x, c,  # noqa
                                            h)
            t_bound, by = bound(2 * (lw["w"].numel() + lw["b"].numel()
                                     + B * D + 4 * B * H),
                                2 * B * (D + H) * 4 * H, BF16_FLOP_PER_S)
            return dict(
                name="lstm_cell_bf16", B=B, shape=f"B={B} D={D} H={H} bf16",
                extra=extra, ms=time_ms(call, 200),
                cell_graph_ms=graph_ms(call),
                plain_ms=time_ms(lambda: cell_k.lstm_cell_plain(
                    lw["w"], lw["b"], x, c, h), 200),
                library_ms=time_ms(lambda: lib(x, (h, c)), 200),
                library_graph_ms=graph_ms(lambda: lib(x, (h, c))),
                library_err=lib_err(lib(x, (h, c))[::-1], call()),
                bound_ms=t_bound, bound_by=by)

        def seq_rows16(lw_list, xw, B: int, train: bool,
                       extra: bool = False) -> list[dict]:
            """K2 bf16 and the int8 stack over bf16 x at the serving
            tiling; with ``train``, K2t, K3 and their int8-over-bf16
            instances at the backward's tiling."""
            Hs = lw_list[0]["b"].numel() // 4
            w16, b16, P_ = seq_k.stack_params(lw_list, Hs)
            L_, T_ = w16.shape[0], xw.shape[1]
            xp16 = seq_k.pad_input(xw[:B].to(BF16), P_)
            w32, b32 = w16.float(), b16.float()
            wq, s = ref.quantize_q8(w32)
            lib = cudnn_lstm(w32, b32, P_).to(BF16)
            lib.flatten_parameters()     # one weight buffer, as cuDNN takes
            shape = f"B={B} T={T_} L={L_} P={P_} H={Hs} bf16"
            flops = T_ * 2 * B * 4 * Hs * ((P_ + Hs) + (L_ - 1) * 2 * Hs)
            out = []
            for name, wk, sk, bk in (("lstm_seq_bf16", w16, None, b16),
                                     ("lstm_seq_q8_bf16", wq, s, b32)):
                fwd = seq_k.choose_batch_block(B, T_, L_, P_, Hs,
                                               **seq_k._bytes(wk, xp16))
                launch = lambda: seq_k._launch(  # noqa: E731
                    wk, bk, xp16, fwd.block_b, fwd.time_chunk, False, sk)
                w_bytes = wk.numel() * wk.element_size() + (
                    0 if sk is None else 4 * sk.numel())
                t_bound, by = bound(w_bytes + bk.numel() * bk.element_size()
                                    + 2 * (xp16.numel() + 2 * L_ * B * Hs),
                                    flops, BF16_FLOP_PER_S)
                if sk is None:
                    entry = lambda: seq_k.lstm_seq(w16, b16, xp16)  # noqa
                    plain = lambda: seq_k.lstm_seq_plain(  # noqa: E731
                        w16, b16, xp16)
                else:
                    entry = lambda: seq_k.lstm_seq_q8(w32, b32, xp16)  # noqa
                    plain = lambda: seq_k.lstm_seq_q8_plain(  # noqa: E731
                        wq, s, b32, xp16)
                out.append(dict(
                    name=name, B=B, extra=extra, shape=shape + (
                        " (int8 stack)" if sk is not None else ""),
                    tiles=tuple(fwd),
                    home=seq_k.weight_home(L_, P_, Hs, fwd.block_b),
                    ms=time_ms(launch, 100), graph_ms=graph_ms(launch),
                    entry_ms=time_ms(entry, 100), plain_ms=time_ms(plain, 2),
                    library_ms=time_ms(lambda: lib(xp16), 50),
                    library_graph_ms=library_graph_ms(lambda: lib(xp16)),
                    library_err=lib_err(lib(xp16)[1][::-1], entry()),
                    chain_ms=chain_bound_ms(T_, L_, P_, Hs),
                    bound_ms=t_bound, bound_by=by))
            if not train:
                return out
            dc = torch.zeros(L_, B, Hs, device=device, dtype=BF16)
            dh = randn(L_, B, Hs, gen=gen).to(BF16)
            xg = xp16.clone().requires_grad_()
            lib.requires_grad_(True)
            with torch.enable_grad():
                _, (h_lib, c_lib) = lib(xg)
                lib_in = [xg, *lib.parameters()]
                traj_lib_ms = time_ms(lambda: lib(xg), 50)
                traj_lib_graph = library_graph_ms(lambda: lib(xg))
                bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                    (h_lib, c_lib), lib_in, (dh, dc), retain_graph=True), 50)
            state = 2 * T_ * L_ * B * Hs
            for suffix, wk, sk, bk in (("_bf16", w16, None, b16),
                                       ("_q8_bf16", wq, s, b32)):
                tiles = seq_k.choose_batch_block(
                    B, T_, L_, P_, Hs, mode="bwd", **seq_k._bytes(wk, xp16))
                kw = dict(block_b=tiles.block_b, time_chunk=tiles.time_chunk)
                if sk is None:
                    _, _, ct, ht = seq_k.lstm_seq_traj(wk, bk, xp16, **kw)
                    bwd = lambda: bwd_k.lstm_seq_bwd(  # noqa: E731
                        wk, bk, xp16, ct, ht, dc, dh, **kw)
                else:
                    _, _, ct, ht = seq_k.lstm_seq_q8_traj(wk, sk, bk, xp16,
                                                          **kw)
                    bwd = lambda: bwd_k.lstm_seq_bwd_q8(  # noqa: E731
                        wk, sk, bk, xp16, ct, ht, dc, dh, **kw)
                traj = lambda: seq_k._launch(  # noqa: E731
                    wk, bk, xp16, tiles.block_b, tiles.time_chunk, True, sk)
                w_bytes = wk.numel() * wk.element_size() + (
                    0 if sk is None else 4 * sk.numel())
                b_bytes = bk.numel() * bk.element_size()
                home = seq_k.weight_home(L_, P_, Hs, tiles.block_b)
                t_bound, by = bound(w_bytes + b_bytes + 2 * (
                    xp16.numel() + 2 * L_ * B * Hs) + 4 * state, flops,
                    BF16_FLOP_PER_S)
                base = "lstm_seq_q8" if sk is not None else "lstm_seq"
                tshape = shape + f" tiles {tuple(tiles)}"
                out.append(dict(
                    name=f"{base}_traj_bf16", B=B, extra=extra, shape=tshape,
                    tiles=tuple(tiles), home=home, ms=time_ms(traj, 100),
                    graph_ms=graph_ms(traj), entry_ms=time_ms(traj, 100),
                    plain_ms=time_ms(lambda: ref.lstm_seq_traj(
                        wk.float() if sk is None else ref.dequantize_q8(
                            wk, sk), bk, xp16), 2),
                    library_ms=traj_lib_ms, library_graph_ms=traj_lib_graph,
                    chain_ms=chain_bound_ms(T_, L_, P_, Hs),
                    bound_ms=t_bound, bound_by=by))
                # w, b, x, the trajectories, dc, dh in; dw, db (the
                # stack's, f32 for int8) and dx out
                g_bytes = 4 if sk is not None else 2
                t_bound, by = bound(
                    w_bytes + b_bytes + 2 * (2 * xp16.numel()
                                             + 2 * L_ * B * Hs) + 4 * state
                    + g_bytes * (wk.numel() + bk.numel()), 3 * flops,
                    BF16_FLOP_PER_S)
                out.append(dict(
                    name=f"lstm_seq_bwd{'_q8' if sk is not None else ''}"
                         "_bf16", B=B, extra=extra, shape=tshape,
                    tiles=tuple(tiles), home=home, ms=time_ms(bwd, 100),
                    graph_ms=graph_ms(bwd),
                    plain_ms=time_ms(lambda: bwd_k.lstm_seq_bwd_plain(
                        wk, bk, xp16, ct, ht, dc, dh, scales=sk), 2),
                    library_ms=bwd_lib_ms,
                    chain_ms=bwd_chain_bound_ms(T_, L_, P_, Hs),
                    bound_ms=t_bound, bound_by=by))
            return out

        rows.append(cell_row16(1, p64_16["layers"][1], extra=True))
        for B in (1, 64):
            rows.append(cell_row16(B, p16["layers"][1]))
            rows += seq_rows16(p16["layers"], windows, B, train=True)
        rows += seq_rows16(p64_16["layers"], windows, 1, train=False,
                           extra=True)
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
    for r in rows:
        if not r["name"].endswith("_bf16"):
            continue
        f32 = next((q for q in rows if q["name"] == r["name"][:-5]
                    and q["B"] == r["B"]
                    and bool(q.get("extra")) == bool(r.get("extra"))
                    and q["shape"].split(" tiles")[0]
                    == r["shape"].replace(" bf16", "").replace(
                        " (int8 stack)", "").split(" tiles")[0]), None)
        mine = r.get("graph_ms", r.get("cell_graph_ms"))
        theirs = None if f32 is None else f32.get(
            "graph_ms", f32.get("cell_graph_ms"))
        print(f"[time bf16] {r['name']} {r['shape']}: {mine:.4f} ms in a "
              "CUDA graph" + ("" if theirs is None else
                              f" vs the f32 instance's {theirs:.4f} ms "
                              f"({mine / theirs:.3f}x)")
              + f"; cuDNN bf16 {r['library_ms']:.4f} ms back to back"
              + ("" if r.get("library_err") is None else
                 f", {r['library_err']:.3e} max abs from the kernel"))
    for name, legend in (("lstm_seq",
                          "<rows,traj,weights,input,register home>"),
                         ("lstm_seq_bwd", "<rows,max threads,weights,input> "
                          "(shared home) or wave<weights,input> (register "
                          "home)"),
                         ("lstm_cell", "<rows,vector loads,dtype>")):
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
                      ("sequential", sequential),
                      ("fused_seq bf16", runs16["fused_seq"]),
                      ("fused_seq_q8 bf16", runs16["fused_seq_q8"]),
                      ("sequential bf16", seq16)):
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
    # the bf16 instances: the same kernels and call sites, counted on the
    # bf16 serving and training paths
    bf16_paths = {"lstm_cell": serve16_bf16, "lstm_seq": serve16_bf16,
                  "lstm_seq_q8": serve16_bf16,
                  "lstm_seq_traj": train16_bf16["fused_seq"],
                  "lstm_seq_bwd": train16_bf16["fused_seq"],
                  "lstm_seq_q8_traj": train16_bf16["fused_seq_q8"],
                  "lstm_seq_bwd_q8": train16_bf16["fused_seq_q8"]}
    for name, path in bf16_paths.items():
        src_file, replaces, main_b, _ = source[name]
        source[f"{name}_bf16"] = (src_file, replaces, main_b,
                                  {f"{name}_bf16": path[name]})
        errs[f"{name}_bf16"] = bf16_errs[name]
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
        if r["name"].startswith("lstm_cell"):  # device time alone, both
            kernels[-1].update(graph_ms=r["cell_graph_ms"],
                               library_graph_ms=r["library_graph_ms"])
        if r["name"].startswith("lstm_seq_bwd") or (
                r["name"].endswith("_bf16") and "graph_ms" in r):
            kernels[-1].update(graph_ms=r["graph_ms"],
                               chain_bound_ms=r["chain_ms"])
    print(f"[time] the LSTM phases and the build: "
          f"{time.perf_counter() - t_start:.1f} s")

    def timed(fn, *args):
        """One slice, its seconds of command printed after it."""
        t = time.perf_counter()
        out = fn(*args)
        print(f"[time] {fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    kernels.append(timed(rwkv_slice, device, gen, counted, counts, only))
    kernels += timed(rwkv_train_slice, device, gen, counted, counts, only)
    kernels += timed(mamba_slice, device, gen, counted, counts, only)
    kernels += timed(attention_slice, device, gen, counted, counts, only)
    timed(layouts_slice, device, counted, counts, only)
    for name, n in timed(ln_train_slice, device, gen, counted, counts,
                         only).items():
        for entry in kernels:
            if entry["name"] == name:
                entry["launches"] += n
    timed(moe_slice, device, counted, counts, only)
    for name, n in timed(fronts_slice, device, counted, counts,
                         only).items():
        for entry in kernels:
            if entry["name"] == name:
                entry["launches"] += n
    half = timed(profiler_slice, device, counted, counts, only)
    paper = timed(factorization_slice, device, counted, counts, only)
    meshed = timed(mesh_slice, device, counted, counts, only)
    spmd = timed(multidevice_slice, device, counted)
    ranked = timed(train_ranks_slice, device)
    timed(dryrun_slice, device)
    print(f"[time] chip_smoke.py: {time.perf_counter() - t_start:.1f} s")
    for entry in kernels:
        entry["launches"] += half["launches"].get(entry["name"], 0) \
            + paper["launches"].get(entry["name"], 0) \
            + meshed["launches"].get(entry["name"], 0) \
            + spmd["launches"].get(entry["name"], 0) \
            + ranked.get(entry["name"], 0)
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   half["errs"].get(entry["name"], 0.0))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
