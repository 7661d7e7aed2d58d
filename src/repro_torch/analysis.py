"""Analytic accounting for the port on one NVIDIA H100 (the twin of the
JAX package's ``analysis.py``).

* **Launch counting** (MobiRNN §3.1: launch overhead is the enemy):
  ``count_launches`` and ``count_train_launches`` count the hand-kernel
  launches of one call and of one forward plus ``torch.autograd.grad``.
  On the card they read the wrappers' ``launches`` counters; on the CPU,
  where a wrapper runs its plain version and launches nothing, they read
  ``kernels.CALLS``, the calls that stood in for a launch, so the CPU tests
  hold the port's count to the JAX package's jaxpr count.
* **Stream-cost rooflines** of one launch of the sequence kernels K2/K4
  (``lstm_seq_stream_costs``), K6 (``wkv6_stream_costs``) and K7
  (``mamba_scan_stream_costs``): the JAX package's ``flops`` and
  ``hbm_bytes`` for the same tiling arguments, priced at the rates of the
  units these kernels use (the f32 CUDA cores), with the shared-memory
  working set of the port's own tables as ``smem_resident_bytes``.
* **Model accounting**, the JAX package's config arithmetic unchanged:
  ``param_counts``, ``model_flops`` (active, non-embedding parameters),
  ``analytic_costs`` and ``cache_bytes``.
* **Kernel work**: the bytes and operations of one launch of K6, K6t, K6b,
  K7, K7t, K7b, K8, K8t, K8b and K9 at the shapes it is given, and
  ``bound``, the least time the card could take for them.  ``chip_smoke.py``
  prices its kernel table with these.
* ``Roofline``: a step's compute, memory and collective terms on
  ``n_chips`` H100s.
* **Collective accounting** (the twin of ``collective_bytes``):
  ``count_collectives`` gives one call's collectives on this rank, by
  JAX's HLO kind names, from ``partitioning.COLLECTIVES``: the explicit
  ones of ``shard_map`` and the placements, and those DTensor ops issue by
  themselves (``partitioning.counting``).  ``ici_seconds`` prices them
  with the JAX package's ring multipliers at the H100's links: NVLink 4
  within a node of 8, one NDR InfiniBand port a GPU across nodes.  The
  rates are published figures, not measurements: no run here times a
  collective.
* **Grid steps** (the twin of ``count_pallas_grid_steps``): the work
  units the JAX package's Pallas grids have for the same kernel calls,
  from the wrappers' tiling arguments (``kernels.GRID_STEPS``).

The JAX package's HLO parser has no twin: the port has no HLO to read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
# The H100's published peaks live with its other constants.
from repro_torch.core.factorization import (BF16_FLOP_PER_S,  # noqa: F401
                                            F32_FLOP_PER_S, HBM_BYTES_PER_S,
                                            TF32_FLOP_PER_S)

#: NVLink 4 of one H100 SXM5, a direction: 18 links of 25 GB/s (NVIDIA's
#: H100 datasheet gives 900 GB/s both ways)
NVLINK_BYTES_PER_S = 450e9
#: one NDR InfiniBand port a GPU (ConnectX-7, 400 Gb/s), a direction: the
#: rate of a ring that leaves the node
NDR_BYTES_PER_S = 400e9 / 8
#: H100 SXM5s a node share NVLink (an HGX H100 board)
GPUS_PER_NODE = 8


# ---------------------------------------------------------------------------
# Launch accounting
# ---------------------------------------------------------------------------
def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _total(on_card: bool) -> int:
    """Launches of every wrapper so far on the card, else the calls that
    stood in for them on the CPU."""
    from repro_torch import kernels

    if on_card:
        return sum(kernels.launch_counts().values())
    return sum(kernels.CALLS.values())


def count_launches(fn: Callable, *args, **kw) -> int:
    """Hand-kernel launches of one call ``fn(*args, **kw)``: the
    per-cell LSTM plan's T x L, the sequence plans' 1 at any T.  Tensors on
    the card count launches; on the CPU, the calls that ran a kernel's
    plain version in its place."""
    on_card = any(t.is_cuda for t in _tensors((args, kw)))
    before = _total(on_card)
    fn(*args, **kw)
    return _total(on_card) - before


def count_train_launches(loss_fn: Callable, params: Any, *args,
                         **kw) -> int:
    """Hand-kernel launches of ONE training step: ``loss_fn(params, *args,
    **kw)`` and ``torch.autograd.grad`` of that scalar with respect to every
    leaf of ``params`` (a tensor, or dicts and lists of them; leaves that
    need no gradient are differentiated as trainable copies).  The fused
    sequence plans take 2 at any T: the trajectory forward and the reverse
    sweep."""
    from repro_torch.optim.adamw import tree_leaves, tree_map

    if not any(t.requires_grad for t in tree_leaves(params)):
        params = tree_map(lambda p: p.detach().clone().requires_grad_(),
                          params)
    on_card = any(t.is_cuda for t in _tensors((params, args, kw)))
    before = _total(on_card)
    loss = loss_fn(params, *args, **kw)
    torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    return _total(on_card) - before


def count_collectives(fn: Callable, *args, **kw
                      ) -> dict[str, tuple[int, int]]:
    """This rank's collectives in one call ``fn(*args, **kw)``: ``{kind:
    (calls, bytes)}`` by JAX's HLO kind names (``collective-permute``,
    ``all-reduce``, ``all-gather``, ...), the bytes those this rank sent
    (a permute counts on every rank, its bytes only where the rank sends).
    Read from ``partitioning.COLLECTIVES``, which the shard_map
    collectives, the explicit redistributions of ``constrain`` and
    ``shard_map`` and, inside ``partitioning.counting`` (entered here), a
    DTensor op's own collectives write."""
    from repro_torch import partitioning as pt

    before = {k: tuple(v) for k, v in pt.COLLECTIVES.items()}
    with pt.counting():
        fn(*args, **kw)
    out = {}
    for kind, (calls, nbytes) in pt.COLLECTIVES.items():
        c0, b0 = before.get(kind, (0, 0))
        if calls > c0:
            out[kind] = (calls - c0, nbytes - b0)
    return out


def count_pallas_grid_steps(fn: Callable, *args, **kw) -> int:
    """The JAX package's Pallas grid steps of one call ``fn(*args,
    **kw)``: each kernel call counts the grid JAX's kernel has for it
    (K6, K6t, K6b: ceil(BH / bh_tile) x ceil(T / C); K7, K7t, K7b:
    ceil(B / block_b) x ceil(T / C); K8: B x Hq x ceil(S / q_block) x
    ceil(S / k_block); K9: B x Hq x ceil(S / block_s); ...), from the
    wrapper's tiling arguments, on the card, the CPU or ``meta``.  Halving
    the chunk doubles it while the launch count stays."""
    from repro_torch import kernels

    before = sum(kernels.GRID_STEPS.values())
    fn(*args, **kw)
    return sum(kernels.GRID_STEPS.values()) - before


def ici_seconds(coll: dict[str, int], n_shards: int = 16) -> float:
    """Seconds to move ``coll`` ({kind: bytes}) with the JAX package's ring
    multipliers on an ``n_shards``-way ring: (n-1)/n of the bytes for an
    all-gather or a reduce-scatter, twice that for an all-reduce, half for
    an all-to-all, all of them for a permute.  Priced at NVLink 4 within a
    node (``NVLINK_BYTES_PER_S``), and at one NDR port
    (``NDR_BYTES_PER_S``) when the ring has more than ``GPUS_PER_NODE``
    shards, since it then crosses nodes.  Modelled from published rates,
    not measured."""
    f = (n_shards - 1) / max(n_shards, 1)
    mult = {"all-gather": f, "reduce-scatter": f, "all-reduce": 2 * f,
            "all-to-all": f / 2, "collective-permute": 1.0}
    rate = (NVLINK_BYTES_PER_S if n_shards <= GPUS_PER_NODE
            else NDR_BYTES_PER_S)
    return sum(mult.get(k, 1.0) * v for k, v in coll.items()) / rate


# ---------------------------------------------------------------------------
# Stream-cost rooflines of one sequence-kernel launch
# ---------------------------------------------------------------------------
def _times(flops: float, hbm_bytes: float, resident: int) -> dict:
    return {"flops": float(flops), "hbm_bytes": float(hbm_bytes),
            "smem_resident_bytes": float(resident),
            "t_compute": flops / F32_FLOP_PER_S,
            "t_memory": hbm_bytes / HBM_BYTES_PER_S}


def lstm_seq_stream_costs(seq_len: int, n_layers: int, p_width: int,
                          hidden: int, batch: int, block_b: int,
                          time_chunk: int | None, dtype_bytes: int = 4,
                          w_dtype_bytes: int | None = None,
                          mode: str = "fwd",
                          quantized: bool = False) -> dict[str, float]:
    """Roofline terms of ONE fused-LSTM launch (K2, streamed K4 when
    ``time_chunk`` is set; ``mode="bwd"`` the reverse sweep K3).

    The JAX package's traffic model: per batch tile the input crosses
    once in ceil(T/tc) windows of tc rows (a clamped tail re-reads up to
    tc - 1 rows), the training path streams the two f32 trajectories out
    and back in with one overlap row a chunk, and dx streams out; the
    weights cross once a tile, the recurrent state never.  ``flops``: 2
    gate products a cell forward, 6 in the reverse sweep.  ``quantized``
    prices the int8 stack (1 byte a weight, f32 bias and scales; f32
    master gradients).

    Returns ``flops``, ``hbm_bytes``, ``smem_resident_bytes`` (the port's
    ``kernels/lstm_seq.working_set_bytes`` at this tiling) and
    ``t_compute``/``t_memory`` in seconds at the H100's f32 CUDA-core and
    HBM rates: the kernels do their products in f32 on the CUDA cores,
    bf16 operands included."""
    from repro_torch.kernels import lstm_seq as seq_lib

    w_count = n_layers * (p_width + hidden) * 4 * hidden
    b_count = n_layers * 4 * hidden
    if quantized:
        wb = 1 if w_dtype_bytes is None else w_dtype_bytes
        weight_bytes = w_count * wb + b_count * 4 * 2   # + f32 bias + scales
        dw_bytes = (w_count + b_count) * 4              # f32 master grads
    else:
        wb = dtype_bytes if w_dtype_bytes is None else w_dtype_bytes
        weight_bytes = (w_count + b_count) * wb
        dw_bytes = weight_bytes
    n_tiles = math.ceil(batch / block_b)
    tc = seq_len if time_chunk is None else min(time_chunk, seq_len)
    nc = math.ceil(seq_len / tc)
    x_rows = nc * tc
    traj_rows = nc * (tc + 1 if nc > 1 else tc)
    x_bytes = x_rows * block_b * p_width * dtype_bytes
    traj_bytes = 2 * traj_rows * n_layers * block_b * hidden * 4
    state_out = 2 * n_layers * block_b * hidden * dtype_bytes

    matmul = 2 * block_b * (p_width + hidden) * 4 * hidden  # FLOPs/cell
    if mode == "fwd":
        per_tile_bytes = weight_bytes + x_bytes + state_out
        per_tile_flops = seq_len * n_layers * matmul
    else:
        per_tile_bytes = (weight_bytes + x_bytes + traj_bytes
                          + x_bytes                      # dx mirrors x
                          + 2 * state_out)               # (dc, dh) cots in
        per_tile_flops = seq_len * n_layers * 3 * matmul
    hbm_bytes = n_tiles * per_tile_bytes
    if mode == "bwd":
        hbm_bytes += dw_bytes                            # dw/db written once
    flops = n_tiles * per_tile_flops
    resident = seq_lib.working_set_bytes(
        seq_len, n_layers, p_width, hidden, block_b, dtype_bytes,
        w_dtype_bytes, mode=mode, time_chunk=time_chunk,
        quantized=quantized)
    return _times(flops, hbm_bytes, resident)


def wkv6_stream_costs(seq_len: int, n_bh: int, dk: int, dv: int,
                      chunk: int, dtype_bytes: int = 4,
                      mode: str = "fwd", *,
                      bh_tile: int = 1) -> dict[str, float]:
    """Roofline terms of ONE chunked-scan WKV6 launch (K6; ``mode="bwd"``
    the reverse sweep K6b), the JAX package's traffic and FLOP model: per
    (bh tile, chunk) the r, k, logw and v windows in and the output window
    out at their padded extents (``tiling.streamed_axis_rows``,
    ``tiling.pad_tiles``), the (dk, dv) state in and out once a row; per
    chunk of a row ``2 C^2 dk + 2 C^2 dv + 4 C dk dv``, tripled for the
    backward, whose chunk-incoming states and mirrored cotangent windows
    stream on top.

    Same keys as ``lstm_seq_stream_costs``; ``smem_resident_bytes`` is the
    port's ``kernels/wkv6.working_set_bytes`` at this chunk (a block runs
    its tile's rows one after another, so the tile adds nothing)."""
    from repro_torch.core import tiling
    from repro_torch.kernels import wkv6 as wkv6_lib

    tiling.check_mode(mode)
    C = max(1, min(chunk, seq_len))
    bt = max(1, min(bh_tile, n_bh))
    nc = tiling.ceil_chunks(seq_len, C)
    rows = tiling.pad_tiles(n_bh, bt)        # padded batch-head extent
    t_rows = tiling.streamed_axis_rows(seq_len, C)       # nc * C
    per_chunk_flops = 2 * C * C * dk + 2 * C * C * dv + 4 * C * dk * dv
    windows_in = rows * t_rows * (3 * dk + dv) * dtype_bytes  # r,k,logw,v
    out_tiles = rows * t_rows * dv * dtype_bytes
    state_io = rows * (2 * dk * dv * 4 + dk * 4)         # s0 + s_out + u
    flops = rows * nc * per_chunk_flops
    hbm_bytes = windows_in + out_tiles + state_io
    if mode == "bwd":
        flops *= 3                      # linearised recompute + cot flow
        hbm_bytes += (rows * nc * dk * dv * 4
                      + out_tiles + windows_in
                      + rows * (dk * 4 + dk * dv * 4))
    resident = wkv6_lib.working_set_bytes(seq_len, dk, dv, C, mode=mode)
    return _times(flops, hbm_bytes, resident)


def mamba_scan_stream_costs(seq_len: int, batch: int, d_inner: int,
                            d_state: int, block_b: int, chunk: int,
                            dtype_bytes: int = 4,
                            mode: str = "fwd", *,
                            di_tile: int | None = None) -> dict[str, float]:
    """Roofline terms of ONE fused selective-scan launch (K7; ``mode="bwd"``
    the reverse sweep K7b), the JAX package's model: per (batch tile,
    chunk) the x, dt, B and C tiles in and the y tile out at padded
    extents, the (d_inner, d_state) f32 state in and out once a row, A
    once; ``8 d_inner d_state`` FLOPs a step of a row, tripled for the
    backward, whose chunk-incoming states and mirrored cotangent tiles
    stream on top.

    Same keys as ``lstm_seq_stream_costs``; ``smem_resident_bytes`` is the
    port's ``kernels/mamba_scan.working_set_bytes`` of a block of
    ``di_tile`` channels (None: the tile the wrapper takes by default).
    The port's tables have that d_inner tile in place of the JAX table's
    whole (block_b, d_inner, d_state) state: the state lives in
    registers."""
    from repro_torch.core import tiling
    from repro_torch.kernels import mamba_scan as ms_lib

    tiling.check_mode(mode)
    C = max(1, min(chunk, seq_len))
    bm = max(1, min(block_b, batch))
    nc = tiling.ceil_chunks(seq_len, C)
    rows = tiling.pad_tiles(batch, bm)       # padded batch extent
    t_rows = tiling.streamed_axis_rows(seq_len, C)       # nc * C
    per_step_flops = 8 * d_inner * d_state
    tiles_in = rows * t_rows * (d_inner * dtype_bytes + d_inner * 4
                                + 2 * d_state * 4)
    out_tiles = rows * t_rows * d_inner * dtype_bytes
    state_io = rows * 2 * d_inner * d_state * 4          # h0 + h_out
    a_bytes = d_inner * d_state * 4                      # A crosses once
    flops = rows * t_rows * per_step_flops
    hbm_bytes = tiles_in + out_tiles + state_io + a_bytes
    if mode == "bwd":
        flops *= 3                      # linearised recompute + cot flow
        hbm_bytes += (rows * nc * d_inner * d_state * 4
                      + out_tiles + tiles_in
                      + a_bytes + rows * d_inner * d_state * 4)
    tile = ms_lib.default_di_tile(d_inner, mode) if di_tile is None \
        else di_tile
    resident = ms_lib.working_set_bytes(seq_len, d_state, C, tile, mode,
                                        io_bytes=dtype_bytes)
    return _times(flops, hbm_bytes, resident)


# ---------------------------------------------------------------------------
# Analytic parameter counts
# ---------------------------------------------------------------------------
def _attn_params(cfg: ModelConfig) -> int:
    d, hq, hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    n = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    if cfg.qkv_bias:
        n += hq * dh + 2 * hkv * dh
    return n


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.mlp_act == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _moe_params(cfg: ModelConfig, active: bool) -> int:
    moe = cfg.moe
    n_exp = moe.top_k if active else moe.n_experts
    return (cfg.d_model * moe.n_experts            # router (always dense)
            + n_exp * _mlp_params(cfg, moe.d_ff))


def _rwkv_params(cfg: ModelConfig) -> int:
    d, r = cfg.d_model, cfg.ssm.lora_rank
    tmix = (5 * d * d                  # r,k,v,g,o projections
            + d * 5 * 32 + 5 * 32 * d  # ddlerp lora
            + d * r + r * d            # decay lora
            + 7 * d)                   # mu vectors, w0, u, groupnorm
    cmix = 2 * d * cfg.d_ff + d * d + 2 * d
    return tmix + cmix


def _mamba_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    di = cfg.ssm.expand * d
    ds = cfg.ssm.d_state
    dr = math.ceil(d / 16)
    return (d * 2 * di + cfg.ssm.d_conv * di + di
            + di * (dr + 2 * ds) + dr * di + di
            + di * ds + di + di * d)


def param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active-per-token) analytic parameter counts."""
    total = active = 0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            t = a = _attn_params(cfg)
        elif cfg.ssm.kind == "rwkv6":
            t = a = _rwkv_params(cfg)
        else:
            t = a = _mamba_params(cfg)
        if cfg.ssm is None or cfg.ssm.kind != "rwkv6":
            if cfg.layer_is_moe(i):
                t += _moe_params(cfg, active=False)
                a += _moe_params(cfg, active=True)
            else:
                t += _mlp_params(cfg, cfg.d_ff)
                a += _mlp_params(cfg, cfg.d_ff)
        total += t + 4 * cfg.d_model            # norms
        active += a + 4 * cfg.d_model
    emb = cfg.vocab * cfg.d_model * (cfg.n_codebooks or 1)
    head = 0 if cfg.tie_embeddings else emb
    extra = 0
    if cfg.n_vis_tokens:  # vlm projector (2-layer mlp with biases)
        extra = (cfg.vis_dim * cfg.d_model + cfg.d_model
                 + cfg.d_model * cfg.d_model + cfg.d_model)
    total += emb + head + extra
    active += emb + head + extra
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N_active·tokens for training, 2·N_active·tokens for
    inference (embedding lookups excluded from N per convention)."""
    _, active = param_counts(cfg)
    emb = cfg.vocab * cfg.d_model * (cfg.n_codebooks or 1)
    n = active - emb
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch     # decode: per generated token


# ---------------------------------------------------------------------------
# Analytic per-step cost model
# ---------------------------------------------------------------------------
def _layer_flops(cfg: ModelConfig, i: int, T: float, s_att: float,
                 decode: bool) -> float:
    """Forward flops of layer i for T tokens; s_att = attended positions."""
    d, ff = cfg.d_model, cfg.d_ff
    fl = 0.0
    kind = cfg.layer_kind(i)
    if kind == "attn":
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        fl += 2 * T * d * (hq + 2 * hkv) * dh      # qkv proj
        fl += 2 * T * hq * dh * d                  # out proj
        fl += 4 * T * s_att * hq * dh              # QK^T + AV
    elif cfg.ssm.kind == "rwkv6":
        dh = cfg.ssm.head_dim
        C = cfg.ssm.chunk if not decode else 1
        fl += 2 * T * d * d * 5                    # r,k,v,g,o projections
        fl += 2 * T * d * (cfg.ssm.lora_rank * 2 + 5 * 32 * 2)  # loras
        fl += 4 * T * d * (C + dh)                 # wkv chunk math
        fl += 2 * T * (2 * d * ff + d * d)         # channel-mix
        return fl
    else:  # mamba
        di = cfg.ssm.expand * d
        ds = cfg.ssm.d_state
        dr = math.ceil(d / 16)
        fl += 2 * T * d * 2 * di + 2 * T * di * (dr + 2 * ds)
        fl += 2 * T * dr * di + 2 * cfg.ssm.d_conv * T * di
        fl += 8 * T * di * ds                      # selective scan step math
        fl += 2 * T * di * d
    # mlp / moe half
    mult = 3 if cfg.mlp_act == "swiglu" else 2
    if cfg.layer_is_moe(i):
        moe = cfg.moe
        cf = 1.0 if decode else moe.capacity_factor
        fl += 2 * T * d * moe.n_experts            # router
        fl += 2 * mult * T * moe.top_k * cf * d * moe.d_ff
    else:
        fl += 2 * mult * T * d * ff
    return fl


def analytic_costs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, float]:
    """Total flops and device-memory bytes of one global step: the JAX
    package's itemized model (a training step is 4 forwards: the forward,
    its recompute and a backward of twice its cost)."""
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    T = float(B if decode else B * S)
    if decode:
        window = cfg.sliding_window or 0
        s_att = min(S, window) if window else S    # cache positions read
    else:
        s_att = float(S)
    fwd = sum(_layer_flops(cfg, i, T, s_att, decode)
              for i in range(cfg.n_layers))
    fwd += 2 * T * cfg.d_model * cfg.vocab * (cfg.n_codebooks or 1)  # head
    flops = fwd * (4.0 if shape.kind == "train" else 1.0)

    p_total, _ = param_counts(cfg)
    dt = 2 if cfg.dtype == "bfloat16" else 4
    p_bytes = p_total * dt
    act_unit = T * cfg.d_model * dt                # one activation tensor
    if shape.kind == "train":
        # params: read fwd + recompute + bwd, write once; adamw moments rw
        byts = p_bytes * 4 + p_total * (4 + 4) * 2 * 2
        byts += act_unit * 12 * cfg.n_layers       # activations r/w
        byts += T * cfg.vocab * 4 * 3              # logits fwd+bwd
    elif shape.kind == "prefill":
        byts = p_bytes + act_unit * 8 * cfg.n_layers
        byts += cache_bytes(cfg, B, S)             # cache write
        byts += B * cfg.vocab * 4
    else:
        byts = p_bytes                              # weights stream once
        byts += cache_bytes(cfg, B, S) * (1 + 1e-3)  # cache read (+tiny write)
        byts += act_unit * 8 * cfg.n_layers
        byts += B * cfg.vocab * 4
    return {"flops": flops, "bytes": float(byts), "fwd_flops": fwd}


def cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    """Decode-state bytes for a batch of B requests at context S."""
    dt = 2 if cfg.dtype == "bfloat16" else 4
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            w = cfg.sliding_window or 0
            s_c = min(S, w) if w else S
            if cfg.kv_quant:   # int8 values + one f32 scale per (tok, head)
                total += 2 * B * s_c * cfg.n_kv_heads * (
                    cfg.resolved_head_dim * 1 + 4)
            else:
                total += (2 * B * s_c * cfg.n_kv_heads
                          * cfg.resolved_head_dim * dt)
        elif cfg.ssm.kind == "rwkv6":
            H, dh = cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
            total += B * (H * dh * dh * 4 + 2 * cfg.d_model * dt)
        else:
            di = cfg.ssm.expand * cfg.d_model
            total += B * (di * cfg.ssm.d_state * 4
                          + (cfg.ssm.d_conv - 1) * di * dt)
    return total


# ---------------------------------------------------------------------------
# Kernel work: bytes and operations of one launch at its shapes
# ---------------------------------------------------------------------------
def _io(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def bound(nbytes: int, flops: int, flop_rate: float = F32_FLOP_PER_S
          ) -> tuple[float, str]:
    """Least time in ms for the work, and which of the two bounds it: the
    bytes at the HBM rate, the operations at ``flop_rate`` (the f32 rate
    of the CUDA cores unless the inputs' type has a faster peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv6_fwd_work(BH, T, dk, dv, C, dtype, traj=False) -> tuple[int, int]:
    """(bytes, operations) of one K6 launch (K6t with ``traj``): r, k, v
    in and out in the IO type, logw f32, u, s0 and s_out f32 (and s_traj
    f32 out); per chunk of a row the carry, the scores (sub, 2 mul, add),
    scores x v, the bonus, bonus x v, the state update and the decays."""
    io = _io(dtype)
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
    io = _io(dtype)
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


def mamba_fwd_work(B, T, di, ds, C, dtype, traj=False) -> tuple[int, int]:
    """(bytes, operations) of one K7 launch (K7t with ``traj``): x in and y
    out in the IO type, dt, b, c, a, h0 and h_out f32 (and h_traj f32
    out); per state-step dt A, its exponential (one operation), (dt x) B,
    the update's multiply-add and y's, and per channel-step dt x."""
    io = _io(dtype)
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
    io = _io(dtype)
    nt = -(-T // C)
    nbytes = (3 * io * B * T * di + 2 * 4 * B * T * di + 4 * 4 * B * T * ds
              + 2 * 4 * di * ds + 4 * B * nt * di * ds + 2 * 4 * B * di * ds)
    return nbytes, B * T * di * (21 * ds + 4)


def prefill_work(B, S, Hq, Hkv, dh, dtype) -> tuple[int, int]:
    """(bytes, operations) of one K8 launch: q, k, v in and o out in the IO
    type, each once; the causal half of the two products, 4 B Hq dh
    S (S + 1) / 2 (a multiply-add is 2)."""
    io = _io(dtype)
    return (io * B * S * dh * (2 * Hq + 2 * Hkv),
            4 * B * Hq * dh * S * (S + 1) // 2)


def decode_work(B, Hq, Hkv, dk, lengths, dtype) -> tuple[int, int]:
    """(bytes, operations) of one K9 launch: the k and v rows below each
    row's length, q in and o out, in the IO type; the two products over
    those rows (4 Hq dk a row and position)."""
    io = _io(dtype)
    n = int(lengths.clamp_min(0).sum())
    return (io * (2 * n * Hkv * dk + 2 * B * Hq * dk), 4 * n * Hq * dk)


def attn_traj_work(B, S, Hq, Hkv, dh, dtype) -> tuple[int, int]:
    """(bytes, operations) of one K8t launch: K8's (``prefill_work``) and
    the rows' lse written in f32."""
    nbytes, ops = prefill_work(B, S, Hq, Hkv, dh, dtype)
    return nbytes + 4 * B * Hq * S, ops


def attn_bwd_work(B, S, Hq, Hkv, dh, dtype) -> tuple[int, int]:
    """(bytes, operations) of one K8b call: q, o, dO in and dq out (B, S,
    Hq, dh), k, v in and dk, dv out (B, S, Hkv, dh), in the IO type, each
    once, and lse in f32; the causal half of its five products (q k^T,
    dO v^T, p^T dO, ds k, ds^T q), 5 B Hq dh S (S + 1) (a multiply-add is
    2)."""
    io = _io(dtype)
    return (io * B * S * dh * (4 * Hq + 4 * Hkv) + 4 * B * Hq * S,
            5 * B * Hq * dh * S * (S + 1))


# ---------------------------------------------------------------------------
# One card's roofline of a step
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    """Compute, memory and collective terms of a step on ``n_chips``
    H100s: the compute at the bf16 tensor-core peak, the memory at the
    HBM rate, the collectives (``coll_bytes``: this rank's bytes by kind)
    by ``ici_seconds`` on a ring of ``n_shards`` (the JAX package's 16)."""
    flops: float                 # total flops (all cards)
    hbm_bytes: float             # total device-memory bytes (all cards)
    n_chips: int = 1
    model_flops: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    n_shards: int = 16

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * BF16_FLOP_PER_S)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.n_chips * HBM_BYTES_PER_S)

    @property
    def t_collective(self) -> float:
        return ici_seconds(self.coll_bytes, self.n_shards)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.coll_bytes),
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_frac": self.useful_flops_frac,
        }
