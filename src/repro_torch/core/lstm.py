"""The paper's model: stacked LSTM for activity recognition (MobiRNN §4.1).

Five execution plans over the same parameters, the JAX package's five in
its order (asserted against it by tests/test_torch_plans.py); the first
four are numerically equivalent, the fifth agrees within the int8 band:

* ``forward_sequential`` — reference plan: a loop over time, layers in
  dependency order inside the step (the single-threaded baseline of Fig 3/4).
* ``forward_wavefront`` — the paper's Fig 1 diagonal parallelism: cells on an
  anti-diagonal run together as ONE batched cell over layers
  (core/wavefront.py).
* ``forward_fused_kernel`` (``fused_cell``) — the sequential plan with each
  cell the fused-gate CUDA kernel (kernels/lstm_cell.py): T x L launches.
* ``forward_fused_seq`` (``fused_seq``) — the sequence-resident CUDA kernel
  (kernels/lstm_seq.py): the whole T-step, L-layer recurrence in ONE launch,
  weights in shared memory once, (c, h) never leaving it — the MobiRNN fast
  path.  Routes to ``fused_cell`` with a ``plan/dispatch`` event when the
  weight stack exceeds a thread block's shared memory.
* ``forward_fused_seq_q8`` (``fused_seq_q8``) — ``fused_seq`` over
  per-output-channel int8 weights (kernels/ref.quantize_q8), held in
  shared memory as int8 plus f32 scales: a quarter of the f32 stack, so it
  runs in one launch at widths where ``fused_seq`` cannot (2 x 64, 3 x 64,
  2 x 96).  Within ``Q8_BAND`` of the others (core/plans.py), within fp
  rounding of the dequantize oracle; it trains quantization-aware with f32
  master weights and straight-through gradients.

Every plan runs in float32 or bfloat16 (``cfg.dtype``: the parameters' and
the input's dtype), as the JAX package's do.  In bf16 the kernels widen
every operand to f32 and sum in f32; ``fused_seq`` keeps its state in f32
for the whole sequence and rounds only the final h, while ``fused_cell``
(and ``sequential``) round the state to bf16 every step, by design, as in
the JAX package.  The bf16 stack is half the f32 one, so ``fused_seq``
serves 2 x 64 and 3 x 64 in one launch, where f32 routes to ``fused_cell``.

Every plan trains: ``loss_fn`` under ``torch.autograd`` differentiates it.
A ``fused_seq`` training step is two launches at any T (the trajectory
forward and the reverse-sweep backward kernel, kernels/lstm_seq_bwd.py); a
``fused_cell`` step is T x L cell launches, its backward the VJP of the
plain cell; a ``fused_seq_q8`` step is two launches too (the q8
trajectory forward and the q8 backward).  The classifier head follows
Guan & Ploetz-style HAR models: last hidden state -> dense -> 6-way
logits.  Parameters are a plain dict ``{"layers": [{"w": (D+H, 4H), "b":
(4H,)}, ...], "head": {"w": (H, C), "b": (C,)}}``; ``LSTMClassifier``
holds them as an ``nn.Module``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.configs.mobirnn_lstm import CONFIG, LSTMConfig
from repro_torch.core import cell as cell_lib
from repro_torch.core import wavefront
from repro_torch.kernels import lstm_seq as seq_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import trace as trace_lib
from repro_torch.partitioning import dense_init, split, zeros_init


def init_params_annot(gen: torch.Generator, cfg: LSTMConfig) -> dict:
    """Annotated parameter tree for the stacked LSTM + HAR head (the JAX
    package's ``init_params`` axes), on the CPU, drawn from the CPU
    generator ``gen``."""
    dtype = getattr(torch, cfg.dtype)
    layers = [cell_lib.init_cell_annot(
        gen, cfg.input_dim if i == 0 else cfg.hidden, cfg.hidden, dtype)
        for i in range(cfg.n_layers)]
    return {
        "layers": layers,
        "head": {"w": dense_init(gen, (cfg.hidden, cfg.n_classes),
                                 ("embed", None), dtype),
                 "b": zeros_init((cfg.n_classes,), (None,), dtype)},
    }


def init_params(gen: torch.Generator, cfg: LSTMConfig) -> dict:
    """Parameter dict for the stacked LSTM + HAR head: the plain tensors of
    ``init_params_annot``."""
    return split(init_params_annot(gen, cfg))[0]


def init_state(cfg: LSTMConfig, batch: int, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Preallocated (c, h) buffers, one pair per layer, (L, B, H) zeros
    (paper §3.2: state tensors are preallocated once and reused across the
    whole sequence)."""
    shape = (cfg.n_layers, batch, cfg.hidden)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _head(params: dict, last_h: torch.Tensor) -> torch.Tensor:
    return last_h @ params["head"]["w"] + params["head"]["b"]


def forward_sequential(params: dict, x: torch.Tensor, cfg: LSTMConfig,
                       cell_fn: Callable = cell_lib.lstm_cell_fused
                       ) -> torch.Tensor:
    """Reference plan.  x: (batch, seq, input_dim) -> logits (batch, classes).

    A loop over time; within a step, layers run in dependency order and
    each layer's (c, h) is replaced by its update."""
    c0, h0 = init_state(cfg, x.shape[0], x.dtype, x.device)
    c, h = list(c0.unbind(0)), list(h0.unbind(0))
    for t in range(x.shape[1]):
        inp = x[:, t]
        for i, layer in enumerate(params["layers"]):
            c[i], h[i] = cell_fn(layer, inp, c[i], h[i])
            inp = h[i]
    return _head(params, h[-1])


def _kernel_cell(p: dict, inp: torch.Tensor, c: torch.Tensor,
                 h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return kernel_ops.lstm_cell(p["w"], p["b"], inp, c, h)


def forward_fused_kernel(params: dict, x: torch.Tensor, cfg: LSTMConfig
                         ) -> torch.Tensor:
    """Sequential plan with the fused-cell kernel as the cell body."""
    return forward_sequential(params, x, cfg, cell_fn=_kernel_cell)


def forward_fused_seq(params: dict, x: torch.Tensor, cfg: LSTMConfig,
                      smem_budget: int | None = None) -> torch.Tensor:
    """Sequence-resident plan: ONE kernel launch for the whole (T x L)
    recurrence (kernels/lstm_seq.py) — launch count O(1) in T instead of the
    per-cell plan's T x L.

    The tiling comes from ``choose_batch_block`` as a ``(block_b,
    time_chunk)`` pair: whole-T residency of the input when it fits,
    otherwise the kernel streams the time axis through its two-slot ring.
    When autograd records the call, the search sizes the backward kernel
    (``mode="bwd"``), and that one tiling serves the trajectory forward and
    the backward.  Only when even ``(bm=1, tc=1)`` cannot fit — the weight
    stack (in training, plus its gradient accumulators) exceeds
    ``smem_budget`` (default: one H100 thread block's shared memory) — does
    this route to ``forward_fused_kernel``, emitting a ``plan/dispatch``
    event with ``fallback="fused_cell"``.  Every event names ``train``; a
    training event also ``bwd_block_b``/``bwd_time_chunk``.
    """
    return _forward_fused_seq_impl(params, x, cfg, smem_budget=smem_budget,
                                   quantized=False)


def forward_fused_seq_q8(params: dict, x: torch.Tensor, cfg: LSTMConfig,
                         smem_budget: int | None = None) -> torch.Tensor:
    """Int8-weight sequence-resident plan: ``fused_seq`` with the stacked
    weights quantized per output channel (kernels/ref.quantize_q8) inside
    ``kernels/lstm_seq.lstm_seq_q8`` and held in shared memory as int8 plus
    f32 scales.  The budget table is ``choose_batch_block(quantized=True)``,
    so the plan stays one launch at 2 x 64, 3 x 64 and 2 x 96, where the
    f32 stack fits no thread block.  Its training step is two launches
    with f32 straight-through gradients for the f32 master weights; where
    the q8 backward fits no block (2 x 64: its f32 dW accumulators alone are
    264 KiB) a training call routes to ``fused_cell``, as a forward that
    fits no block does, with a ``plan/dispatch`` event naming
    ``plan="fused_seq_q8", fallback="fused_cell"``.

    NOT numerically equivalent to the other plans: within fp rounding of
    ``ref.lstm_seq_q8`` (dequantize, then run) and within ``Q8_BAND`` of
    the f32 plans (core/plans.py)."""
    return _forward_fused_seq_impl(params, x, cfg, smem_budget=smem_budget,
                                   quantized=True)


def _forward_fused_seq_impl(params: dict, x: torch.Tensor, cfg: LSTMConfig,
                            *, smem_budget: int | None,
                            quantized: bool) -> torch.Tensor:
    """Shared body of the f32 and int8 sequence-resident plans: stack the
    layer params, consult the (dtype- and quantization-aware) budget table
    once — ``mode="bwd"`` when autograd records the call — route to the
    per-cell kernel when even (bm=1, tc=1) cannot fit, run the sequence
    kernel, apply the head.  ``quantized`` casts the stack to f32 masters
    first, as the JAX package does: int8 rounding is then the only
    deviation, and the straight-through gradients land in f32 before the
    cast returns them in the parameters' dtype."""
    w_stack, b_stack, p_width = seq_lib.stack_params(params["layers"],
                                                     cfg.hidden)
    if quantized:
        w_stack, b_stack = w_stack.float(), b_stack.float()
    B, T, _ = x.shape
    train = seq_lib.recorded(w_stack, b_stack, x)
    blocks = seq_lib.choose_batch_block(
        B, T, cfg.n_layers, p_width, cfg.hidden,
        dtype_bytes=x.element_size(), smem_budget=smem_budget,
        w_dtype_bytes=None if quantized else w_stack.element_size(),
        mode="bwd" if train else "fwd", quantized=quantized)
    plan = "fused_seq_q8" if quantized else "fused_seq"
    tracer = trace_lib.get_tracer()
    if blocks is None:        # the stack > shared memory at (bm=1, tc=1)
        if tracer.enabled:
            tracer.event("plan/dispatch", family="lstm", plan=plan,
                         fallback="fused_cell", train=train, batch=B,
                         seq_len=T)
        return forward_fused_kernel(params, x, cfg)
    tiles = dict(block_b=blocks.block_b, time_chunk=blocks.time_chunk)
    if train:
        tiles.update(bwd_block_b=blocks.block_b,
                     bwd_time_chunk=blocks.time_chunk)
    if tracer.enabled:
        tracer.event("plan/dispatch", family="lstm", plan=plan,
                     train=train, **tiles, batch=B, seq_len=T)
    xp = seq_lib.pad_input(x, p_width)
    op = kernel_ops.lstm_seq_q8 if quantized else kernel_ops.lstm_seq
    _, h = op(w_stack, b_stack, xp, **tiles)
    return _head(params, h[-1])


def forward_wavefront(params: dict, x: torch.Tensor, cfg: LSTMConfig
                      ) -> torch.Tensor:
    """Paper Fig 1 diagonal plan — see core/wavefront.py."""
    return wavefront.forward_wavefront(params, x, cfg)


#: The five execution plans, keyed by scheduler Plan name, in the JAX
#: package's order.  Every entry maps (params, x, cfg) -> logits.  The first
#: four are numerically equivalent; ``fused_seq_q8`` agrees with them within
#: the int8 band (core/plans.Q8_BAND).
FORWARD_PLANS: dict[str, Callable] = {
    "sequential": forward_sequential,
    "wavefront": forward_wavefront,
    "fused_cell": forward_fused_kernel,
    "fused_seq": forward_fused_seq,
    "fused_seq_q8": forward_fused_seq_q8,
}


def plan_viability(cfg: LSTMConfig, batch: int, seq_len: int, *,
                   seq_plan_names: tuple[str, ...] = ("fused_seq",),
                   q8_plan_names: tuple[str, ...] = ("fused_seq_q8",),
                   dtype_bytes: int = 4, w_dtype_bytes: int | None = None,
                   smem_budget: int | None = None,
                   train: bool = False) -> Callable[[str], bool]:
    """Viability predicate for ``Scheduler(viable=...)``.

    The sequence-resident plan is only a real plan while
    ``kernels/lstm_seq.choose_batch_block`` finds a ``(block_b,
    time_chunk)`` tiling that fits a thread block's shared memory; past it
    ``forward_fused_seq`` reroutes to the per-cell kernel, so scheduling it
    would run ``fused_cell`` under another name.  ``seq_plan_names``
    lists the scheduler names of that plan (a benchmark may register it as
    ``accel_seq``); every other plan is always viable.  ``dtype_bytes``
    sizes the input and ``w_dtype_bytes`` the stack (default: the input's
    width): a bf16 model is ``dtype_bytes=2, w_dtype_bytes=2``, whose
    halved stack serves 2 x 64 in one launch where f32 cannot.

    ``train=True`` sizes the backward working set instead
    (``choose_batch_block(mode="bwd")``: trajectory windows and gradient
    accumulators on top of the forward's terms) — the number that matters
    when the scheduled step runs under autograd, where a plan past it
    would train on ``fused_cell`` under the fast plan's name.

    ``q8_plan_names`` lists the scheduler names of the int8 plan
    (``fused_seq_q8``); its surface is the quantization-aware table
    (``choose_batch_block(quantized=True)``), which fits every width the
    f32 one does and more (2 x 64 serving), so there are shapes where the
    scheduler may offer only the int8 fast path.
    """
    p_width = max(cfg.input_dim, cfg.hidden)
    mode = "bwd" if train else "fwd"
    block = seq_lib.choose_batch_block(
        batch, seq_len, cfg.n_layers, p_width, cfg.hidden,
        dtype_bytes=dtype_bytes, smem_budget=smem_budget,
        w_dtype_bytes=w_dtype_bytes, mode=mode)
    q8_block = seq_lib.choose_batch_block(
        batch, seq_len, cfg.n_layers, p_width, cfg.hidden,
        dtype_bytes=dtype_bytes, smem_budget=smem_budget, mode=mode,
        quantized=True)

    def viable(plan_name: str) -> bool:
        if plan_name in q8_plan_names:
            return q8_block is not None
        return block is not None or plan_name not in seq_plan_names

    return viable


def loss_fn(params: dict, x: torch.Tensor, labels: torch.Tensor,
            cfg: LSTMConfig, forward: Callable = forward_sequential
            ) -> torch.Tensor:
    """Mean cross-entropy of the plan's logits against integer labels,
    in float32."""
    logits = forward(params, x, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def accuracy(params: dict, x: torch.Tensor, labels: torch.Tensor,
             cfg: LSTMConfig, forward: Callable = forward_sequential
             ) -> torch.Tensor:
    logits = forward(params, x, cfg)
    return (logits.argmax(dim=-1) == labels).float().mean()


class LSTMClassifier(nn.Module):
    """The HAR classifier as an ``nn.Module``: holds the parameters and
    runs one of ``FORWARD_PLANS`` (``plan``) on (batch, seq, input_dim)
    windows.

    Parameters come from ``params`` (e.g. ``convert.params_from_numpy``) or
    are drawn by ``init_params`` from ``generator`` (default: seed 0), as
    trainable copies (``launch/train_har.py`` trains them).  Serving runs
    under ``torch.inference_mode()``, which records no graph."""

    def __init__(self, cfg: LSTMConfig = CONFIG, plan: str = "fused_seq", *,
                 params: dict | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if plan not in FORWARD_PLANS:
            raise ValueError(f"unknown plan {plan!r}; choose from "
                             f"{sorted(FORWARD_PLANS)}")
        self.cfg = cfg
        self.plan = plan
        if params is None:
            gen = generator if generator is not None \
                else torch.Generator().manual_seed(0)
            params = init_params(gen, cfg)

        def param(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.detach().clone())

        self.layer_w = nn.ParameterList(
            [param(p["w"]) for p in params["layers"]])
        self.layer_b = nn.ParameterList(
            [param(p["b"]) for p in params["layers"]])
        self.head_w = param(params["head"]["w"])
        self.head_b = param(params["head"]["b"])

    def params(self) -> dict:
        """The plain parameter dict the plan functions take."""
        return {"layers": [{"w": w, "b": b}
                           for w, b in zip(self.layer_w, self.layer_b)],
                "head": {"w": self.head_w, "b": self.head_b}}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return FORWARD_PLANS[self.plan](self.params(), x, self.cfg)
