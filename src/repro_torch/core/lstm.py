"""The paper's model: stacked LSTM for activity recognition (MobiRNN §4.1).

Four execution plans over the same parameters, numerically equivalent
(asserted against the JAX package by tests/test_torch_plans.py):

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

The JAX package's fifth plan, ``fused_seq_q8`` (int8 weights), is not ported
yet.  The classifier head follows Guan & Ploetz-style HAR models: last
hidden state -> dense -> 6-way logits.  Parameters are a plain dict
``{"layers": [{"w": (D+H, 4H), "b": (4H,)}, ...], "head": {"w": (H, C),
"b": (C,)}}``; ``LSTMClassifier`` holds them as an ``nn.Module``.
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


def init_params(gen: torch.Generator, cfg: LSTMConfig) -> dict:
    """Parameter dict for the stacked LSTM + HAR head, on the CPU, drawn
    from the CPU generator ``gen``."""
    dtype = getattr(torch, cfg.dtype)
    layers = [cell_lib.init_cell(gen, cfg.input_dim if i == 0 else cfg.hidden,
                                 cfg.hidden, dtype)
              for i in range(cfg.n_layers)]
    head_w = torch.empty(cfg.hidden, cfg.n_classes, dtype=torch.float32)
    torch.nn.init.trunc_normal_(head_w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return {
        "layers": layers,
        "head": {"w": (head_w * cfg.hidden ** -0.5).to(dtype),
                 "b": torch.zeros(cfg.n_classes, dtype=dtype)},
    }


def _head(params: dict, last_h: torch.Tensor) -> torch.Tensor:
    return last_h @ params["head"]["w"] + params["head"]["b"]


def forward_sequential(params: dict, x: torch.Tensor, cfg: LSTMConfig,
                       cell_fn: Callable = cell_lib.lstm_cell_fused
                       ) -> torch.Tensor:
    """Reference plan.  x: (batch, seq, input_dim) -> logits (batch, classes).

    A loop over time; within a step, layers run in dependency order and
    each layer's (c, h) is replaced by its update."""
    B = x.shape[0]
    c = [x.new_zeros(B, cfg.hidden) for _ in range(cfg.n_layers)]
    h = [x.new_zeros(B, cfg.hidden) for _ in range(cfg.n_layers)]
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
    Only when even ``(bm=1, tc=1)`` cannot fit — the weight stack itself
    exceeds ``smem_budget`` (default: one H100 thread block's shared memory)
    — does this route to ``forward_fused_kernel``, emitting a
    ``plan/dispatch`` event with ``fallback="fused_cell"``.
    """
    w_stack, b_stack, p_width = seq_lib.stack_params(params["layers"],
                                                     cfg.hidden)
    B, T, _ = x.shape
    blocks = seq_lib.choose_batch_block(
        B, T, cfg.n_layers, p_width, cfg.hidden,
        dtype_bytes=x.element_size(), smem_budget=smem_budget,
        w_dtype_bytes=w_stack.element_size())
    tracer = trace_lib.get_tracer()
    if blocks is None:        # weight stack > shared memory at (bm=1, tc=1)
        if tracer.enabled:
            tracer.event("plan/dispatch", family="lstm", plan="fused_seq",
                         fallback="fused_cell", batch=B, seq_len=T)
        return forward_fused_kernel(params, x, cfg)
    if tracer.enabled:
        tracer.event("plan/dispatch", family="lstm", plan="fused_seq",
                     block_b=blocks.block_b, time_chunk=blocks.time_chunk,
                     batch=B, seq_len=T)
    xp = seq_lib.pad_input(x, p_width)
    _, h = kernel_ops.lstm_seq(w_stack, b_stack, xp, block_b=blocks.block_b,
                               time_chunk=blocks.time_chunk)
    return _head(params, h[-1])


def forward_wavefront(params: dict, x: torch.Tensor, cfg: LSTMConfig
                      ) -> torch.Tensor:
    """Paper Fig 1 diagonal plan — see core/wavefront.py."""
    return wavefront.forward_wavefront(params, x, cfg)


#: The execution plans, keyed by scheduler Plan name.  Every entry maps
#: (params, x, cfg) -> logits, and all four are numerically equivalent.
FORWARD_PLANS: dict[str, Callable] = {
    "sequential": forward_sequential,
    "wavefront": forward_wavefront,
    "fused_cell": forward_fused_kernel,
    "fused_seq": forward_fused_seq,
}


def plan_viability(cfg: LSTMConfig, batch: int, seq_len: int, *,
                   smem_budget: int | None = None) -> Callable[[str], bool]:
    """Viability predicate for ``Scheduler(viable=...)``.

    The sequence-resident plan is only a real plan while
    ``kernels/lstm_seq.choose_batch_block`` finds a ``(block_b,
    time_chunk)`` tiling that fits a thread block's shared memory; past it
    ``forward_fused_seq`` reroutes to the per-cell kernel, so scheduling it
    would run ``fused_cell`` under another name.  Every other plan is
    always viable.
    """
    p_width = max(cfg.input_dim, cfg.hidden)
    block = seq_lib.choose_batch_block(
        batch, seq_len, cfg.n_layers, p_width, cfg.hidden,
        smem_budget=smem_budget)

    def viable(plan_name: str) -> bool:
        return block is not None or plan_name != "fused_seq"

    return viable


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
    are drawn by ``init_params`` from ``generator`` (default: seed 0).  They
    are frozen (``requires_grad=False``): the kernels have no backward yet,
    so this module serves; training is not ported."""

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

        def frozen(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.detach().clone(), requires_grad=False)

        self.layer_w = nn.ParameterList(
            [frozen(p["w"]) for p in params["layers"]])
        self.layer_b = nn.ParameterList(
            [frozen(p["b"]) for p in params["layers"]])
        self.head_w = frozen(params["head"]["w"])
        self.head_b = frozen(params["head"]["b"])

    def params(self) -> dict:
        """The plain parameter dict the plan functions take."""
        return {"layers": [{"w": w, "b": b}
                           for w, b in zip(self.layer_w, self.layer_b)],
                "head": {"w": self.head_w, "b": self.head_b}}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return FORWARD_PLANS[self.plan](self.params(), x, self.cfg)
