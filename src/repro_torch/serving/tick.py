"""The slot engine's decode tick, captured in a CUDA graph on the card.

The JAX package runs each decode plan as ``jax.jit(fn, donate_argnums=(1,))``:
one fixed-shape executable whose cache is updated in place.  The port's
counterpart is a CUDA graph per plan over preallocated buffers: the
manager's cache (serving/slots.SlotManager, never rebound) and its
``tokens``, ``active`` and ``poison`` (B,) buffers are the tick's static
inputs; its outputs are the logits, the greedy ``sampled`` (B,) int32 and
``lane_ok`` (B,) bool, and its last op copies ``sampled`` into ``tokens``
(JAX's ``set_sampled``), so a healthy tick uploads nothing and reads back
only ``sampled`` and ``lane_ok``.

``DecodeTick(fn, params, cache, batch, graph=True)`` on a CUDA device:
  * warms the tick up once on a side stream (K9's arrival counters
    ``decode_attn._counters``, the kernels' libraries and any other lazily
    built state exist before capture; with every lane inactive the warmup
    leaves the cache bit for bit as it was),
  * captures it once, into the memory pool ``pool`` that every plan's
    graph of one engine shares (``torch.cuda.graph_pool_handle()``), so
    two plans do not double the activation memory: a tick's
    intermediates are dead when its replay ends and its outputs are held
    by this object, so the graphs may replay in any order, one at a time,
  * and replays it on every call.
A capture or replay that fails raises: nothing drops to the eager tick.
With ``graph=False`` (a CPU cache, or a caller that asks for it) each call
runs the same function eagerly.

Inside the tick nothing may read a device value on the host (``.item()``,
``.cpu()``, ``nonzero``, boolean-mask indexing, ``if tensor:``): under
capture that breaks the capture or freezes the value into the graph.
``tests/test_torch_serving_slots.py`` runs a tick of each family under a
dispatch mode that fails on every such op.

Two things a captured tick does differently from an eager one:
  * the kernels' wrappers count a launch (``launches``) when the Python
    wrapper runs, i.e. at capture, not at replay: a served tick's
    launches are ``captured_launches`` times the ticks replayed;
  * K9 allocates its split workspace per call: under capture it comes
    from the graph's pool at a fixed address, which is right for one
    stream (ROADMAP, Known limits).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.kernels import launch_counts


class DecodeTick:
    """One decode plan's tick over static buffers.

    ``fn(params, cache, batch) -> (sampled, lane_ok, logits)`` is the
    plan (the engine wraps every plan with the active mask, the poison
    hook, the finite guard and greedy sampling); ``batch`` holds the
    static ``tokens``, ``active`` and ``poison`` tensors.  Calling the
    tick runs one decode step and returns ``(sampled, lane_ok, logits)``:
    the graph's static outputs when captured, fresh tensors otherwise.
    """

    def __init__(self, fn: Callable, params: Any, cache: Any, batch: dict,
                 *, graph: bool, pool=None):
        self.fn = fn
        self.params = params
        self.cache = cache
        self.batch = batch
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple[torch.Tensor, ...] | None = None
        #: kernel launches the capture recorded, i.e. per replayed tick
        self.captured_launches: dict[str, int] = {}
        device = batch["tokens"].device
        if graph:
            if device.type != "cuda":
                raise ValueError(f"DecodeTick: a CUDA graph needs a CUDA "
                                 f"cache, not {device}")
            self._capture(device, pool)

    def _step(self) -> tuple[torch.Tensor, ...]:
        with torch.no_grad():
            sampled, lane_ok, logits = self.fn(self.params, self.cache,
                                               self.batch)
            self.batch["tokens"].copy_(sampled)        # set_sampled
        return sampled, lane_ok, logits

    def _capture(self, device: torch.device, pool) -> None:
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._step()                               # warmup
        stream.wait_stream(side)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = self._step()
        after = launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}

    def __call__(self) -> tuple[torch.Tensor, ...]:
        if self.graph is None:
            return self._step()
        self.graph.replay()
        return self.outputs
