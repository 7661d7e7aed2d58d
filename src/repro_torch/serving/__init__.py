"""Serving of the port: the wave engine (``Engine``) over the preallocated
state pool.  The slot engine (continuous batching) and fault handling come
with the serving slice."""
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.slots import FinishReason, Request, Result

__all__ = ["Engine", "EngineConfig", "FinishReason", "Request", "Result"]
