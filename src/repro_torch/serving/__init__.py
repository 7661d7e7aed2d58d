"""Serving of the port: the wave ``Engine`` and the slot-resident
continuous-batching ``SlotEngine`` over preallocated state, with seeded
fault injection (the JAX package's ``serving`` exports, by the same
names).  The slot engine's decode tick is captured in a CUDA graph on the
card (``serving/tick.py``)."""
from repro_torch.serving.engine import Engine, EngineConfig, SlotEngine
from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                        InjectedFault, LanePoison,
                                        PrefillFault, QueueFlood, SlowTick)
from repro_torch.serving.slots import (FINISH_REASONS, FinishReason,
                                       PrefillLane, QueueFull, Request,
                                       RequestQueue, Result, Slot,
                                       SlotManager, TokenEvent,
                                       chunk_schedule)

__all__ = ["Engine", "EngineConfig", "SlotEngine", "Request", "Result",
           "RequestQueue", "QueueFull", "Slot", "SlotManager", "TokenEvent",
           "PrefillLane", "chunk_schedule",
           "FinishReason", "FINISH_REASONS", "FaultPlan", "FaultInjector",
           "InjectedFault", "LanePoison", "PrefillFault", "SlowTick",
           "QueueFlood"]
