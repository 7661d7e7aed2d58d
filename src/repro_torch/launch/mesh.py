"""Device meshes (the port's twin of the JAX package's ``launch/mesh.py``).

A mesh names its axes, gives their sizes as ``shape`` (a name-to-size
dict, what ``partitioning.AxisRules`` reads) and holds its devices.  An
abstract mesh holds none: it checks the production shapes as shapes only,
on a machine with fewer devices than they need.

Production topology (TPU v5e, the JAX package's target): one pod = 256
chips as (data=16, model=16); multi-pod = 2 pods as (pod=2, data=16,
model=16).  The 'pod' axis carries only data parallelism, 'model' carries
tensor/expert/sequence parallelism, 'data' carries batch + FSDP weight
sharding.  On one H100 the host mesh is (data=1, model=1), where every
placement is the identity.  A ``torch.distributed`` ``DeviceMesh`` over a
mesh of more than one device waits for the distributed paths (ROADMAP
Queue 1 item 3); nothing here starts a process group.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` with ``axis_sizes``; ``devices`` in row-major order
    over the axes, or None for an abstract mesh."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"mesh {self.axis_sizes} needs {self.size} "
                             f"devices, given {len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def local_devices(device: str | torch.device = "cuda"
                  ) -> list[torch.device]:
    """The devices of ``device``'s type on this machine (``jax.devices()``'
    twin), or ``device`` alone when it names an index."""
    device = torch.device(device)
    if device.index is not None or device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _production_shape(multi_pod: bool, data: int, model: int
                      ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    assert data * model == 256, (data, model)
    shape = (2, data, model) if multi_pod else (data, model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, data: int = 16,
                         model: int = 16,
                         device: str | torch.device = "cuda") -> Mesh:
    """Default production topology is (16, 16) / (2, 16, 16); `data`/`model`
    allow aspect-ratio ablations over the same 256 chips per pod.  Raises
    when the machine has fewer devices than the mesh needs (always on one
    card: check the shapes with ``abstract_production_mesh``)."""
    shape, axes = _production_shape(multi_pod, data, model)
    n = math.prod(shape)
    devices = local_devices(device)
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {len(devices)} — check "
            "production shapes on an abstract mesh "
            "(abstract_production_mesh)")
    return Mesh(axes, shape, tuple(devices[:n]))


def abstract_production_mesh(*, multi_pod: bool = False, data: int = 16,
                             model: int = 16) -> Mesh:
    """The production mesh's shape with no devices: what spec resolution
    and the abstract trees need, on any machine."""
    shape, axes = _production_shape(multi_pod, data, model)
    return Mesh(axes, shape)


def make_host_mesh(device: str | torch.device = "cuda") -> Mesh:
    """Tiny mesh on the real local device(s) of ``device`` for tests,
    examples and the trainer: every device on ``data``, ``model`` of 1 —
    (data=1, model=1) on one card or the CPU."""
    devices = local_devices(device)
    return Mesh(("data", "model"), (len(devices), 1), tuple(devices))
