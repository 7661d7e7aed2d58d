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
placement is the identity.

A mesh of more than one device runs SPMD over a ``torch.distributed``
process group, one rank a device: when a group is running and its world
size equals the mesh's size, the mesh holds a ``DeviceMesh`` over the
group's ranks with the same axis names in the same order (the twin of the
JAX package's ``jax.sharding.Mesh``), which ``partitioning.device_put``,
``constrain`` and ``shard_map`` place and communicate over.  Nothing here
starts a process group: the caller does (a test, ``chip_smoke.py`` or
``torchrun``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` with ``axis_sizes``; ``devices`` in row-major order
    over the axes, or None for an abstract mesh; ``device_mesh`` the
    ``DeviceMesh`` over a process group's ranks (``group_mesh``), or None
    outside one."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] | None = None
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

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
    allow aspect-ratio ablations over the same 256 chips per pod.  Inside
    a process group of 256 (512) ranks the mesh is ``group_mesh`` over
    them (the dry run's ``fake`` group on one machine: every rank's
    placements with nothing sent); outside one it takes the machine's
    devices and raises when there are fewer than the mesh needs (always on
    one card: check the shapes with ``abstract_production_mesh``)."""
    shape, axes = _production_shape(multi_pod, data, model)
    n = math.prod(shape)
    if dist.is_initialized():
        return group_mesh(axes, shape, device)
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


def group_mesh(axis_names: tuple[str, ...], axis_sizes: tuple[int, ...],
               device: str | torch.device = "cuda") -> Mesh:
    """A mesh over the running process group's ranks, row-major over the
    axes, each rank on ``device`` (every rank the same device: ranks share
    one card or the CPU).  Its ``device_mesh`` is the group's
    ``DeviceMesh`` with the same axis names.  Raises unless a group runs
    whose world size is the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(axis_sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(f"mesh {axis_sizes} needs a process group of {n} "
                           f"ranks, found {world}")
    device = torch.device(device)
    dm = init_device_mesh(device.type, tuple(axis_sizes),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(tuple(axis_names), tuple(axis_sizes), (device,) * n, dm)


def make_host_mesh(model_axis: int = 1,
                   device: str | torch.device = "cuda") -> Mesh:
    """Tiny mesh for tests, examples and the trainer, as the JAX package
    makes it: ``model`` of ``model_axis`` and ``data`` of n // model_axis
    (at least 1) over n devices: the running process group's ranks
    (``group_mesh``; n // model_axis x model_axis must be the world), else
    the local devices of ``device`` ((data=1, model=1) on one card or the
    CPU)."""
    if dist.is_initialized():
        n = dist.get_world_size()
        return group_mesh(("data", "model"),
                          (max(n // model_axis, 1), model_axis), device)
    devices = local_devices(device)
    data = max(len(devices) // model_axis, 1)
    return Mesh(("data", "model"), (data, model_axis),
                tuple(devices[:data * model_axis]))
