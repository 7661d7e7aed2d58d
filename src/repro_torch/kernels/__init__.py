"""The hand-written CUDA kernels and their wrappers.

Each wrapper counts its kernel's launches in its ``launches`` attribute;
``launch_counts`` reads every such counter of the package.  ``CALLS``
counts, by wrapper name, every call that ran the kernel or, for tensors on
the CPU, its plain version in the kernel's place: the count a launch count
rests on, which ``analysis.count_launches`` reads where nothing launches.
``GRID_STEPS`` counts, by wrapper name, the work units the JAX package's
Pallas grid has for the same call (``analysis.count_pallas_grid_steps``):
taken from the wrapper's tiling arguments, not from its CUDA grid.

On ``meta`` tensors (an abstract trace: the dry run) a wrapper computes
nothing: it counts its call and grid steps and returns empty tensors of
its outputs' shapes and dtypes.  A meta tensor holds no values, so this is
no stand-in for the kernel; a CUDA tensor still launches it or raises.
"""
from __future__ import annotations

import collections
import importlib
import pkgutil

import torch

#: calls of each wrapper (by its name) that ran its kernel, or its plain
#: version for CPU tensors; never reset, read as deltas
CALLS: collections.Counter[str] = collections.Counter()
#: the Pallas grid steps of those calls, by wrapper name; read as deltas
GRID_STEPS: collections.Counter[str] = collections.Counter()


def called(name: str, grid_steps: int) -> None:
    """Count one call of wrapper ``name`` and its grid steps."""
    CALLS[name] += 1
    GRID_STEPS[name] += int(grid_steps)


def meta_like(*shapes_dtypes) -> tuple:
    """Empty ``meta`` tensors, one per (shape, dtype): a wrapper's outputs
    on an abstract trace."""
    return tuple(torch.empty(tuple(s), dtype=d, device="meta")
                 for s, d in shapes_dtypes)


def launch_counts() -> dict[str, int]:
    """The ``launches`` count of every kernel wrapper of the package (each
    module-level callable with an integer ``launches`` counter), by its
    name in its module."""
    counts: dict[str, int] = {}
    for info in pkgutil.iter_modules(__path__):
        module = importlib.import_module(f"{__name__}.{info.name}")
        for name, fn in vars(module).items():
            launches = getattr(fn, "launches", None)
            if callable(fn) and isinstance(launches, int):
                counts[name] = launches
    return counts
