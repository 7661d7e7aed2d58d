"""The hand-written CUDA kernels and their wrappers.

Each wrapper counts its kernel's launches in its ``launches`` attribute;
``launch_counts`` reads every such counter of the package.  ``CALLS``
counts, by wrapper name, every call that ran the kernel or, for tensors on
the CPU, its plain version in the kernel's place: the count a launch count
rests on, which ``analysis.count_launches`` reads where nothing launches.
"""
from __future__ import annotations

import collections
import importlib
import pkgutil

#: calls of each wrapper (by its name) that ran its kernel, or its plain
#: version for CPU tensors; never reset, read as deltas
CALLS: collections.Counter[str] = collections.Counter()


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
