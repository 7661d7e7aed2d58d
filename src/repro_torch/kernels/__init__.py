"""The hand-written CUDA kernels and their wrappers.

Each wrapper counts its kernel's launches in its ``launches`` attribute;
``launch_counts`` reads every such counter of the package.
"""
from __future__ import annotations

import importlib
import pkgutil


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
