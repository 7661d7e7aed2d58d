"""Checkpointing: flat-path npz snapshots with atomic rename (the twin of
the JAX package's ``checkpoint/ckpt.py``, whose files it writes and reads).

A tree of tensors (dicts, lists and tuples, as ``convert`` carries the JAX
package's trees) is flattened to ``path/to/leaf`` keys — JAX's keys for
the same tree: a list index is its number, as a tuple index is there —
saved with ``np.savez`` as ``ckpt_%08d.npz`` beside a ``ckpt_%08d.json`` of
the step and ``extra``, and restored against a template, leaf by leaf.

A bfloat16 leaf is written as its 2-byte raw bits (numpy dtype ``V2``),
which is how the JAX package's file holds an ``ml_dtypes.bfloat16`` array,
and is restored from those bits, so a bf16 checkpoint crosses between the
packages bit for bit either way.  (The JAX package's own ``restore`` cannot
cast such a leaf back; the port's can.)
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

_STRIP = re.compile(r"[\[\]'\.]")


def _key(path: tuple) -> str:
    return "/".join(_STRIP.sub("", str(p)) for p in path)


def _leaves(tree: Any, path: tuple = ()):
    """(path, leaf) pairs in JAX's order (dict keys sorted); None is an
    empty subtree, as in a JAX tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    elif tree is not None:
        yield path, tree


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device; raw 2-byte
    records are bfloat16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(path): _to_numpy(leaf) for path, leaf in _leaves(tree)}


def save(directory: str, step: int, tree: Any, extra: dict | None = None
         ) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_ckpt_{step}.npz")
    final = os.path.join(directory, f"ckpt_{step:08d}.npz")
    flat = _flatten(tree)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
    meta = {"step": step, **(extra or {})}
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _rebuild(template: Any, path: tuple, data) -> Any:
    if isinstance(template, dict):
        return {k: _rebuild(v, path + (k,), data)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, path + (i,), data)
                              for i, t in enumerate(template))
    if template is None:
        return None
    key = _key(path)
    if key not in data:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = data[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(
            f"shape mismatch at {key}: ckpt {arr.shape} vs "
            f"template {tuple(template.shape)}")
    return _from_numpy(arr, template)


def restore(directory: str, template: Any, step: int | None = None) -> Any:
    """The tree saved at ``step`` (default the latest), shaped like
    ``template``: each leaf in the template leaf's dtype on its device.
    KeyError for a leaf the file lacks, ValueError for a shape that
    differs."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        return _rebuild(template, (), data)
