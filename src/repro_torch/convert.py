"""Carrying weights across from the JAX package.

The JAX package's plain parameter tree — ``partitioning.split`` of its
``core/lstm.init_params`` with every leaf mapped through ``np.asarray`` —
has the same structure and layouts as the port's:
``{"layers": [{"w": (D+H, 4H), "b": (4H,)}, ...], "head": {"w": (H, C),
"b": (C,)}}``, gate order (i, f, g, o).  So carrying it across is a copy of
every leaf into a tensor; nothing is transposed or reordered.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device: str | torch.device = "cpu"):
    """The port's parameter tree from a tree of numpy arrays (dicts and
    lists kept as they are), each leaf copied into a tensor on ``device``
    with its dtype unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)
