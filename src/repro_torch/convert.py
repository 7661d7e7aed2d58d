"""Carrying weights and caches across from the JAX package.

A JAX tree — ``partitioning.split`` of a parameter or cache tree with every
leaf mapped through ``np.asarray`` — has the same structure and layouts as
the port's, so carrying it across is a copy of every leaf into a tensor;
nothing is transposed or reordered.  Dicts stay dicts; lists and tuples
become lists.  The trees it carries:

* the LSTM classifier (``core/lstm.init_params``): ``{"layers": [{"w":
  (D+H, 4H), "b": (4H,)}, ...], "head": {"w": (H, C), "b": (C,)}}``, gate
  order (i, f, g, o);
* the language models (``models/transformer.init_params``, the dense attention,
  RWKV6 and Mamba paths and the modality fronts): ``{"embed": (V, d), "blocks":
  [slot, ...], "final_norm": {"scale", ...}, "lm_head": {"w": (d, V)}}`` (no
  ``lm_head`` with tied embeddings; with audio codebooks ``"audio_embed": (K,
  V, d)`` and ``"audio_heads": (K, d, V)`` in place of ``embed`` and
  ``lm_head``; with vision tokens also ``"vis_proj": {"in": {"w": (vis_dim, d),
  "b"}, "out": {"w": (d, d), "b"}}``), one slot per layer of the period (JAX
  keeps them in a tuple), each ``{"ln1", "mix", "ln2", "mlp"}`` with every leaf
  stacked over layer groups (leading layer axis); every weight keeps the JAX
  layout ``(d_in, d_out)`` for ``x @ w``, and an attention mix its head axes:
  ``wq`` (d, Hq, dh), ``wk``/``wv`` (d, Hkv, dh), ``wo`` (Hq, dh, d), and with
  QKV biases ``bq`` (Hq, dh), ``bk``/``bv`` (Hkv, dh);
* their decode caches (``init_cache``): ``{"pos": () int32, "slots":
  [slot, ...]}``, an attention slot ``{"k", "v": (G, B, S_c, Hkv, dh)}``
  in the model dtype, or int8 with ``"k_scale", "v_scale": (G, B, S_c,
  Hkv)`` f32 for an int8 cache, an rwkv6 slot ``{"shift_t": (G, B, d),
  "wkv": (G, B, H, dh, dh) f32, "shift_c": (G, B, d)}``, a mamba slot
  ``{"conv": (G, B, dc-1, di), "h": (G, B, di, ds) f32}``.

``params_to_numpy`` is the way back (the port's params, grads or caches as
numpy, for comparing them with the JAX package's).  A bfloat16 leaf (the
JAX package's numpy arrays of ``ml_dtypes.bfloat16``) crosses bit for bit
both ways; numpy has no bfloat16 of its own, so the way back imports
``ml_dtypes`` for such a leaf only.
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
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def params_to_numpy(tree):
    """A tree of tensors (dicts and lists kept as they are) as numpy arrays
    on the host, detached from any graph."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
