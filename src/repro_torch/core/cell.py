"""LSTM cell math — fused (MobiRNN-style) and fine-grained (desktop-CUDA-style).

The paper's §3.1/§3.2 contrast two factorizations of one gate computation:

* **CUDA-style (fine)**: the input vector is multiplied against each weight
  column as an independent work unit, then unfused per-gate stages.
* **MobiRNN (coarse/fused)**: the four gate matmuls are combined into ONE
  matmul against W_fused in R^{(d+h) x 4h} and the point-wise gate math is
  fused behind it (Fig 2c).

Both are plain PyTorch here and numerically identical; the fused form is what
the CUDA kernel (kernels/csrc/lstm_cell.cu) implements on the card.

Weight layout of the fused cell:  W in R^{(input_dim + hidden) x 4*hidden},
gate order (i, f, g, o) — input, forget, candidate, output.  b in R^{4*hidden}
with the forget-gate bias initialised to +1.0.
"""
from __future__ import annotations

import torch

from repro_torch.partitioning import Annot, dense_init, split


def init_cell_annot(gen: torch.Generator, input_dim: int, hidden: int,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Fused-cell parameters on the CPU with logical sharding axes: ``w``
    ("embed", "mlp") truncated normal in [-2, 2] scaled by (input_dim +
    hidden) ** -0.5, ``b`` ("mlp",) zero except the forget gate's +1.
    ``gen`` is a CPU ``torch.Generator``; move the result with ``.to``."""
    b = torch.zeros(4 * hidden, dtype=torch.float32)
    b[hidden:2 * hidden] = 1.0
    return {"w": dense_init(gen, (input_dim + hidden, 4 * hidden),
                            ("embed", "mlp"), dtype),
            "b": Annot(b.to(dtype), ("mlp",))}


def init_cell(gen: torch.Generator, input_dim: int, hidden: int,
              dtype: torch.dtype = torch.float32) -> dict:
    """``init_cell_annot``'s plain tensors."""
    return split(init_cell_annot(gen, input_dim, hidden, dtype))[0]


def lstm_cell_fused(params: dict, x: torch.Tensor, c: torch.Tensor,
                    h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MobiRNN-style fused cell: one matmul on cat([x, h]), fused gates.

    x: (..., input_dim); c, h: (..., hidden).  Returns (c', h').
    """
    xh = torch.cat([x, h], dim=-1)
    gates = xh @ params["w"] + params["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return c_new, h_new


def lstm_cell_fine(params: dict, x: torch.Tensor, c: torch.Tensor,
                   h: torch.Tensor, unit_cols: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Desktop-CUDA-style fine-grained factorization of the same cell: the
    gate computation is split into ``4*hidden / unit_cols`` independent
    column-block products (one per weight column when unit_cols=1), followed
    by unfused per-gate point-wise stages."""
    hidden = c.shape[-1]
    xh = torch.cat([x, h], dim=-1)
    w, b = params["w"], params["b"]
    cols = [xh @ w[:, lo:lo + unit_cols]
            for lo in range(0, 4 * hidden, unit_cols)]
    gates = torch.cat(cols, dim=-1) + b
    i = torch.sigmoid(gates[..., 0 * hidden:1 * hidden])
    f = torch.sigmoid(gates[..., 1 * hidden:2 * hidden])
    g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(gates[..., 3 * hidden:4 * hidden])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return c_new, h_new


def cell_flops(input_dim: int, hidden: int, batch: int = 1) -> int:
    """Analytic FLOPs of one cell step (matmul-dominated)."""
    return 2 * batch * (input_dim + hidden) * 4 * hidden
