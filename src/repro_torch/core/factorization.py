"""Hopper's constants for the budget tables — MobiRNN's packing rule on an
H100.

The paper's Fig 2c rule is to pack many vector products into one coarse work
unit, as coarse as the fast memory allows.  The JAX package sizes Pallas
blocks against TPU VMEM and the 128-wide MXU; on an H100 the fast memory is
a thread block's shared memory and the unit of parallel work is a warp of 32
threads, so the constants the kernels' tables (``kernels/*.py``) price
against are Hopper's.
"""
from __future__ import annotations

#: Dynamic shared memory one thread block may use on an H100 (227 KB of the
#: SM's 256 KB; above 48 KB only after cudaFuncSetAttribute).
H100_SMEM_PER_BLOCK = 232_448
#: Shared memory of one SM (228 KB), which the blocks resident on it share;
#: the runtime reserves 1 KB of it for each block.
H100_SMEM_PER_SM = 233_472
H100_SMEM_RESERVED_PER_BLOCK = 1024
#: Streaming multiprocessors of an H100 SXM.
H100_SMS = 132
#: Threads of one warp — the alignment of a thread block's fast axis.
WARP = 32


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m

