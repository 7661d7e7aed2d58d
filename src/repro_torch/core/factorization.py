"""Block sizes for Hopper thread blocks — MobiRNN's packing rule on an H100.

The paper's Fig 2c rule is to pack many vector products into one coarse work
unit, as coarse as the fast memory allows.  The JAX package sizes Pallas
blocks against TPU VMEM and the 128-wide MXU; on an H100 the fast memory is
a thread block's shared memory and the unit of parallel work is a warp of 32
threads, so the constants here are Hopper's.
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
#: Threads per thread block the cell kernel aims for.
CTA_THREADS = 256


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def choose_block(m: int, n: int, k: int) -> tuple[int, int, int]:
    """Pick (bm, bn, bk) for a thread block that owns a (bm, bn) tile of an
    (m, n) output with one thread per element, over a reduction depth k.

    bn is n rounded up to a warp and capped at ``CTA_THREADS``; bm takes
    the rest of the thread budget (at least one row, at most m); bk is k
    whole, because the block stages its (bm, k) f32 rows of the left
    operand in shared memory — bm halves until that staging fits
    ``H100_SMEM_PER_BLOCK``.
    Small tiles spread a batch over many of the H100's 132 SMs instead of
    piling it onto one, which the TPU's single core never had to consider.
    """
    bn = min(round_up(n, WARP), CTA_THREADS)
    bm = max(1, min(m, CTA_THREADS // bn))
    while bm > 1 and bm * k * 4 > H100_SMEM_PER_BLOCK:
        bm //= 2
    return bm, bn, k
