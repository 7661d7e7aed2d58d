"""Work-unit factorization cost model (paper §3.1-3.2, Figs 2-3), and
Hopper's constants for the budget tables — MobiRNN's packing rule on an
H100.

MobiRNN's central observation: the latency of a decomposed computation is

    T(n_units) = n_units * enqueue_overhead
                 + ceil(n_units / cores) * max(unit_compute, unit_memory)

and on a constrained accelerator (few cores, shared memory, high per-unit
overhead) the fine-grained desktop factorization (one work unit per weight
column, Fig 2b) is dominated by the overhead term; packing many columns
into one unit (Fig 2c) wins.  ``unit_time``, ``factorize_gate`` and
``best_cols_per_unit`` are the JAX package's model with the same float
operations in the same order, so both give the same Python floats; the
four paper profiles are its Nexus-5-calibrated values.  ``H100`` is one
more profile, MODELLED from this card's published rates, its shared
memory and a measured launch cost; ``chip_smoke.py``'s F1 phase times the
paper's factorizations on the card beside it.

The same packing rule sizes the port's kernels: the fast memory is a
thread block's shared memory and the unit of parallel work a warp of 32
threads, so the constants the kernels' tables (``kernels/*.py``) price
against are Hopper's.  The JAX package's TPU half of this module
(``TPU_V5E``, ``MXU_ALIGN``, ``DEFAULT_VMEM_BUDGET``, ``choose_block``,
``grid_steps``) sizes MXU-aligned Pallas blocks against VMEM; the port's
shared-memory tables replace it, so it has no twin here.
"""
from __future__ import annotations

import dataclasses
import math

#: Dynamic shared memory one thread block may use on an H100 (227 KB of the
#: SM's 256 KB; above 48 KB only after cudaFuncSetAttribute).
H100_SMEM_PER_BLOCK = 232_448
#: Shared memory of one SM (228 KB), which the blocks resident on it share;
#: the runtime reserves 1 KB of it for each block.
H100_SMEM_PER_SM = 233_472
H100_SMEM_RESERVED_PER_BLOCK = 1024
#: Streaming multiprocessors of an H100 SXM.
H100_SMS = 132
#: 32-bit registers of one H100 SM.
H100_REGS_PER_SM = 65_536
#: Threads of one warp — the alignment of a thread block's fast axis.
WARP = 32
#: Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the
#: 700 W power limit): HBM bytes/s; f32 FLOP/s outside the tensor cores
#: (the LSTM, RWKV6 and Mamba kernels run on the CUDA cores); the bf16 and
#: TF32 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def blocks_per_sm(smem: int, threads: int | None = None,
                  regs_per_thread: int | None = None) -> int:
    """Blocks of ``smem`` bytes of dynamic shared memory an H100 SM holds
    at once; with ``threads`` and ``regs_per_thread``, also no more than
    its register file holds (registers go to whole warps)."""
    n = H100_SMEM_PER_SM // (smem + H100_SMEM_RESERVED_PER_BLOCK)
    if threads is not None:
        warps = -(-threads // WARP)
        n = min(n, H100_REGS_PER_SM // (warps * WARP * regs_per_thread))
    return n


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    cores: int                    # parallel work-unit slots
    enqueue_overhead_s: float     # PER-WORK-UNIT launch/scheduling cost
    flops_per_core: float         # sustained FLOP/s per slot
    fast_mem_bytes: int           # shared-memory working-set budget
    mem_bw: float                 # bytes/s to backing memory (shared)


# Calibrated so the model reproduces the paper's measured RATIOS on the
# Nexus-5-class device (Fig 3: fine-grained GPU ~4x slower than 1-thread
# CPU; Fig 4: packed GPU ~3.9x faster; Fig 6: 4-thread CPU >= 70% of GPU)
# while keeping physically plausible magnitudes (Adreno 330 ~ 130 GFLOPs
# peak but tiny shared memory and ~us-scale per-unit dispatch; Krait CPU
# ~2 GFLOPs/core sustained on this workload).
DESKTOP_GPU = DeviceProfile("desktop-gpu", 2048, 5e-9, 5e9, 96 * 1024, 300e9)
MOBILE_GPU = DeviceProfile("mobile-gpu", 128, 5e-7, 2.2e9, 8 * 1024, 12.8e9)
MOBILE_CPU4 = DeviceProfile("mobile-cpu-4t", 4, 1e-7, 0.55e9, 1 << 20,
                            12.8e9)
# single-thread CPU baseline is the paper's plain-Java loop (~0.6 GFLOP/s
# sustained on Krait for this access pattern)
MOBILE_CPU1 = DeviceProfile("mobile-cpu-1t", 1, 5e-8, 0.6e9, 1 << 20,
                            12.8e9)

#: One work unit's host cost on an H100: a ``fused_cell`` window's host
#: clock over its 256 cell launches (``forward_fused_kernel`` on the
#: paper's 2 x 32, T=128 window at B=1), as the whole of ``chip_smoke.py``
#: measured it in its F1 phase on an H100 80GB HBM3 at a 700.00 W power
#: limit: 10.666 ms / 256 = 41.67 us, as an earlier run's ``fused_cell``
#: read 10.710 ms / 256 = 41.8 us.  It is the host's cost, and the host
#: varies from machine to machine.
#: A unit of this model is one launch of the wrapper: its Python, its
#: ctypes call and the CUDA runtime's enqueue; the kernel itself runs ~2.4
#: us of it.
H100_ENQUEUE_OVERHEAD_S = 41.67e-6
#: MODELLED, not calibrated to any figure: an SM a core at the f32
#: CUDA-core peak (``F32_FLOP_PER_S`` over the SMs), a thread block's
#: shared memory as the fast memory, the HBM rate, and the launch cost
#: above as the per-unit overhead.
H100 = DeviceProfile("h100-modelled", H100_SMS, H100_ENQUEUE_OVERHEAD_S,
                     F32_FLOP_PER_S / H100_SMS, H100_SMEM_PER_BLOCK,
                     HBM_BYTES_PER_S)


def unit_time(dev: DeviceProfile, n_units: int, flops_per_unit: float,
              bytes_per_unit: float = 0.0) -> float:
    """Latency of n_units work units under the paper's scheduling model:
    every unit pays an enqueue cost (serialised through the host — this is
    what buries the fine factorization, §3.1), then units execute in waves
    of `cores`, each wave bounded by compute or its share of memory bw."""
    waves = math.ceil(n_units / dev.cores)
    compute = flops_per_unit / dev.flops_per_core
    per_core_bw = dev.mem_bw / min(n_units, dev.cores)
    mem = bytes_per_unit / per_core_bw
    return n_units * dev.enqueue_overhead_s + waves * max(compute, mem)


def factorize_gate(dev: DeviceProfile, in_dim: int, out_dim: int,
                   cols_per_unit: int, bytes_per_elem: int = 4) -> float:
    """Latency of one gate matvec (in_dim -> out_dim) split into column
    blocks of ``cols_per_unit`` (Fig 2b: cols_per_unit=1; Fig 2c: packed)."""
    n_units = math.ceil(out_dim / cols_per_unit)
    flops = 2.0 * in_dim * cols_per_unit
    byts = bytes_per_elem * (in_dim * cols_per_unit + in_dim + cols_per_unit)
    return unit_time(dev, n_units, flops, byts)


def best_cols_per_unit(dev: DeviceProfile, in_dim: int, out_dim: int,
                       bytes_per_elem: int = 4) -> int:
    """Coarsest column block whose working set fits the fast memory —
    MobiRNN's packing rule."""
    best, best_t = 1, float("inf")
    c = 1
    while c <= out_dim:
        ws = bytes_per_elem * (in_dim * c + in_dim + c)
        if ws <= dev.fast_mem_bytes:
            t = factorize_gate(dev, in_dim, out_dim, c, bytes_per_elem)
            if t < best_t:
                best, best_t = c, t
        c *= 2
    return best
