"""The H100's per-block limits and rates, shared by the kernel wrappers,
the autotuner's legality filter and the analysis rule S3.

The port's counterpart of ``repro.kernels.vrf`` (the RVV register-file
budget of the TPU kernels): where a TPU block must fit one register group,
a Hopper block must fit an SM's shared memory, its register file and the
thread limit, and a launch is priced in waves of blocks over the SMs.
Each value is the one the wrappers already check in Python; their names
there are given beside each (those modules read them from here).  The
rates are the NVIDIA H100 SXM5 80GB's datasheet figures (dense, no
sparsity), the ones ``chip_smoke.py`` divides by for its bounds.
"""
from __future__ import annotations

#: the card these limits are for
CARD = "NVIDIA H100 80GB HBM3 (SXM5)"

#: streaming multiprocessors (``matmul.WGMMA_SMS``, ``paged_attention.SMS``,
#: ``stencil.SMS``; ``matmul.DECODE_TARGET_BLOCKS`` and
#: ``reduction.DOT_MAX_BLOCKS`` are multiples of it)
SMS = 132
#: shared memory of one SM, bytes (``stencil.SM_SMEM``)
SM_SMEM_BYTES = 233472
#: shared memory the card keeps back for each resident block, bytes
#: (``stencil.BLOCK_SMEM_RESERVED``)
BLOCK_SMEM_RESERVED = 1024
#: the most shared memory one block may take, static and dynamic together,
#: bytes (``paged_attention.SMEM_BYTES``; ``cudaFuncSetAttribute``'s limit)
BLOCK_SMEM_BYTES = 232448
#: the most static shared memory a block may declare, bytes (a kernel whose
#: tile is a ``__shared__`` array, as ``jacobi_kernel``'s)
STATIC_SMEM_BYTES = 48 * 1024
#: threads a block at most (``reduction.SOFTMAX_MAX_THREADS``)
MAX_THREADS = 1024
#: 32-bit registers a thread at most (ptxas's limit, which the kernels'
#: ``__launch_bounds__`` keep; the build logs print each kernel's count)
MAX_REGS_THREAD = 255
#: the largest grid dimension y and z (``stencil.MAX_ROWS`` counts tiles of
#: 16 rows against it)
MAX_GRID_YZ = 65535

#: the L2 cache, bytes (50 MB on the SXM5 card): a timing whose operands
#: fit it twice over reads them warm unless it rotates copies
#: (``autotune.measure_candidate``)
L2_BYTES = 50 * 2 ** 20
#: HBM bytes a second, and the tensor cores' dense bf16 and the CUDA cores'
#: f32 peak operations a second, and f32-accurate work as three TF32
#: products at the dense TF32 rate (the tf32x3 flash kernels)
#: (``chip_smoke.HBM_BYTES_S``, ``chip_smoke.PEAK_OPS_S``)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12, "tf32x3": 494.7e12 / 3}
#: NVLink 4 bytes a second in each direction of one card (18 links)
NVLINK_BYTES_S = 450e9


def fits_block(smem: int, threads: int, static: bool = False) -> bool:
    """True where a block of ``threads`` threads holding ``smem`` bytes of
    shared memory (a ``__shared__`` array where ``static``) launches at all
    on the card."""
    return 0 < threads <= MAX_THREADS and smem <= (STATIC_SMEM_BYTES if static
                                                   else BLOCK_SMEM_BYTES)


def blocks_per_sm(smem: int, threads: int) -> int:
    """How many such blocks one SM holds at once, by its shared memory and
    its 2,048 threads (at most 32 blocks)."""
    return max(0, min(32, SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED),
                      2048 // max(1, threads)))
