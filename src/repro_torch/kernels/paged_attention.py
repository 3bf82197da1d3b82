"""The CUDA paged-attention kernel's wrapper: one decode query per sequence
against K/V blocks gathered through a block table.

Counterpart of ``repro.kernels.paged_attention.paged_attention``; the kernel
and its design notes are in ``csrc/paged_attention.cu``.  Shapes are the JAX
kernel's: q (B, Hkv, G, D), pools (Hkv, NB, bt, D), tables (B, nblk) int32,
lens (B,) int32 -> (B, Hkv, G, D) in q's dtype.  The pools are taken through
their strides, so the model's (NB, bt, Hkv, D) pool is passed as a permuted
view and read in place.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .launches import LAUNCHES, refuse_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None

#: the kernel's limits (csrc TOK, MAX_G, MAX_QD): it walks a sequence in
#: rounds of 64 tokens, so a pool block must divide 64 tokens; the G query
#: rows and their G * D accumulators live in registers; a round's K and V
#: are staged twice over in shared memory, up to the card's 227 KB
TOKENS_PER_ROUND = 64
MAX_G = 32
MAX_QD = 4096
MAX_D = 128
SMEM_BYTES = 232448


def smem_bytes(G: int, D: int, nblk: int, itemsize: int) -> int:
    """Shared memory of one block: two staged K and V tiles of 64 rows of D
    values (16 bytes of pad a row), q, the scores and three per-row scalars
    in f32, and the sequence's block table."""
    ld = D + 16 // itemsize
    return (4 * TOKENS_PER_ROUND * ld * itemsize
            + 4 * (G * D + G * TOKENS_PER_ROUND + 3 * G) + 4 * nblk)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("paged_attention").repro_paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def paged_attention(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
                    tables: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on what it does not
    take.  Table entries must index the pool: they are not checked, since
    that would read them back from the card."""
    ts = (q, kpool, vpool, tables, lens)
    refuse_autograd("paged_attention", *ts)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"paged_attention kernel needs every operand on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel takes f32 or bf16 q and pools "
                        f"of one dtype, got {q.dtype}, {kpool.dtype}, {vpool.dtype}")
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"paged_attention kernel takes int32 tables and lens, "
                        f"got {tables.dtype} and {lens.dtype}")
    if q.ndim != 4 or kpool.ndim != 4 or kpool.shape != vpool.shape:
        raise ValueError(f"paged_attention kernel needs q (B, Hkv, G, D) and "
                         f"pools (Hkv, NB, bt, D), got {tuple(q.shape)}, "
                         f"{tuple(kpool.shape)}, {tuple(vpool.shape)}")
    B, Hkv, G, D = q.shape
    bt = kpool.shape[2]
    if kpool.shape[0] != Hkv or kpool.shape[3] != D or tables.ndim != 2 \
            or tables.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"paged_attention kernel: shapes disagree: q "
                         f"{tuple(q.shape)}, pool {tuple(kpool.shape)}, tables "
                         f"{tuple(tables.shape)}, lens {tuple(lens.shape)}")
    if kpool.stride() != vpool.stride() or q.stride(3) != 1 or kpool.stride(3) != 1:
        raise ValueError("paged_attention kernel needs the last dim of q and of "
                         "the pools contiguous, and one set of pool strides")
    if not (tables.is_contiguous() and lens.is_contiguous()):
        raise ValueError("paged_attention kernel needs contiguous tables and lens")
    epc = 16 // q.element_size()        # elements of one 16-byte copy
    if D % epc or any(s % epc for s in (*q.stride()[:3], *kpool.stride()[:3])) \
            or any(t.data_ptr() % 16 for t in (q, kpool, vpool)):
        raise ValueError("paged_attention kernel needs 16-byte aligned q and "
                         "pools, with D and every stride a multiple of 16 bytes")
    if TOKENS_PER_ROUND % bt or G > MAX_G or G * D > MAX_QD or D > MAX_D \
            or smem_bytes(G, D, tables.shape[1], q.element_size()) > SMEM_BYTES:
        raise ValueError(f"paged_attention kernel: G={G}, D={D}, bt={bt}, nblk="
                         f"{tables.shape[1]} exceed its limits (bt divides "
                         f"{TOKENS_PER_ROUND}, G <= {MAX_G}, G*D <= {MAX_QD}, "
                         f"D <= {MAX_D})")
    out = torch.empty((B, Hkv, G, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:                # nothing to write: no launch
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                    tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                    B, Hkv, G, D, bt, tables.shape[1], *q.stride()[:3],
                    *kpool.stride()[:3], _DTYPES[q.dtype], stream)
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"paged_attention kernel: CUDA error {err} at launch")
    LAUNCHES["paged_attention"] += 1
    return out
