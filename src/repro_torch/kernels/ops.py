"""The models' kernel seam (``repro.kernels.ops``'s ``rmsnorm``, ``matmul``,
``dense``, ``attention`` and ``paged_attention``).

A tensor on the CPU goes to the kernel's plain version (``ref``); a CUDA
tensor goes to the kernel, or the call raises.  There is no fallback
between the two.  ``LAUNCHES`` (kept in ``launches``) counts the kernel
launches the wrappers make, so a run can show that its path went through
the kernels.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import matmul as _mm
from . import paged_attention as _pa
from . import ref
from . import rmsnorm as _rms
from .launches import LAUNCHES, reset as reset_launches

__all__ = ["LAUNCHES", "reset_launches", "rmsnorm", "matmul", "dense",
           "attention", "paged_attention"]


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm over the last dim of ``x``; gamma f32, result in x's dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, gamma, eps)
    shape = x.shape
    out = _rms.rmsnorm(x.reshape(-1, shape[-1]).contiguous(), gamma, eps)
    return out.reshape(shape)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b (K, N)``, f32 accumulation, result in a's dtype."""
    if a.device.type == "cpu":
        return ref.matmul(a, b)
    return _mm.matmul(a.contiguous(), b.contiguous())


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The projection seam: ``x @ w`` contracting x's last dim, with the
    leading dims flattened into the matmul's M."""
    lead = x.shape[:-1]
    out = matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Causal / sliding-window GQA attention: q (B, Hq, S, D), k/v
    (B, Hkv, Sk, D) -> (B, Hq, S, D), any strides."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def paged_attention(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
                    tables: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """One query row group per sequence against a block pool: q
    (B, Hkv, G, D), pools (Hkv, NB, bt, D) (any strides), tables (B, nblk)
    int32, lens (B,) int32 -> (B, Hkv, G, D)."""
    if q.device.type == "cpu":
        return ref.paged_attention(q, kpool, vpool, tables, lens)
    return _pa.paged_attention(q, kpool, vpool, tables, lens)
