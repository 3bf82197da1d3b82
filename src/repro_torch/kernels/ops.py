"""The models' kernel seam (``repro.kernels.ops``'s ``rmsnorm``, ``matmul``
and ``dense``).

A tensor on the CPU goes to the kernel's plain version (``ref``); a CUDA
tensor goes to the kernel, or the call raises.  There is no fallback
between the two.  ``LAUNCHES`` (kept in ``launches``) counts the kernel
launches the wrappers make, so a run can show that its path went through
the kernels.
"""
from __future__ import annotations

import torch

from . import matmul as _mm
from . import ref
from . import rmsnorm as _rms
from .launches import LAUNCHES, reset as reset_launches

__all__ = ["LAUNCHES", "reset_launches", "rmsnorm", "matmul", "dense"]


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
