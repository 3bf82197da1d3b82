"""The kernel seam (``repro.kernels.ops``'s ``rmsnorm``, ``matmul``,
``dense``, ``attention`` and ``paged_attention``, which the models call, and
the paper's Table I kernels ``jacobi2d``, ``fconv2d``, ``dotprod``,
``dotprod_hier``, ``expv`` and ``softmax_rows``).

The TPU wrappers' tiling knobs (``use_pallas``, ``bh``, ``bw``, ``bm``,
``block``) mean nothing here and are gone, except ``dotprod_hier``'s
``block``, which fixes the padding quantum ``C*L*8*block`` and so each
lane's slice.

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
from . import reduction as _red
from . import ref
from . import rmsnorm as _rms
from . import stencil as _st
from .launches import LAUNCHES, reset as reset_launches

__all__ = ["LAUNCHES", "reset_launches", "rmsnorm", "matmul", "dense",
           "attention", "paged_attention", "jacobi2d", "fconv2d", "dotprod",
           "dotprod_hier", "expv", "softmax_rows"]


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


# -- the paper's Table I kernels ------------------------------------------------

def jacobi2d(x: torch.Tensor) -> torch.Tensor:
    """One Jacobi sweep of x (H, W), unpadded, with a zero boundary."""
    if x.device.type == "cpu":
        return ref.jacobi2d(x)
    return _st.jacobi2d(x.contiguous())


def fconv2d(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Valid 2-D cross-correlation: x (H, W), filt (fr, fc) ->
    (H - fr + 1, W - fc + 1), f32 accumulation, in x's dtype."""
    if x.device.type == "cpu":
        return ref.fconv2d(x, filt)
    return _st.fconv2d(x.contiguous(), filt)


def dotprod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) of two vectors in f32, a 0-d f32 tensor."""
    if a.device.type == "cpu":
        return ref.dotprod(a, b)
    return _red.dotprod(a.contiguous(), b.contiguous())


def dotprod_hier(a: torch.Tensor, b: torch.Tensor, *, C: int, L: int,
                 hierarchy: str = "two-level", block: int = 256) -> torch.Tensor:
    """fdotproduct through the machine-level log-tree: C*L lane partials,
    each over its slice of a and b zero-padded to a multiple of
    ``C*L*8*block``, combined intra-cluster then inter-cluster (or over the
    flattened ring with ``hierarchy="flat"``)."""
    return _red.dotprod_hier(a.contiguous(), b.contiguous(), C=C, L=L,
                             hierarchy=hierarchy, block=block)


def expv(x: torch.Tensor) -> torch.Tensor:
    """exp of a vector by the TPU kernel's polynomial, x clipped to +-80."""
    if x.device.type == "cpu":
        return ref.expv(x)
    return _red.expv(x.contiguous())


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Row softmax of x (R, W), f32 math, in x's dtype."""
    if x.device.type == "cpu":
        return ref.softmax_rows(x)
    return _red.softmax_rows(x.contiguous())
