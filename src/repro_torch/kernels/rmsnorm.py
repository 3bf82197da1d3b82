"""RMSNorm as a Triton kernel: ``x (R, D)``, ``gamma (D,)`` -> ``(R, D)``.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``
(``_rms_kernel``): ``x * rsqrt(mean(x^2) + eps) * gamma``, computed in f32
and written in x's dtype; gamma is f32 even when x is bf16.

The work is one row reduction followed by an elementwise scale: a few
operations per byte, so it is bound by memory on an H100 (2·R·D·itemsize
bytes at 3.35 TB/s), with no tensor-core work and nothing for asynchronous
copies to hide.  One program per row holds the whole row (D = 4096) in
registers, reads it once and writes it once, which is what a hand-written
CUDA kernel would do too.  At decode (R = max_batch) the launch itself is
the cost.

``triton`` is imported, and the kernel built, on the first launch only, so
the module imports on a machine without triton.
"""
from __future__ import annotations

import os

import torch

from . import _build
from .launches import LAUNCHES, refuse_autograd

_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        # keep triton's compile cache inside the checkout's build directory
        os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def rms_kernel(x_ptr, g_ptr, o_ptr, D, eps, BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            m = cols < D
            x = tl.load(x_ptr + row * D + cols, mask=m, other=0.0).to(tl.float32)
            ms = tl.sum(x * x, axis=0) / D
            g = tl.load(g_ptr + cols, mask=m, other=0.0).to(tl.float32)
            y = x * tl.rsqrt(ms + eps) * g
            tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=m)

        _KERNEL = (triton, rms_kernel)
    return _KERNEL


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch on the current stream; raises on what the kernel does not
    take."""
    refuse_autograd("rmsnorm", x, gamma)
    if not (x.is_cuda and gamma.is_cuda and x.device == gamma.device):
        raise ValueError(f"rmsnorm kernel needs x and gamma on one CUDA "
                         f"device, got {x.device} and {gamma.device}")
    if x.ndim != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm kernel needs x (R, D) and gamma (D,), got "
                         f"{tuple(x.shape)} and {tuple(gamma.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            gamma.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes f32/bf16 x and f32 gamma, got "
                        f"{x.dtype} and {gamma.dtype}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and gamma")
    R, D = x.shape
    out = torch.empty_like(x)
    if R == 0 or D == 0:                # nothing to write: no launch
        return out
    triton, kernel = _kernel()
    block = triton.next_power_of_2(D)
    with torch.cuda.device(x.device):
        kernel[(R,)](x, gamma, out, D, float(eps), BLOCK=block,
                     num_warps=min(16, max(1, block // 512)))
        LAUNCHES["rmsnorm"] += 1
    return out
