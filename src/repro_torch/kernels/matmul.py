"""The CUDA matmul kernel's wrapper: ``a (M, K) @ b (K, N)`` on the card.

Counterpart of ``repro.kernels.matmul.matmul``; the kernel and its design
notes are in ``csrc/matmul.cu``.  f32 accumulation, output in ``a``'s dtype,
bf16 or f32.  Ragged edges are masked in the kernel, so nothing is padded.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .launches import LAUNCHES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("matmul").repro_matmul
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on what it does not
    take (a CPU tensor, another dtype, a non-contiguous operand)."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"matmul kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"matmul kernel takes f32 or bf16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul kernel needs (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel needs contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"matmul kernel dims must fit int32, got {M, K, N}")
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:                # nothing to write: no launch
        return c
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                    _DTYPES[a.dtype], stream)
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"matmul kernel: CUDA error {err} at launch")
    LAUNCHES["matmul"] += 1
    return c
