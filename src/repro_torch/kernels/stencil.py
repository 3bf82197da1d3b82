"""The CUDA stencil kernels' wrappers (the paper's jacobi2d and fconv2d).

Counterparts of ``repro.kernels.stencil``'s ``jacobi2d`` and ``fconv2d``;
the kernels and their design notes are in ``csrc/stencil.cu``.  Inputs of
f32 or bf16; the output is in the input's dtype.  ``jacobi2d`` takes the
unpadded grid: its zero boundary is the kernel's, so nothing is padded.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .launches import LAUNCHES, refuse_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS: dict = {}

#: the kernels' limits (csrc BH, MAX_TAPS): the grid's second dimension
#: counts tiles of 16 rows, and the filter's sides are at most 16
MAX_ROWS = 65535 * 16
MAX_TAPS = 16


def _fn(name: str, argtypes: list):
    if name not in _FNS:
        fn = getattr(_build.library("stencil"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _check(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes f32 or bf16, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous (H, W) grid, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"{name} kernel: CUDA error {err} at launch")


def jacobi2d(x: torch.Tensor) -> torch.Tensor:
    """One Jacobi sweep of x (H, W) with a zero boundary -> (H, W); one
    launch, none for an empty grid."""
    refuse_autograd("jacobi2d", x)
    _check("jacobi2d", x)
    H, W = x.shape
    if H > MAX_ROWS:
        raise ValueError(f"jacobi2d kernel takes at most {MAX_ROWS} rows, got {H}")
    y = torch.empty_like(x)
    if y.numel() == 0:                  # nothing to write: no launch
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("repro_jacobi2d", [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
                  + [ctypes.c_int, ctypes.c_void_p])(
            x.data_ptr(), y.data_ptr(), H, W, _DTYPES[x.dtype], stream)
    _raise_on(err, "jacobi2d")
    LAUNCHES["jacobi2d"] += 1
    return y


def fconv2d(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation of x (H + fr - 1, W + fc - 1) with filt
    (fr, fc), fr and fc at most ``MAX_TAPS``: (H, W) in x's dtype, f32
    accumulation; one launch, none for an empty output."""
    refuse_autograd("fconv2d", x, filt)
    _check("fconv2d", x)
    if filt.ndim != 2 or filt.device != x.device:
        raise ValueError(f"fconv2d kernel needs an (fr, fc) filter on {x.device}, "
                         f"got {tuple(filt.shape)} on {filt.device}")
    fr, fc = filt.shape
    if not (1 <= fr <= MAX_TAPS and 1 <= fc <= MAX_TAPS):
        raise ValueError(f"fconv2d kernel takes filters of 1 to {MAX_TAPS} taps a "
                         f"side, got {fr} x {fc}")
    H, W = x.shape[0] - fr + 1, x.shape[1] - fc + 1
    if H > MAX_ROWS:
        raise ValueError(f"fconv2d kernel makes at most {MAX_ROWS} rows, got {H}")
    y = torch.empty((max(H, 0), max(W, 0)), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    f32 = filt.to(torch.float32).contiguous()     # the taps as the kernel reads them
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("repro_fconv2d", [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])(
            x.data_ptr(), f32.data_ptr(), y.data_ptr(), H, W, fr, fc,
            _DTYPES[x.dtype], stream)
    _raise_on(err, "fconv2d")
    LAUNCHES["fconv2d"] += 1
    return y
