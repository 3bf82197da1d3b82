"""RMSNorm as a CUDA kernel: ``x (R, D)``, ``gamma (D,)`` -> ``(R, D)``.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``
(``_rms_kernel``): ``x * rsqrt(mean(x^2) + eps) * gamma``, computed in f32
and written in x's dtype; gamma is f32 even when x is bf16.  The kernel
and its design notes are in ``csrc/rmsnorm.cu``: one block a row, the row
in registers as 16-byte vectors, a fixed order of additions, a scalar path
for rows that are not whole vectors.

The wrapper takes the lean launch path of ``reduction.expv``: the ctypes
function resolved once, the raw handle of the current stream (no Stream
object), a device guard only off the current device.  At decode the call
is a few microseconds of device time, so the host's cost is most of it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .launches import LAUNCHES, refuse_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = []


def _fn():
    if not _FN:
        fn = _build.library("rmsnorm").repro_rmsnorm
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch on the current stream; raises on what the kernel does not
    take (autograd first, the device last), and launches nothing for an
    empty x."""
    refuse_autograd("rmsnorm", x, gamma)
    if x.ndim != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm kernel needs x (R, D) and gamma (D,), got "
                         f"{tuple(x.shape)} and {tuple(gamma.shape)}")
    if x.dtype not in _DTYPES or gamma.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes f32/bf16 x and f32 gamma, got "
                        f"{x.dtype} and {gamma.dtype}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and gamma")
    if not (x.is_cuda and gamma.device == x.device):
        raise ValueError(f"rmsnorm kernel needs x and gamma on one CUDA "
                         f"device, got {x.device} and {gamma.device}")
    R, D = x.shape
    if R >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"rmsnorm kernel takes fewer than 2**31 rows and "
                         f"columns, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    if R == 0 or D == 0:                # nothing to write: no launch
        return out
    idx = x.get_device()
    args = (x.data_ptr(), gamma.data_ptr(), out.data_ptr(), R, D, eps,
            _DTYPES[x.dtype])
    if idx == torch._C._cuda_getDevice():
        err = _fn()(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = _fn()(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"rmsnorm kernel: CUDA error {err} at launch")
    LAUNCHES["rmsnorm"] += 1
    return out
