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

Where autograd records the call, the wrapper is :class:`RMSNorm`, whose
backward is the kernel ``rms_bwd_vec_kernel`` (``csrc/rmsnorm.cu``; rows
that are not whole 16-byte vectors take the scalar ``rms_bwd_kernel``):
dx in x's dtype and dgamma in f32, from x, gamma and dy (nothing but x and
gamma is kept from the forward).  Each row is read once into registers,
and a block keeps its columns' gamma and dgamma partial in registers.  The
TPU kernel has no backward: the reference trains by ``jax.grad`` of its
jnp path, whose gradient is ``ref.rmsnorm_bwd``'s formula.  dgamma sums
over rows in a fixed order (``bwd_blocks`` partials, then one sum of them
in block order), so the bits do not vary between runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .autotune import tuned_config
from .launches import LAUNCHES, plain, wants_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = []
_BWD = []
#: the backward's blocks: block p takes rows p, p + P, ... and keeps their
#: dgamma partial (f32, D columns) in registers; two an H100 SM
BWD_BLOCKS = 264
#: the vector path's 16-byte vectors of x (and of dy) a thread, and its most
#: threads a block (csrc ``BWD_VECS``, ``BWD_VEC_MAX_THREADS``)
BWD_VECS, BWD_VEC_MAX_THREADS = 2, 512
_PATHS = {"scalar": 0, "vec": 1}


def _fn():
    if not _FN:
        fn = _build.library("rmsnorm").repro_rmsnorm
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _bwd_fn():
    if not _BWD:
        fn = _build.library("rmsnorm").repro_rmsnorm_bwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BWD.append(fn)
    return _BWD[0]


def bwd_path(D: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The backward's kernel for rows of D: ``"vec"`` (whole 16-byte
    vectors, at most ``BWD_VECS`` of x and of dy a thread over at most
    ``BWD_VEC_MAX_THREADS``, every operand 16-byte aligned) or
    ``"scalar"``."""
    per = 16 // (2 if dtype == torch.bfloat16 else 4)      # elements a vector
    nvec = D // per
    fits = -(-nvec // BWD_VECS) <= BWD_VEC_MAX_THREADS
    return "vec" if aligned and D % per == 0 and fits else "scalar"


def bwd_blocks(R: int) -> int:
    """The backward's blocks for R rows: one a row up to ``BWD_BLOCKS``."""
    return max(1, min(R, BWD_BLOCKS))


def legal_bwd_blocks(R: int, P: int) -> bool:
    """True where the backward may run on ``P`` blocks: 1 to one a row."""
    return 1 <= P <= max(1, R)


def bwd_block_resources(R: int, D: int, itemsize: int, P: int) -> dict:
    """What one block of the backward on ``P`` blocks holds: no shared
    memory, the vector path's threads (csrc ``bwd_vec_threads``: whole warps
    of ``BWD_VECS`` 16-byte vectors each, at most ``BWD_VEC_MAX_THREADS``)."""
    nvec = -(-D // (16 // itemsize))
    threads = min(BWD_VEC_MAX_THREADS, max(32, -(-nvec // (BWD_VECS * 32)) * 32))
    return {"smem": 0, "threads": threads, "static": False, "blocks": P}


def tuned_bwd_blocks(R: int, D: int, dtype: torch.dtype) -> int:
    """The backward's blocks: the ambient autotune table's for (R, D) where
    it has them (never outside ``autotune.tuned()``), else
    :func:`bwd_blocks`'."""
    cfg = tuned_config("rmsnorm", (R, D), dtype)
    return bwd_blocks(R) if cfg is None else cfg["bwd_blocks"]


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch on the current stream; raises on what the kernel does not
    take (the device last), and launches nothing for an empty x.  Where
    autograd records the call, it goes through :class:`RMSNorm`."""
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
    if wants_grad(x, gamma):
        return RMSNorm.apply(x, gamma, eps)
    return _forward(x, gamma, eps)


def _forward(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward launch, on inputs :func:`rmsnorm` has checked."""
    R, D = x.shape
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


def backward(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
             eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """dx (x's dtype) and dgamma (f32) of the forward on (x, gamma) for the
    output's gradient dy, by one call of the backward kernel (two grids:
    the rows, then dgamma's sum of the blocks' partials).  x and gamma as
    :func:`rmsnorm` takes them; dy like x."""
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"rmsnorm backward needs a contiguous dy like x, got "
                         f"{tuple(dy.shape)} {dy.dtype} for {tuple(x.shape)} "
                         f"{x.dtype}")
    if not (x.is_cuda and dy.device == x.device and gamma.device == x.device):
        raise ValueError(f"rmsnorm backward needs dy, x and gamma on one CUDA "
                         f"device, got {dy.device}, {x.device}, {gamma.device}")
    R, D = x.shape
    dx = torch.empty_like(x)
    if R == 0 or D == 0:                # nothing to write: no launch
        return dx, torch.zeros(D, dtype=torch.float32, device=x.device)
    dgamma = torch.empty(D, dtype=torch.float32, device=x.device)
    P = tuned_bwd_blocks(R, D, x.dtype)
    part = torch.empty((P, D), dtype=torch.float32, device=x.device)
    idx = x.get_device()
    aligned = not (x.data_ptr() | dy.data_ptr() | gamma.data_ptr()) % 16
    path = bwd_path(D, x.dtype, aligned)
    args = (x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dgamma.data_ptr(), part.data_ptr(), R, D, P, eps, _DTYPES[x.dtype],
            _PATHS[path])
    if idx == torch._C._cuda_getDevice():
        err = _bwd_fn()(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = _bwd_fn()(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"rmsnorm backward kernel ({path}): CUDA error {err} "
                           f"at launch")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dgamma


class RMSNorm(torch.autograd.Function):
    """RMSNorm with its backward: the kernels for CUDA tensors (checked by
    :func:`rmsnorm`), the plain versions ``ref.rmsnorm`` and
    ``ref.rmsnorm_bwd`` for CPU tensors (``ops.rmsnorm``'s CPU path); x of
    any shape on the CPU, (R, D) on the card."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        y = ref.rmsnorm(x, gamma, eps) if plain(x) \
            else _forward(x, gamma, eps)
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        if plain(x):
            dx, dgamma = ref.rmsnorm_bwd(dy, x, gamma, ctx.eps)
        else:
            dx, dgamma = backward(dy.contiguous(), x, gamma, ctx.eps)
        return dx, dgamma, None
