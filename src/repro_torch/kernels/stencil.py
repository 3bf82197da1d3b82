"""The CUDA stencil kernels' wrappers (the paper's jacobi2d and fconv2d).

Counterparts of ``repro.kernels.stencil``'s ``jacobi2d`` and ``fconv2d``;
the kernels and their design notes are in ``csrc/stencil.cu``.  Inputs of
f32 or bf16; the output is in the input's dtype.  ``jacobi2d`` takes the
unpadded grid: its zero boundary is the kernel's, so nothing is padded.

Both take the lean launch path of ``reduction.py``: the ctypes functions
and their argument types set once, the raw handle of the current stream,
a device guard only off the current device; fconv2d's plan
(``conv_plan``, cached by shape: the unrolled filter or the generic loop,
and the persistent grid) passed by value.  The checks other than the
device's come first, so they hold on CPU tensors.  No backward: a call
autograd would differentiate raises first.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, hopper
from .launches import LAUNCHES, refuse_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: jacobi2d's output tile and threads (csrc ``BH``, ``BW``, ``THREADS``;
#: its input tile with a one-cell halo is a ``__shared__`` f32 array)
JACOBI_TILE, JACOBI_THREADS = (16, 128), 256
#: the kernels' limits (csrc BH, MAX_TAPS): jacobi2d's grid's second
#: dimension counts tiles of 16 rows; a filter's sides are at most 16
MAX_ROWS = hopper.MAX_GRID_YZ * JACOBI_TILE[0]
MAX_TAPS = 16
#: fconv2d's tile of outputs (csrc CBH x CBW: 4 warps of 8 rows, 32 lanes
#: of 4 columns), the filters it unrolls (square, a template each), and
#: its persistent grid: CONV_BLOCKS_PER_SM blocks on each of the card's SMs
CONV_TILE = (32, 128)
CONV_FIXED = (3, 5, 7)
CONV_BLOCKS_PER_SM = 4
SMS = hopper.SMS
#: an H100 SM's shared memory, and what the card keeps of it for each block
SM_SMEM = hopper.SM_SMEM_BYTES
BLOCK_SMEM_RESERVED = hopper.BLOCK_SMEM_RESERVED

#: each C function's arguments, set once on its ctypes handle (the stream
#: last)
_ARGTYPES = {
    "repro_jacobi2d": [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
    + [ctypes.c_int, ctypes.c_void_p],
    "repro_fconv2d": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.library("stencil"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes f32 or bf16, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous (H, W) grid, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")


def _check_device(name: str, *ts: torch.Tensor) -> None:
    """Last of a wrapper's checks, so the others hold on CPU tensors too."""
    if not (ts[0].is_cuda and all(t.device == ts[0].device for t in ts)):
        raise ValueError(f"{name} kernel needs its operands on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")


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
    _check_device("jacobi2d", x)
    y = torch.empty_like(x)
    if y.numel() == 0:                  # nothing to write: no launch
        return y
    idx = x.get_device()
    args = (x.data_ptr(), y.data_ptr(), H, W, _DTYPES[x.dtype])
    if idx == torch._C._cuda_getDevice():
        err = _fn("repro_jacobi2d")(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = _fn("repro_jacobi2d")(*args, torch._C._cuda_getCurrentRawStream(idx))
    _raise_on(err, "jacobi2d")
    LAUNCHES["jacobi2d"] += 1
    return y


def jacobi_block_resources(H: int, W: int) -> dict:
    """What one block of jacobi2d's launch holds: its halo'd input tile in
    static shared memory, its threads, and the launch's blocks."""
    bh, bw = JACOBI_TILE
    return {"smem": (bh + 2) * (bw + 2) * 4, "threads": JACOBI_THREADS, "static": True,
            "blocks": -(-H // bh) * -(-W // bw)}


class ConvPlan(NamedTuple):
    """How ``fconv2d`` runs a call: ``variant`` the unrolled square filter
    side (3, 5 or 7) or 0 for any other filter; ``grid`` persistent blocks
    over ``tiles`` output tiles; ``smem`` bytes of dynamic shared memory a
    block (two buffers of staged rows, and the generic loop's filter)."""
    variant: int
    tiles: int
    grid: int
    smem: int


@functools.lru_cache(maxsize=1024)
def conv_plan(H: int, W: int, fr: int, fc: int, itemsize: int, sms: int = SMS) -> ConvPlan:
    """The plan of an (H, W) output from an (fr, fc) filter over
    ``itemsize``-byte values: the square 3, 5 and 7 filters unrolled, any
    other the generic loop; one persistent block for each tile, up to
    ``CONV_BLOCKS_PER_SM`` an SM, or as many as the SM's shared memory holds
    (three of the generic loop's f32 blocks for filters of 14 rows or
    more)."""
    variant = fr if fr == fc and fr in CONV_FIXED else 0
    th, tw = CONV_TILE
    tiles = -(-H // th) * -(-W // tw)
    sw = -(-(tw + (fc if variant else MAX_TAPS) - 1) // 8) * 8   # a staged row, csrc SW
    smem = 2 * itemsize * (th + fr - 1) * sw + (0 if variant else 4 * MAX_TAPS ** 2)
    fit = min(CONV_BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
    return ConvPlan(variant, tiles, max(1, min(tiles, fit * sms)), smem)


@functools.lru_cache(maxsize=None)
def _sms(idx: int) -> int:
    """The SM count of device ``idx``."""
    return torch.cuda.get_device_properties(idx).multi_processor_count


def fconv2d(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation of x (H + fr - 1, W + fc - 1) with filt
    (fr, fc), fr and fc at most ``MAX_TAPS``: (H, W) in x's dtype, f32
    accumulation; one launch, none for an empty output."""
    refuse_autograd("fconv2d", x, filt)
    _check("fconv2d", x)
    if filt.ndim != 2:
        raise ValueError(f"fconv2d kernel needs an (fr, fc) filter, got "
                         f"{tuple(filt.shape)}")
    fr, fc = filt.shape
    if not (1 <= fr <= MAX_TAPS and 1 <= fc <= MAX_TAPS):
        raise ValueError(f"fconv2d kernel takes filters of 1 to {MAX_TAPS} taps a "
                         f"side, got {fr} x {fc}")
    _check_device("fconv2d", x, filt)
    H, W = x.shape[0] - fr + 1, x.shape[1] - fc + 1
    if H <= 0 or W <= 0:                # nothing to write: no launch
        return torch.empty((max(H, 0), max(W, 0)), dtype=x.dtype, device=x.device)
    y = torch.empty((H, W), dtype=x.dtype, device=x.device)
    f32 = filt if filt.dtype == torch.float32 and filt.is_contiguous() \
        else filt.to(torch.float32).contiguous()     # the taps as the kernel reads them
    idx = x.get_device()
    p = conv_plan(H, W, fr, fc, x.element_size(), _sms(idx))
    args = (x.data_ptr(), f32.data_ptr(), y.data_ptr(), H, W, fr, fc, _DTYPES[x.dtype],
            p.variant, p.grid)
    if idx == torch._C._cuda_getDevice():
        err = _fn("repro_fconv2d")(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = _fn("repro_fconv2d")(*args, torch._C._cuda_getCurrentRawStream(idx))
    _raise_on(err, "fconv2d")
    LAUNCHES["fconv2d"] += 1
    return y
