"""The CUDA matmul kernel's wrapper: ``a (M, K) @ b (K, N)`` on the card.

Counterpart of ``repro.kernels.matmul.matmul``; the kernels and their design
notes are in ``csrc/matmul.cu``.  f32 accumulation, output in ``a``'s dtype,
bf16 or f32.  Ragged edges are masked in the kernels, so nothing is padded.
Each call is exactly one launch, and the same inputs give the same bits.

Which of the three kernels a call takes is ``variant(M, K, N, dtype,
aligned)``, a pure function of the shapes and the dtype:
  * ``"decode"``: bf16, M <= 8 (the engines' decode batches), K and N
    multiples of 8, K > 0: split-K weight streaming on the tensor cores,
    the slices given by ``split_plan(K, N)``;
  * ``"wgmma"``: bf16, M > 8 (prefill), the same alignment: TMA tiles and
    wgmma, K split by ``wgmma_plan(M, K, N)`` where the tiles alone leave
    SMs idle;
  * ``"simt"``: everything else: f32 (the tensor cores have no full-f32
    product), and bf16 with K or N not a multiple of 8, K = 0, or an
    operand whose address is not 16-byte aligned (``aligned`` False; only a
    view can be).  CUDA-core FMAs, as the first port had them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .launches import LAUNCHES, refuse_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"simt": 0, "decode": 1, "wgmma": 2}
_FN = None

#: the decode kernel's column tile and K step (csrc ``dec::BN``, ``dec::BK``)
DECODE_BN = 128
DECODE_BK = 32
#: the longest K slice a decode block takes (csrc ``dec::SLICE_MAX``): A's
#: rows of it sit in shared memory
DECODE_SLICE_MAX = 1024
#: the blocks a decode launch aims at: 4 on each of an H100's 132 SMs, as
#: many as the shared memory of a 1024-long slice lets reside at once
DECODE_TARGET_BLOCKS = 132 * 4
#: the most slices a plan cuts K into where the longest slice allows: the
#: last block of a column tile sums that many partials one after another
DECODE_MAX_SPLITS = 16
#: the wgmma kernel's output tile and K step (csrc ``wg::BM``, ``wg::BN``,
#: ``wg::BK``)
WGMMA_BM, WGMMA_BN, WGMMA_BK = 128, 128, 64
#: the wgmma plan: tiles times slices within one wave (one block on each of
#: an H100's 132 SMs), at most 4 slices of at least 16 K steps, and of
#: those the count that minimises a block's time as measured on the H100:
#: ~0.4 us a 64-deep K step, and ~5 us for each slice past the first (its
#: partial out and the last block's sum)
WGMMA_SMS = 132
WGMMA_MAX_SPLITS = 4
WGMMA_MIN_STEPS = 16
WGMMA_STEP_US = 0.4
WGMMA_SPLIT_US = 5.0
#: the split-K workspace for each (device, stream), shared by the decode and
#: wgmma kernels: one ticket an output tile, zeroed when made and left at
#: zero by every launch, and the f32 partials of the K slices; grown when a
#: call needs more.  Launches on one stream run in order, so they share it.
_WORK: dict = {}


def variant(M: int, K: int, N: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The kernel a call takes: ``"decode"``, ``"wgmma"`` or ``"simt"``."""
    if dtype != torch.bfloat16 or K <= 0 or K % 8 or N % 8 or not aligned:
        return "simt"
    return "decode" if M <= 8 else "wgmma"


@functools.lru_cache(maxsize=1024)
def split_plan(K: int, N: int) -> tuple[int, int]:
    """``(splits, slice)``: the decode kernel cuts K into ``splits`` slices of
    ``slice`` elements (a multiple of ``DECODE_BK``, at most
    ``DECODE_SLICE_MAX``), the last one ragged and none empty, so that the
    column tiles times the slices come near ``DECODE_TARGET_BLOCKS``, with
    at most ``DECODE_MAX_SPLITS`` slices unless the longest slice needs
    more."""
    k_tiles = max(1, math.ceil(K / DECODE_BK))
    col_tiles = math.ceil(N / DECODE_BN)
    splits = max(1, min(k_tiles, DECODE_MAX_SPLITS,
                        DECODE_TARGET_BLOCKS // max(col_tiles, 1)))
    splits = max(splits, math.ceil(K / DECODE_SLICE_MAX))
    slice_tiles = math.ceil(k_tiles / splits)
    return math.ceil(k_tiles / slice_tiles), slice_tiles * DECODE_BK


@functools.lru_cache(maxsize=1024)
def wgmma_plan(M: int, K: int, N: int) -> tuple[int, int]:
    """``(splits, slice)`` of the wgmma kernel: one slice where the 128 x 128
    output tiles fill the card; where they are few (prefill chunks, short
    prompts, narrow projections), K is cut into the count of slices that
    minimises ``WGMMA_STEP_US`` a K step plus ``WGMMA_SPLIT_US`` a further
    slice, among those that keep tiles times slices within ``WGMMA_SMS``,
    at most ``WGMMA_MAX_SPLITS``, each of at least ``WGMMA_MIN_STEPS``."""
    tiles = math.ceil(M / WGMMA_BM) * math.ceil(N / WGMMA_BN)
    k_steps = max(1, math.ceil(K / WGMMA_BK))
    most = max(1, min(WGMMA_SMS // tiles, k_steps // WGMMA_MIN_STEPS,
                      WGMMA_MAX_SPLITS))
    splits = min(range(1, most + 1), key=lambda n: math.ceil(k_steps / n)
                 * WGMMA_STEP_US + (n - 1) * WGMMA_SPLIT_US)
    per = math.ceil(k_steps / splits)
    return math.ceil(k_steps / per), per * WGMMA_BK


def plan(kind: str, M: int, K: int, N: int) -> tuple[int, int, int]:
    """``(splits, slice, tickets)`` of a launch: the split-K plan of its
    variant and the tickets its workspace needs (0 unsplit)."""
    if kind == "decode":
        splits, slice_len = split_plan(K, N)
        tiles = math.ceil(N / DECODE_BN)
    elif kind == "wgmma":
        splits, slice_len = wgmma_plan(M, K, N)
        tiles = math.ceil(M / WGMMA_BM) * math.ceil(N / WGMMA_BN)
    else:
        return 1, 0, 0
    return splits, slice_len, tiles if splits > 1 else 0


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("matmul").repro_matmul
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _workspace(device, stream: int, tiles: int, floats: int):
    """The (tickets, partials) pointers of a split launch on ``stream``."""
    key = (device, stream)
    work = _WORK.get(key)
    if work is None or work[0].numel() < tiles or work[1].numel() < floats:
        old = (0, 0) if work is None else (work[0].numel(), work[1].numel())
        work = (torch.zeros(max(tiles, old[0]), dtype=torch.int32, device=device),
                torch.empty(max(floats, old[1]), dtype=torch.float32, device=device))
        _WORK[key] = work
    return work[0].data_ptr(), work[1].data_ptr()


def _launch(a, b, c, kind: str, idx: int) -> int:
    """One launch of ``kind`` on the current stream of device ``idx`` (the
    current device); returns the CUDA error code."""
    (M, K), N = a.shape, b.shape[1]
    # the raw handle of the current stream, without a Stream object
    stream = torch._C._cuda_getCurrentRawStream(idx)
    splits, slice_len, tiles = plan(kind, M, K, N)
    tickets, partials = (_workspace(a.device, stream, tiles, splits * M * N)
                         if tiles else (0, 0))
    return _fn()(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                 _DTYPES[a.dtype], VARIANTS[kind], splits, slice_len, tickets,
                 partials, stream)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on what it does not
    take (a CPU tensor, another dtype, a non-contiguous operand, an
    operand autograd would have to differentiate)."""
    refuse_autograd("matmul", a, b)
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
    kind = variant(M, K, N, a.dtype, (a.data_ptr() | b.data_ptr()) % 16 == 0)
    # the device guard only where the operands are not on the current
    # device: on the decode path the host's time a call is what a step pays
    idx = a.device.index
    if idx == torch.cuda.current_device():
        err = _launch(a, b, c, kind, idx)
    else:
        with torch.cuda.device(idx):
            err = _launch(a, b, c, kind, idx)
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"matmul kernel ({kind}): CUDA error {err} at launch")
    LAUNCHES["matmul"] += 1
    return c
