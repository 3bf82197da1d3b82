"""The CUDA paged-attention kernel's wrapper: one decode query per sequence
against K/V blocks gathered through a block table.

Counterpart of ``repro.kernels.paged_attention.paged_attention``; the kernel
and its design notes are in ``csrc/paged_attention.cu``.  Shapes are the JAX
kernel's: q (B, Hkv, G, D), pools (Hkv, NB, bt, D), tables (B, nblk) int32,
lens (B,) int32 -> (B, Hkv, G, D) in q's dtype.  The pools are taken through
their strides, so the model's (NB, bt, Hkv, D) pool is passed as a permuted
view and read in place.

Each sequence's tokens are split over ``plan(...).splits`` blocks
(flash-decoding), from shapes only: ``lens`` stays on the card.  A split
launch merges its slices' partials in the same launch, through tickets and
partials kept per (device, stream); the tickets are zeroed once here and
left at zero by every launch.  The wrapper takes the lean launch path of
``reduction.py``: the ctypes function and its argument types set once, the
raw handle of the current stream, a device guard only off the current
device.  No backward: a call autograd would differentiate raises first.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, hopper
from .autotune import tuned_config
from .launches import LAUNCHES, refuse_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None

#: the kernel's limits (csrc TOK, ROWS, the D templates): a block walks its
#: slice in tiles of 64 tokens, so a pool block (a power of two) divides 64
#: tokens; a warp owns a query row, four a block, so G > 4 takes
#: ceil(G / 4) blocks a kv head; D is one of the kernel's head dims
TOKENS_PER_ROUND = 64
ROWS_PER_BLOCK = 4
MAX_G = 32
HEAD_DIMS = (16, 32, 64, 96, 128)
SMEM_BYTES = hopper.BLOCK_SMEM_BYTES
#: the split plan: the H100's SMs; one slice when the (sequence, kv head,
#: row group) blocks reach FILL_BLOCKS (4 an SM); else about TARGET_BLOCKS
#: (8 an SM) over all slices, at most MAX_SPLITS a sequence
SMS = hopper.SMS
FILL_BLOCKS = 4 * SMS
TARGET_BLOCKS = 8 * SMS
MAX_SPLITS = 16
#: the tickets and partials of each (device index, raw stream): launches on
#: one stream run in order, so they share them
_WORK: dict = {}


class PagedPlan(NamedTuple):
    """How a call runs: ``splits`` slices of ``split_tokens`` tokens a
    sequence (``splits * split_tokens >= nblk * bt``), ``stages`` 2 where a
    slice has more than one tile (the next tile's K and V prefetched), and
    ``groups`` blocks of four query rows a kv head."""
    splits: int
    split_tokens: int
    stages: int
    groups: int


@functools.lru_cache(maxsize=1024)
def plan(B: int, Hkv: int, G: int, max_tokens: int) -> PagedPlan:
    """The plan for B sequences of Hkv kv heads of G query rows whose tables
    hold ``max_tokens`` (nblk * bt) tokens: shapes only, so the same shapes
    take the same slices and give the same bits."""
    groups = -(-G // ROWS_PER_BLOCK)
    blocks = B * Hkv * groups
    tiles = max(1, -(-max_tokens // TOKENS_PER_ROUND))
    want = 1 if blocks >= FILL_BLOCKS else min(tiles, MAX_SPLITS,
                                                -(-TARGET_BLOCKS // blocks))
    per = -(-tiles // want)             # tiles a slice
    return PagedPlan(-(-tiles // per), per * TOKENS_PER_ROUND, 2 if per > 1 else 1,
                     groups)


def plan_with_splits(B: int, Hkv: int, G: int, max_tokens: int, splits: int) -> PagedPlan:
    """The plan that cuts each sequence into ``splits`` slices of whole
    64-token tiles (as few as make the same slices; at least one tile a
    slice)."""
    groups = -(-G // ROWS_PER_BLOCK)
    tiles = max(1, -(-max_tokens // TOKENS_PER_ROUND))
    per = -(-tiles // max(1, min(splits, tiles)))
    return PagedPlan(-(-tiles // per), per * TOKENS_PER_ROUND, 2 if per > 1 else 1,
                     groups)


def legal_plan(B: int, Hkv: int, G: int, T: int, bt: int, splits: int) -> bool:
    """True where a pool of ``bt``-token blocks (a power of two that divides
    the kernel's 64-token round and ``T``) and ``splits`` slices (as
    :func:`plan_with_splits` makes them, at most ``MAX_SPLITS``) are a plan
    the kernel takes for ``T`` tokens a sequence."""
    return (bt >= 1 and bt & (bt - 1) == 0 and TOKENS_PER_ROUND % bt == 0
            and T % bt == 0 and 1 <= splits <= MAX_SPLITS
            and splits == plan_with_splits(B, Hkv, G, T, splits).splits)


def block_resources(B: int, Hkv: int, G: int, T: int, D: int, itemsize: int,
                    splits: int) -> dict:
    """What one block of a launch of ``splits`` slices holds: dynamic shared
    memory (:func:`smem_bytes`), threads (a warp a query row), and the
    launch's blocks."""
    p = plan_with_splits(B, Hkv, G, T, splits)
    return {"smem": smem_bytes(D, itemsize, p.stages), "threads": 32 * ROWS_PER_BLOCK,
            "static": False, "blocks": B * Hkv * p.groups * p.splits}


def tuned_plan(B: int, Hkv: int, G: int, D: int, bt: int, nblk: int,
               dtype: torch.dtype) -> PagedPlan:
    """The split count of the ambient autotune table for this signature
    (``(B, Hq, Hkv, nblk * bt, D)``) where its block is the pool's,
    else :func:`plan`'s (always outside ``autotune.tuned()``)."""
    T = nblk * bt
    cfg = tuned_config("paged_attention", (B, Hkv * G, Hkv, T, D), dtype)
    if cfg is not None and cfg["bt"] == bt:
        return plan_with_splits(B, Hkv, G, T, cfg["splits"])
    return plan(B, Hkv, G, T)


def smem_bytes(D: int, itemsize: int, stages: int) -> int:
    """Dynamic shared memory of one block: ``stages`` K and V tiles of 64
    rows of D values (16 bytes of pad a row), and four query rows in f32."""
    return (2 * stages * TOKENS_PER_ROUND * (D + 16 // itemsize) * itemsize
            + 4 * ROWS_PER_BLOCK * D)


def workspace_floats(B: int, Hkv: int, D: int, p: PagedPlan) -> int:
    """f32 partials of a split launch: (acc, m, l) of four rows a block."""
    return B * Hkv * p.groups * p.splits * ROWS_PER_BLOCK * (D + 2)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("paged_attention").repro_paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _workspace(idx: int, stream: int, tickets: int, floats: int) -> tuple[int, int]:
    """The (tickets, partials) addresses of a split launch on ``stream`` of
    device ``idx``, grown as a call needs."""
    work = _WORK.get((idx, stream))
    if work is None or work[0].numel() < tickets or work[1].numel() < floats:
        old = (0, 0) if work is None else (work[0].numel(), work[1].numel())
        t = torch.zeros(max(tickets, old[0]), dtype=torch.int32, device=idx)
        f = torch.empty(max(floats, old[1]), dtype=torch.float32, device=idx)
        work = _WORK[(idx, stream)] = (t, f, t.data_ptr(), f.data_ptr())
    return work[2], work[3]


def _launch(q, kpool, vpool, tables, lens, out, ps, p: PagedPlan, idx: int) -> int:
    B, Hkv, G, D = q.shape
    qs = q.stride()
    stream = torch._C._cuda_getCurrentRawStream(idx)
    tickets, part = (_workspace(idx, stream, B * Hkv * p.groups,
                                workspace_floats(B, Hkv, D, p))
                     if p.splits > 1 else (None, None))
    return _fn()(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), tables.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), B, Hkv, G, D,
                 kpool.shape[2].bit_length() - 1, tables.shape[1], qs[0], qs[1], qs[2],
                 ps[0], ps[1], ps[2], p.splits, p.split_tokens, p.stages, tickets, part,
                 _DTYPES[q.dtype], stream)


def paged_attention(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
                    tables: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on what it does not
    take.  Table entries must index the pool: they are not checked, since
    that would read them back from the card."""
    refuse_autograd("paged_attention", q, kpool, vpool, tables, lens)
    if q.dtype not in _DTYPES or kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel takes f32 or bf16 q and pools "
                        f"of one dtype, got {q.dtype}, {kpool.dtype}, {vpool.dtype}")
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"paged_attention kernel takes int32 tables and lens, "
                        f"got {tables.dtype} and {lens.dtype}")
    if q.ndim != 4 or kpool.ndim != 4 or kpool.shape != vpool.shape:
        raise ValueError(f"paged_attention kernel needs q (B, Hkv, G, D) and "
                         f"pools (Hkv, NB, bt, D), got {tuple(q.shape)}, "
                         f"{tuple(kpool.shape)}, {tuple(vpool.shape)}")
    B, Hkv, G, D = q.shape
    bt = kpool.shape[2]
    if kpool.shape[0] != Hkv or kpool.shape[3] != D or tables.ndim != 2 \
            or tables.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"paged_attention kernel: shapes disagree: q "
                         f"{tuple(q.shape)}, pool {tuple(kpool.shape)}, tables "
                         f"{tuple(tables.shape)}, lens {tuple(lens.shape)}")
    ps = kpool.stride()
    if ps != vpool.stride() or q.stride(3) != 1 or ps[3] != 1:
        raise ValueError("paged_attention kernel needs the last dim of q and of "
                         "the pools contiguous, and one set of pool strides")
    if not (tables.is_contiguous() and lens.is_contiguous()):
        raise ValueError("paged_attention kernel needs contiguous tables and lens")
    epc = 16 // q.element_size()        # elements of one 16-byte copy
    if (ps[0] | ps[1] | ps[2]) % epc or (kpool.data_ptr() | vpool.data_ptr()) % 16:
        raise ValueError("paged_attention kernel needs 16-byte aligned pools "
                         "with every stride a multiple of 16 bytes")
    if D not in HEAD_DIMS or G > MAX_G or bt > TOKENS_PER_ROUND \
            or TOKENS_PER_ROUND % bt or B >= 2 ** 16 or Hkv * -(-G // 4) >= 2 ** 16:
        raise ValueError(f"paged_attention kernel: G={G}, D={D}, bt={bt}, B={B} "
                         f"exceed its limits (D in {HEAD_DIMS}, G <= {MAX_G}, bt "
                         f"a power of two dividing {TOKENS_PER_ROUND}, B and "
                         f"Hkv * ceil(G / 4) below 2**16)")
    idx = q.get_device()                # -1 on the CPU
    if idx < 0 or any(t.get_device() != idx for t in (kpool, vpool, tables, lens)):
        raise ValueError(f"paged_attention kernel needs every operand on one "
                         f"CUDA device, got {[str(t.device) for t in (q, kpool, vpool, tables, lens)]}")
    out = torch.empty((B, Hkv, G, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:                # nothing to write: no launch
        return out
    p = tuned_plan(B, Hkv, G, D, bt, tables.shape[1], q.dtype)
    if idx == torch._C._cuda_getDevice():
        err = _launch(q, kpool, vpool, tables, lens, out, ps, p, idx)
    else:
        with torch.cuda.device(idx):
            err = _launch(q, kpool, vpool, tables, lens, out, ps, p, idx)
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"paged_attention kernel: CUDA error {err} at launch")
    LAUNCHES["paged_attention"] += 1
    return out
