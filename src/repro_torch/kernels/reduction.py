"""The CUDA reduction kernels' wrappers (the paper's fdotproduct, exp and
softmax), and the machine-level partial combine.

Counterparts of ``repro.kernels.reduction``'s ``dotprod``, ``expv``,
``softmax_rows``, ``_pairwise_tree``, ``combine_partials`` and
``dotprod_hier``; the kernels and their design notes are in
``csrc/reduction.cu``.  Inputs of f32 or bf16, any length: the ragged edge
is masked in the kernel, so nothing is padded or copied.

``dotprod`` and ``dotprod_hier`` launch one kernel each: ``dotprod_hier``'s
C*L lane partials come from one launch (a segment per lane), not C*L, and
are then combined on the device in the RINGI log-tree order by
``combine_partials``, plain torch adds in the JAX pairing.  ``dotprod_hier``
composes the same way on the CPU, its lane partials from the plain version.

``dotprod``, ``expv`` and ``softmax_rows`` take the lean launch path: the
ctypes function and its argument types resolved once, the raw handle of
the current stream (no Stream object), a device guard only off the current
device, the dot workspace's address kept per (device, stream), dotprod's
0-d result written by the kernel, and softmax's plan (``softmax_plan``,
cached by shape) passed by value.  No kernel has a backward: a call that
autograd would have to differentiate raises before anything is checked.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build, hopper, ref
from .autotune import tuned_config
from .launches import LAUNCHES, plain, refuse_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}

#: the dot kernel's block (csrc DOT_THREADS), the blocks of it an SM holds
#: at once (csrc DOT_MIN_BLOCKS: ptxas keeps the kernel within 32 registers
#: a thread, so 8 blocks of 256 fit), and the most blocks one call puts on
#: the card: one resident wave on 132 SMs.  A call's grid depends on its
#: sizes only, so its order of additions, and its result, do not vary
DOT_THREADS = 256
DOT_BLOCKS_PER_SM = 8
DOT_MAX_BLOCKS = hopper.SMS * DOT_BLOCKS_PER_SM
#: softmax_rows' limits (csrc SOFTMAX_*): 16-byte vectors a thread holds in
#: the "regs" branch, and threads a block
SOFTMAX_REG_VECS = 4
SOFTMAX_MAX_THREADS = hopper.MAX_THREADS
#: the most segments a dot launch takes (blockIdx.y), which also bounds its
#: block partials (nseg * blocks a segment <= max(nseg, DOT_MAX_BLOCKS))
DOT_MAX_SEGS = 65535
#: the dot kernel's workspace for each (device index, raw stream): a tensor
#: of DOT_MAX_SEGS tickets, zeroed once here and left at zero by every
#: launch, then as many f32 block partials, kept with its address;
#: launches on one stream run in order, so they share it
_DOT_WORK: dict = {}
#: a 0-d f32 tensor on each device, the model of dotprod's output
_SCALARS: dict = {}

#: each C function's arguments, set once on its ctypes handle (the stream
#: last)
_ARGTYPES = {
    "repro_dot": [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
    "repro_expv": [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p],
    "repro_softmax_rows": [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_BRANCHES = {"regs": 0, "stream": 1}
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.library("reduction"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(name: str, x: torch.Tensor, y: torch.Tensor | None = None) -> None:
    ts = (x,) if y is None else (x, y)
    if not x.is_cuda or (y is not None and y.device != x.device):
        raise ValueError(f"{name} kernel needs its operands on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if x.dtype not in _DTYPES or (y is not None and y.dtype != x.dtype):
        raise TypeError(f"{name} kernel takes f32 or bf16 operands of one dtype, "
                        f"got {[t.dtype for t in ts]}")
    if not (x.is_contiguous() and (y is None or y.is_contiguous())):
        raise ValueError(f"{name} kernel needs contiguous operands")


def _raise_on(err: int, name: str) -> None:
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"{name} kernel: CUDA error {err} at launch")


@functools.lru_cache(maxsize=1024)
def dot_blocks(seg_len: int, nseg: int = 1) -> int:
    """Blocks a segment of ``seg_len`` elements gets: one per 4 vectors of
    16 bytes a thread (f32), at most ``DOT_MAX_BLOCKS`` over all segments."""
    want = max(1, math.ceil(seg_len / (DOT_THREADS * 16)))
    return min(want, max(1, DOT_MAX_BLOCKS // nseg))


def dot_seg_len(n: int) -> int:
    """dotprod's one segment for n elements: n rounded up to 8."""
    return max(8, -(-n // 8) * 8)


def tuned_dot_blocks(n: int, dtype: torch.dtype) -> int:
    """dotprod's blocks for n elements: the ambient autotune table's where
    it has them (never outside ``autotune.tuned()``), else
    :func:`dot_blocks`'."""
    cfg = tuned_config("reduction", (n,), dtype)
    return dot_blocks(dot_seg_len(n)) if cfg is None else cfg["blocks"]


def legal_dot_blocks(bps: int) -> bool:
    """True where one dotprod segment may run on ``bps`` blocks."""
    return 1 <= bps <= DOT_MAX_BLOCKS


def dot_block_resources(bps: int) -> dict:
    """What one block of a one-segment dotprod on ``bps`` blocks holds."""
    return {"smem": 0, "threads": DOT_THREADS, "static": False, "blocks": bps}


def dot_chain(seg_len: int, nseg: int = 1, bps: int | None = None) -> int:
    """The longest chain of f32 additions behind one segment's sum (a bound
    for Higham's ``|err| <= chain * 2**-24 * sum|a_i b_i|``): a thread's
    elements in order (whole 16-byte vectors of up to 8 values, plus one of
    the ragged tail) and ten levels of the block tree; where the segment
    has more than one block, the last block's share of the block partials
    in order and ten levels again.  A one-block segment writes its block's
    sum.  ``bps``: the blocks a segment where not :func:`dot_blocks`' (a
    tuned plan)."""
    bps = dot_blocks(seg_len, nseg) if bps is None else bps
    chain = math.ceil(seg_len / (bps * DOT_THREADS * 8)) * 8 + 1 + 10
    return chain if bps == 1 else chain + math.ceil(bps / DOT_THREADS) + 10


def _dot_work(idx: int, stream: int) -> int:
    """The address of the dot workspace of ``stream`` on device ``idx``."""
    work = _DOT_WORK.get((idx, stream))
    if work is None:
        t = torch.zeros(2 * DOT_MAX_SEGS, dtype=torch.int32, device=idx)
        work = _DOT_WORK[(idx, stream)] = (t, t.data_ptr())
    return work[1]


def _scalar_out(idx: int) -> torch.Tensor:
    """A fresh 0-d f32 tensor on device ``idx``: ``empty_like`` of one kept
    there, which costs the host less than parsing an empty size."""
    like = _SCALARS.get(idx)
    if like is None:
        like = _SCALARS[idx] = torch.empty((), dtype=torch.float32, device=idx)
    return torch.empty_like(like)


def _launch_dot(a, b, seg_len: int, nseg: int, bps: int, out, idx: int) -> int:
    stream = torch._C._cuda_getCurrentRawStream(idx)
    return _fn("repro_dot")(a.data_ptr(), b.data_ptr(), a.numel(), seg_len,
                            nseg, bps, _dot_work(idx, stream),
                            out.data_ptr(), _DTYPES[a.dtype], stream)


def _dot(a: torch.Tensor, b: torch.Tensor, seg_len: int, nseg: int,
         scalar: bool = False, bps: int | None = None) -> torch.Tensor:
    """(nseg,) f32 partials (a 0-d one where ``scalar``), segment s over
    a[s*seg_len : (s+1)*seg_len] (elements past the end count as zeros),
    from one launch on the current stream of ``bps`` blocks a segment
    (:func:`dot_blocks`' where None)."""
    refuse_autograd("dotprod", a, b)
    _check("dotprod", a, b)
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"dotprod kernel needs two vectors of one length, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not 1 <= nseg <= DOT_MAX_SEGS or seg_len % 8:
        raise ValueError(f"dotprod kernel: {nseg} segments of {seg_len} (at most "
                         f"{DOT_MAX_SEGS} segments, a multiple of 8 long)")
    idx = a.get_device()
    out = _scalar_out(idx) if scalar else torch.empty(nseg, dtype=torch.float32,
                                                       device=idx)
    bps = dot_blocks(seg_len, nseg) if bps is None else bps
    # the device guard only where a is not on the current device, and the
    # raw handle of the current stream, without a Stream object
    if idx == torch._C._cuda_getDevice():
        err = _launch_dot(a, b, seg_len, nseg, bps, out, idx)
    else:
        with torch.cuda.device(idx):
            err = _launch_dot(a, b, seg_len, nseg, bps, out, idx)
    _raise_on(err, "dotprod")
    LAUNCHES["dotprod"] += 1
    return out


def dotprod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) in f32, a 0-d f32 tensor the kernel writes; one launch of
    :func:`tuned_dot_blocks`' blocks."""
    n = a.numel()
    return _dot(a, b, dot_seg_len(n), 1, scalar=True,
                bps=tuned_dot_blocks(n, a.dtype))


def expv(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's exp (``_exp_poly`` on x clipped to +-80), element by
    element, in x's dtype; one launch, none for an empty x."""
    refuse_autograd("expv", x)
    _check("expv", x)
    y = torch.empty_like(x)
    if x.numel() == 0:                  # nothing to write: no launch
        return y
    idx = x.get_device()
    args = (x.data_ptr(), y.data_ptr(), x.numel(), _DTYPES[x.dtype])
    if idx == torch._C._cuda_getDevice():
        err = _fn("repro_expv")(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = _fn("repro_expv")(*args, torch._C._cuda_getCurrentRawStream(idx))
    _raise_on(err, "expv")
    LAUNCHES["expv"] += 1
    return y


class SoftmaxPlan(NamedTuple):
    """How ``softmax_rows`` runs a call: the branch, and the threads of the
    one block a row."""
    branch: str
    threads: int


@functools.lru_cache(maxsize=1024)
def softmax_plan(W: int, itemsize: int, aligned: bool) -> SoftmaxPlan:
    """The branch of ``csrc/reduction.cu``'s softmax for rows of W elements
    of ``itemsize`` bytes; ``aligned``: x is 16-byte aligned and a row is
    whole 16-byte vectors.

    * ``regs``: an aligned row of at most ``SOFTMAX_REG_VECS`` vectors a
      thread over 1024 threads, held in registers: one read.  As few
      threads as hold it, a whole number of warps.
    * ``stream``: any other row, read twice by 1024 threads (an unaligned
      one by plain loads).  On the H100 a row split over a thread-block
      cluster, with few enough rows in flight for the second read to come
      from L2, was slower at 256 rows of 2**20 f32 (PERF.md, section 6).
    """
    V = 16 // itemsize
    nvec = -(-W // V)
    if aligned and nvec <= SOFTMAX_REG_VECS * SOFTMAX_MAX_THREADS:
        return SoftmaxPlan("regs", max(32, -(-nvec // (SOFTMAX_REG_VECS * 32)) * 32))
    return SoftmaxPlan("stream", SOFTMAX_MAX_THREADS)


def _launch_softmax(x, y, idx: int) -> int:
    R, W = x.shape
    item = _ITEMSIZE[x.dtype]
    plan = softmax_plan(W, item, x.data_ptr() % 16 == 0 and W * item % 16 == 0)
    return _fn("repro_softmax_rows")(
        x.data_ptr(), y.data_ptr(), R, W, _DTYPES[x.dtype], _BRANCHES[plan.branch],
        plan.threads, torch._C._cuda_getCurrentRawStream(idx))


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Softmax of each row of x (R, W), f32 math, in x's dtype; one launch
    (the branch ``softmax_plan`` gives), none for an empty x."""
    refuse_autograd("softmax_rows", x)
    _check("softmax_rows", x)
    if x.ndim != 2:
        raise ValueError(f"softmax_rows kernel needs (R, W), got {tuple(x.shape)}")
    R, W = x.shape
    if R >= 2 ** 31:
        raise ValueError(f"softmax_rows kernel takes fewer than 2**31 rows, got {R}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    idx = x.get_device()
    if idx == torch._C._cuda_getDevice():
        err = _launch_softmax(x, y, idx)
    else:
        with torch.cuda.device(idx):
            err = _launch_softmax(x, y, idx)
    _raise_on(err, "softmax_rows")
    LAUNCHES["softmax_rows"] += 1
    return y


# -- the machine-level log-tree (not a kernel) ----------------------------------

def _pairwise_tree(v: torch.Tensor, op) -> torch.Tensor:
    """Binary-tree reduce along dim 0 in the fixed pairing of the
    recursive-doubling hardware stages: neighbours pair up, an odd
    straggler folds in the next round."""
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            tail, v = v[-1:], v[:-1]
            v = torch.cat([op(v[0::2], v[1::2]), tail], dim=0)
        else:
            v = op(v[0::2], v[1::2])
    return v[0]


def combine_partials(partials: torch.Tensor, C: int, L: int,
                     hierarchy: str = "two-level", op=torch.add) -> torch.Tensor:
    """Combine the (C*L, ...) per-lane partials in the RINGI log-tree order:
    ``"two-level"``, the log2(L) intra-cluster stages of every cluster at
    once, then log2(C) inter-cluster stages; ``"flat"``, one tree over the
    flattened ring.  On the partials' device."""
    if partials.shape[0] != C * L:
        raise ValueError(f"{partials.shape[0]} partials for C*L = {C * L} lanes")
    if hierarchy == "two-level":
        per_cluster = partials.reshape((C, L) + tuple(partials.shape[1:]))
        intra = _pairwise_tree(per_cluster.transpose(0, 1), op)
        return _pairwise_tree(intra, op)
    if hierarchy == "flat":
        return _pairwise_tree(partials, op)
    raise ValueError(f"unknown hierarchy {hierarchy!r}")


def lane_len(n: int, C: int, L: int, block: int = 256) -> int:
    """Each lane's slice of an n-vector: n zero-padded to a multiple of
    ``C*L*8*block`` (the JAX wrapper's padding quantum), over C*L lanes."""
    quantum = C * L * 8 * block
    return max(1, -(-n // quantum)) * quantum // (C * L)


def lane_partials(a: torch.Tensor, b: torch.Tensor, C: int, L: int,
                  block: int = 256) -> torch.Tensor:
    """The C*L lanes' partial dot products, lane i over its contiguous slice
    (``lane_len``) of a and b, from one launch; no padding copy."""
    return _dot(a, b, lane_len(a.numel(), C, L, block), C * L)


def dotprod_hier(a: torch.Tensor, b: torch.Tensor, *, C: int, L: int,
                 hierarchy: str = "two-level", block: int = 256) -> torch.Tensor:
    """fdotproduct through the machine's 4-stage pipeline: the lanes'
    partials (on the card one launch, on the CPU the plain version),
    combined on their device intra-cluster then inter-cluster (or over the
    flattened ring with ``hierarchy="flat"``)."""
    if plain(a):
        parts = ref.lane_dots(a, b, lane_len(a.numel(), C, L, block), C * L)
    else:
        parts = lane_partials(a, b, C, L, block)
    return combine_partials(parts, C, L, hierarchy)
