"""The CUDA matmul kernel's wrapper: ``a (M, K) @ b (K, N)`` on the card.

Counterpart of ``repro.kernels.matmul.matmul``; the kernels and their design
notes are in ``csrc/matmul.cu``.  f32 accumulation, output in ``a``'s dtype,
bf16 or f32.  Ragged edges are masked in the kernels, so nothing is padded.
Each call is exactly one launch (tf32x3's prologue and kernel are one
call), and the same inputs give the same bits.

Which of the four kernels a call takes is ``variant(M, K, N, dtype,
aligned, trans)``, a pure function of the shapes, the dtype and the
product (``trans`` 0 the forward ``A B``):
  * ``"decode"``: bf16, M <= 8 (the engines' decode batches), K and N
    multiples of 8, K > 0: split-K weight streaming on the tensor cores,
    the slices given by ``split_plan(K, N)``;
  * ``"wgmma"``: bf16, M > 8 (prefill), the same alignment: TMA tiles and
    wgmma, K split by ``wgmma_plan(M, K, N, trans)`` where the tiles alone
    leave SMs idle; the forward (``matmul_wgmma_kernel``) a block a 128 x
    128 tile, the backward's products (``matmul_bwd_kernel``) a persistent
    block an SM walking 128 x 256 tiles in ``bwd_walk``'s grouped order;
  * ``"tf32x3"``: f32, the forward, M > 8, M N K at least
    ``TF32_MIN_WORK``, K > 0, K and N multiples of 4 (16-byte rows, as TMA
    needs) and 16-byte aligned operands: the f32
    product on the tensor cores (``matmul_tf32_kernel``), each product of
    two f32 operands taken as three TF32 products of their halves (hi =
    TF32(x) rounded as ``cvt.rna``, lo = x - hi read as TF32: lo hi + hi lo
    + hi hi, ``csrc/tf32.cuh``), each 32-deep K stage's twelve products in
    a fresh fragment added to the running f32 sum, within
    ``MATMUL_TOL[f32]`` where one TF32 product is far past it; a prologue
    in the same call (``matmul_tf32_split_kernel``) splits A once into a
    workspace (``tf32_work_elems``), then a block a 128 x 128 tile of C,
    computed as C^T = B^T A^T (TF32 wgmma reads a shared-memory operand
    only K-major, and B (K, N) is not), B split in registers; no split-K;
  * ``"simt"``: everything else: f32 where tf32x3 does not take it (M <= 8,
    whose weight streaming is bound by bytes; a product under
    ``TF32_MIN_WORK``, where the launches' host cost decides; K or N not a
    multiple of 4;
    unaligned views; K = 0; the backward's products), and bf16 with K or N
    not a multiple of 8, K = 0, or an operand whose address is not 16-byte
    aligned (``aligned`` False; only a view can be).  CUDA-core FMAs, as the
    first port had them.

Where autograd records the call, the wrapper is :class:`Matmul`, whose
backward makes the two products of the gradient with the backward's wgmma
kernel or simt, on the operands as they lie (no transposed copy): dA = dC B^T reads the
weight B (K, N) as B^T, a K-major operand, and dB = A^T dC reads the
activations A (M, K) as A^T, an MN-major one (``grad_a``, ``grad_b``:
trans 1 and 2 of the same entry point, wgmma or simt, as ``variant``
picks; each product is one launch, counted in ``LAUNCHES["matmul_bwd"]``).
The TPU kernel has no backward: the reference trains by ``jax.grad`` of
``x @ w``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, hopper, ref
from .autotune import tuned_config
from .launches import LAUNCHES, plain, wants_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"simt": 0, "decode": 1, "wgmma": 2, "tf32x3": 3}
_FN = None

#: the decode kernel's column tile and K step (csrc ``dec::BN``, ``dec::BK``)
DECODE_BN = 128
DECODE_BK = 32
#: the longest K slice a decode block takes (csrc ``dec::SLICE_MAX``): A's
#: rows of it sit in shared memory
DECODE_SLICE_MAX = 1024
#: the blocks a decode launch aims at: 4 on each of an H100's 132 SMs, as
#: many as the shared memory of a 1024-long slice lets reside at once
DECODE_TARGET_BLOCKS = hopper.SMS * 4
#: the most slices a plan cuts K into where the longest slice allows: the
#: last block of a column tile sums that many partials one after another
DECODE_MAX_SPLITS = 16
#: the wgmma kernel's output tile and K step (csrc ``wg::BM``, ``wg::BN``,
#: ``wg::BK``)
WGMMA_BM, WGMMA_BN, WGMMA_BK = 128, 128, 64
#: the backward's persistent wgmma kernel: its output tile (csrc ``pw::BM``,
#: ``pw::BN``; the K step is ``WGMMA_BK``) and the M-tiles of a group of
#: its walk (``pw::GROUP_M``)
BWD_BM, BWD_BN = 128, 256
BWD_GROUP_M = 16
#: the wgmma plan: tiles times slices within one wave (one block on each of
#: an H100's 132 SMs), at most 4 slices of at least 16 K steps, and of
#: those the count that minimises a block's time as measured on the H100:
#: ~0.4 us a 64-deep K step, and ~5 us for each slice past the first (its
#: partial out and the last block's sum)
WGMMA_SMS = hopper.SMS
WGMMA_MAX_SPLITS = 4
WGMMA_MIN_STEPS = 16
WGMMA_STEP_US = 0.4
WGMMA_SPLIT_US = 5.0
#: each variant's block: the decode kernel's threads and cp.async stages
#: (csrc ``dec::THREADS``, ``dec::STAGES``; ``dec::smem_bytes`` holds 8 rows
#: of A's slice beside them), the wgmma kernels' threads and shared memory
#: (``wg::THREADS``, ``wg::SMEM``: four stages of A and B tiles, barriers,
#: alignment; ``pw::``'s add the epilogue's four 8 KB boxes), and simt's
#: tiles (``dispatch_simt``: (BM, BN, BK) for M <= 8 and above, f32
#: ``__shared__`` arrays of BK x (BM + 1) and BK x BN, 256 threads)
DECODE_THREADS, DECODE_STAGES = 128, 4
WGMMA_THREADS = 384
WGMMA_SMEM = 4 * (WGMMA_BM + WGMMA_BN) * WGMMA_BK * 2 + 2 * 4 * 8 + 1024
BWD_THREADS = 288
BWD_SMEM = 4 * (BWD_BM + BWD_BN) * WGMMA_BK * 2 + 4 * 64 * 64 * 2 + 2 * 4 * 8 + 1024
SIMT_TILES = {True: (8, 32, 128), False: (64, 64, 16)}
SIMT_THREADS = 256
#: the tf32x3 kernel's output tile (csrc ``t3::BM``, ``t3::BN``), its K
#: stage and ring (``t3::BK``, ``t3::STAGES``), threads (``t3::THREADS``:
#: two consumer warpgroups and a producer one) and shared memory
#: (``t3::SMEM``: a stage holds A's hi and lo tiles and B's, all f32; two
#: barriers a stage, alignment); K and N multiples of ``TF32_ALIGN``
TF32_BM, TF32_BN, TF32_BK = 128, 128, 32
TF32_STAGES = 4
TF32_THREADS = 384
TF32_SMEM = TF32_STAGES * (2 * TF32_BM + TF32_BN) * TF32_BK * 4 + 2 * TF32_STAGES * 8 + 1024
TF32_ALIGN = 4
#: the least M N K that tf32x3 takes.  Between CUDA events over back-to-back
#: calls on an H100 80GB HBM3 at 700 W (``chip_smoke.py --only f32``,
#: ``F32_SWEEP``), simt was the faster at 17 of the 20 f32 smoke products
#: (M 9-128, K and N 32-512, M N K 1.8e4-4.2e6: both ~5 us on the card, and
#: tf32x3's two launches and three tensor-map encodes ~5-10 us more of the
#: host's time a call) and at kern/matmul_256 (1.7e7: 0.0239 ms against
#: 0.0322), tf32x3 at every llama3-8b projection from M = 16 (6.7e7 and
#: up: 1.9-5.2x); 2^25 lies between the two checked shapes
TF32_MIN_WORK = 1 << 25
#: the workspace for each (device, stream), shared by the decode and wgmma
#: kernels' split-K and tf32x3's prologue: one ticket an output tile, zeroed
#: when made and left at zero by every launch, and f32 room for the K
#: slices' partials or A's hi and lo; grown when a call needs more.
#: Launches on one stream run in order, so they share it.
_WORK: dict = {}


def variant(M: int, K: int, N: int, dtype: torch.dtype, aligned: bool = True,
            trans: int = 0) -> str:
    """The kernel a call takes: ``"decode"``, ``"wgmma"``, ``"tf32x3"`` or
    ``"simt"``.  C is (M, N) and K the contraction of the product ``trans``
    names: 0 the forward A B, 1 the backward's A B^T, 2 its A^T B.  Only the
    forward has the decode and tf32x3 forms, and A^T B takes wgmma only
    where M, A^T's row, is a multiple of 8 too."""
    if dtype == torch.float32:
        tensor_cores = (trans == 0 and M > 8 and M * N * K >= TF32_MIN_WORK
                        and K % TF32_ALIGN == 0 and N % TF32_ALIGN == 0 and aligned)
        return "tf32x3" if tensor_cores else "simt"
    if (dtype != torch.bfloat16 or K <= 0 or K % 8 or N % 8 or not aligned
            or (trans == 2 and M % 8)):
        return "simt"
    return "decode" if trans == 0 and M <= 8 else "wgmma"


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


def wgmma_tile(trans: int = 0) -> tuple[int, int]:
    """The wgmma kernels' output tile (rows, columns) for product ``trans``:
    the forward's 128 x 128, the backward's 128 x 256."""
    return (WGMMA_BM, WGMMA_BN) if trans == 0 else (BWD_BM, BWD_BN)


@functools.lru_cache(maxsize=1024)
def wgmma_plan(M: int, K: int, N: int, trans: int = 0) -> tuple[int, int]:
    """``(splits, slice)`` of the wgmma kernels: one slice where the output
    tiles (``wgmma_tile(trans)``) fill the card; where they are few (prefill
    chunks, short prompts, narrow projections), K is cut into the count of
    slices that minimises ``WGMMA_STEP_US`` a K step (scaled by the tile's
    width) plus ``WGMMA_SPLIT_US`` a further slice, among those that keep
    tiles times slices within ``WGMMA_SMS``, at most ``WGMMA_MAX_SPLITS``,
    each of at least ``WGMMA_MIN_STEPS``.  Both costs were measured with
    the forward's 128 x 128 tile; the backward's 128 x 256 step cost is that
    one scaled by the width, unmeasured, and the split counts it picks were
    checked for their results, not timed against the other counts."""
    bm, bn = wgmma_tile(trans)
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    k_steps = max(1, math.ceil(K / WGMMA_BK))
    most = max(1, min(WGMMA_SMS // tiles, k_steps // WGMMA_MIN_STEPS,
                      WGMMA_MAX_SPLITS))
    step_us = WGMMA_STEP_US * bn / WGMMA_BN
    splits = min(range(1, most + 1), key=lambda n: math.ceil(k_steps / n)
                 * step_us + (n - 1) * WGMMA_SPLIT_US)
    per = math.ceil(k_steps / splits)
    return math.ceil(k_steps / per), per * WGMMA_BK


def bwd_walk(M: int, N: int) -> list[tuple[int, int]]:
    """The output tiles of the backward's wgmma kernel (C (M, N)) in the
    order its persistent blocks take them, as ``(m0, n0)``: groups of
    ``BWD_GROUP_M`` M-tiles by every N-tile, M fastest within a group (the
    last group as many M-tiles as are left).  Block b of a grid of G takes
    tiles b, b + G, b + 2G, ...; so the tiles in flight at once are a run of
    the list.  csrc ``unit_at`` is its twin."""
    tm, tn = math.ceil(M / BWD_BM), math.ceil(N / BWD_BN)
    group = BWD_GROUP_M * tn
    out = []
    for t in range(tm * tn):
        first = t // group * BWD_GROUP_M
        rows = min(tm - first, BWD_GROUP_M)
        i = t % group
        out.append(((first + i % rows) * BWD_BM, i // rows * BWD_BN))
    return out


def plan(kind: str, M: int, K: int, N: int, trans: int = 0) -> tuple[int, int, int]:
    """``(splits, slice, tickets)`` of a launch: the split count of the
    ambient autotune table where it has this signature
    (``autotune.tuned_config``: ``(M, K, N)`` for the forward, ``(M, K, N,
    trans)`` for the backward's products; never outside ``tuned()``), else
    :func:`default_plan`'s."""
    if kind in ("decode", "wgmma"):      # the autotuner's family is bf16 only
        cfg = tuned_config("matmul", (M, K, N) if trans == 0 else (M, K, N, trans),
                           "bfloat16")
        if cfg is not None:
            return plan_with_splits(kind, M, K, N, trans, cfg["splits"])
    return default_plan(kind, M, K, N, trans)


def default_plan(kind: str, M: int, K: int, N: int, trans: int = 0
                 ) -> tuple[int, int, int]:
    """``(splits, slice, tickets)`` by the variant's own rule
    (:func:`split_plan`, :func:`wgmma_plan`) and the tickets its workspace
    needs (one an output tile; 0 unsplit)."""
    if kind == "decode":
        splits, slice_len = split_plan(K, N)
        tiles = math.ceil(N / DECODE_BN)
    elif kind == "wgmma":
        splits, slice_len = wgmma_plan(M, K, N, trans)
        bm, bn = wgmma_tile(trans)
        tiles = math.ceil(M / bm) * math.ceil(N / bn)
    else:
        return 1, 0, 0
    return splits, slice_len, tiles if splits > 1 else 0


def _slices(units: int, n: int, unit: int) -> tuple[int, int]:
    """``(splits, slice)`` of K cut into ``n`` equal slices of whole
    ``unit``s (the last ragged, none empty)."""
    per = math.ceil(units / max(1, n))
    return math.ceil(units / per), per * unit


@functools.lru_cache(maxsize=1024)
def legal_splits(kind: str, M: int, K: int, N: int, trans: int = 0) -> tuple[int, ...]:
    """The split counts a launch of ``kind`` may take (each as the slices
    it really makes): decode, every count whose longest slice is at most
    ``DECODE_SLICE_MAX``, up to ``DECODE_MAX_SPLITS`` (and the rule's own);
    wgmma, those that keep tiles times slices within one wave of
    ``WGMMA_SMS``, at most ``WGMMA_MAX_SPLITS`` of at least
    ``WGMMA_MIN_STEPS`` K steps; simt and tf32x3, one."""
    if kind == "decode":
        units, unit, lo = (max(1, math.ceil(K / DECODE_BK)), DECODE_BK,
                           math.ceil(K / DECODE_SLICE_MAX))
        hi = min(units, DECODE_MAX_SPLITS)
    elif kind == "wgmma":
        bm, bn = wgmma_tile(trans)
        tiles = math.ceil(M / bm) * math.ceil(N / bn)
        units, unit, lo = max(1, math.ceil(K / WGMMA_BK)), WGMMA_BK, 1
        hi = max(1, min(WGMMA_SMS // tiles, units // WGMMA_MIN_STEPS,
                        WGMMA_MAX_SPLITS))
    else:
        return (1,)
    out = {_slices(units, n, unit)[0] for n in range(max(1, lo), max(lo, hi) + 1)}
    out.add(default_plan(kind, M, K, N, trans)[0])
    return tuple(sorted(out))


def plan_with_splits(kind: str, M: int, K: int, N: int, trans: int,
                     n: int) -> tuple[int, int, int]:
    """``(splits, slice, tickets)`` of a launch that cuts K into ``n``
    slices; raises where ``n`` is not one of :func:`legal_splits`."""
    if n not in legal_splits(kind, M, K, N, trans):
        raise ValueError(f"matmul ({kind}, trans {trans}) at M={M} K={K} N={N}: "
                         f"{n} splits is not a legal plan "
                         f"{legal_splits(kind, M, K, N, trans)}")
    if kind in ("simt", "tf32x3"):
        return 1, 0, 0
    if kind == "decode":
        splits, slice_len = _slices(math.ceil(K / DECODE_BK), n, DECODE_BK)
        tiles = math.ceil(N / DECODE_BN)
    else:
        splits, slice_len = _slices(math.ceil(K / WGMMA_BK), n, WGMMA_BK)
        bm, bn = wgmma_tile(trans)
        tiles = math.ceil(M / bm) * math.ceil(N / bn)
    return splits, slice_len, tiles if splits > 1 else 0


def block_resources(kind: str, M: int, K: int, N: int, trans: int = 0,
                    splits: int = 1) -> dict:
    """What one block of a launch of ``kind`` cutting K into ``splits``
    slices holds: shared memory in bytes (``static`` where it is a
    ``__shared__`` array), threads, and the launch's blocks."""
    if kind == "decode":
        _, slice_len = _slices(max(1, math.ceil(K / DECODE_BK)), splits, DECODE_BK)
        smem = (DECODE_STAGES * DECODE_BK * (DECODE_BN + 8) * 2
                + 8 * (slice_len + 8) * 2)
        return {"smem": smem, "threads": DECODE_THREADS, "static": False,
                "blocks": math.ceil(N / DECODE_BN) * splits}
    if kind == "wgmma":
        bm, bn = wgmma_tile(trans)
        smem, threads = ((WGMMA_SMEM, WGMMA_THREADS) if trans == 0
                         else (BWD_SMEM, BWD_THREADS))
        return {"smem": smem, "threads": threads, "static": False,
                "blocks": math.ceil(M / bm) * math.ceil(N / bn) * splits}
    if kind == "tf32x3":
        return {"smem": TF32_SMEM, "threads": TF32_THREADS, "static": False,
                "blocks": math.ceil(M / TF32_BM) * math.ceil(N / TF32_BN)}
    bm, bn, bk = SIMT_TILES[M <= 8]
    return {"smem": bk * (bm + 1 + bn) * 4, "threads": SIMT_THREADS, "static": True,
            "blocks": math.ceil(M / bm) * math.ceil(N / bn)}


def tf32_work_elems(M: int, K: int) -> int:
    """f32 elements of the tf32x3 prologue's workspace: A's hi and lo, each
    (M, Kp), Kp = K rounded up to 8."""
    return 2 * M * (-(-K // 8) * 8)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("matmul").repro_matmul
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _workspace(device, stream: int, tiles: int, floats: int):
    """The (tickets, partials) pointers of a launch on ``stream``."""
    key = (device, stream)
    work = _WORK.get(key)
    if work is None or work[0].numel() < tiles or work[1].numel() < floats:
        old = (0, 0) if work is None else (work[0].numel(), work[1].numel())
        work = (torch.zeros(max(tiles, old[0]), dtype=torch.int32, device=device),
                torch.empty(max(floats, old[1]), dtype=torch.float32, device=device))
        _WORK[key] = work
    return work[0].data_ptr(), work[1].data_ptr()


def _call(a, b, c, M: int, K: int, N: int, trans: int, kind: str, idx: int) -> int:
    """One launch of ``kind`` on the current stream of device ``idx`` (the
    current device); returns the CUDA error code."""
    # the raw handle of the current stream, without a Stream object
    stream = torch._C._cuda_getCurrentRawStream(idx)
    splits, slice_len, tiles = plan(kind, M, K, N, trans)
    # a split's partials, or tf32x3's A hi and lo from its prologue
    floats = tf32_work_elems(M, K) if kind == "tf32x3" else splits * M * N
    tickets, partials = (_workspace(a.device, stream, tiles, floats)
                         if tiles or kind == "tf32x3" else (0, 0))
    return _fn()(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, trans,
                 _DTYPES[a.dtype], VARIANTS[kind], splits, slice_len, tickets,
                 partials, stream)


def _dims(a: torch.Tensor, b: torch.Tensor, trans: int = 0) -> tuple[int, int, int]:
    """``(M, K, N)`` of the product ``trans`` names: 0, ``a (M, K) @ b (K,
    N)``; 1, ``a (M, K) @ b.T`` with b (N, K); 2, ``a.T @ b`` with a (K, M)
    and b (K, N).  Raises on what the kernels do not take (a CPU tensor,
    another dtype, a non-contiguous operand)."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"matmul kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"matmul kernel takes f32 or bf16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"matmul kernel needs 2-d operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    M, K = reversed(a.shape) if trans == 2 else a.shape
    Kb, N = reversed(b.shape) if trans == 1 else b.shape
    if K != Kb:
        raise ValueError(f"matmul kernel (trans {trans}): shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)} disagree")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel needs contiguous operands")
    if max(M, K, N) >= 2 ** 31:
        raise ValueError(f"matmul kernel dims must fit int32, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return M, K, N


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on what it does not
    take (a CPU tensor, another dtype, a non-contiguous operand).  Where
    autograd records the call, it goes through :class:`Matmul`."""
    dims = _dims(a, b)
    if wants_grad(a, b):
        return Matmul.apply(a, b)
    return _launch(a, b, 0, dims)


def _launch(a: torch.Tensor, b: torch.Tensor, trans: int,
            dims: tuple[int, int, int]) -> torch.Tensor:
    """The product ``trans`` names (see :func:`_dims`, which gave ``dims``)
    on the current stream: one launch, counted in ``LAUNCHES["matmul"]``
    for the forward and ``LAUNCHES["matmul_bwd"]`` for the backward's."""
    M, K, N = dims
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:                # nothing to write: no launch
        return c
    kind = variant(M, K, N, a.dtype, (a.data_ptr() | b.data_ptr()) % 16 == 0,
                   trans)
    # the device guard only where the operands are not on the current
    # device: on the decode path the host's time a call is what a step pays
    idx = a.device.index
    if idx == torch.cuda.current_device():
        err = _call(a, b, c, M, K, N, trans, kind, idx)
    else:
        with torch.cuda.device(idx):
            err = _call(a, b, c, M, K, N, trans, kind, idx)
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"matmul kernel ({kind}, trans {trans}): CUDA "
                           f"error {err} at launch")
    LAUNCHES["matmul" if trans == 0 else "matmul_bwd"] += 1
    return c


def grad_a(dc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dA = dC B^T of ``c = a @ b``: dc (M, N), b (K, N) -> (M, K)."""
    return _launch(dc, b, 1, _dims(dc, b, 1))


def grad_b(a: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """dB = A^T dC of ``c = a @ b``: a (M, K), dc (M, N) -> (K, N)."""
    return _launch(a, dc, 2, _dims(a, dc, 2))


class Matmul(torch.autograd.Function):
    """``a @ b`` with its backward: the kernels for CUDA tensors (checked by
    :func:`matmul`), the plain versions ``ref.matmul``, ``ref.matmul_grad_a``
    and ``ref.matmul_grad_b`` for CPU tensors (``ops.matmul``'s CPU path).
    Only the products autograd asks for are made."""

    @staticmethod
    def forward(ctx, a, b):
        c = (ref.matmul(a, b) if plain(a)
             else _launch(a, b, 0, _dims(a, b)))
        ctx.save_for_backward(a, b)
        return c

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        cpu = plain(a)
        if not cpu:
            dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = ref.matmul_grad_a(dc, b) if cpu else grad_a(dc, b)
        if ctx.needs_input_grad[1]:
            db = ref.matmul_grad_b(a, dc) if cpu else grad_b(a, dc)
        return da, db
