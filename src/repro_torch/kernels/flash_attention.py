"""The CUDA flash-attention kernels' wrapper: causal / sliding-window GQA
attention, forward and backward.

Counterpart of ``repro.kernels.flash_attention.flash_attention``; the kernel
and its design notes are in ``csrc/flash_attention.cu``.  Shapes are the JAX
kernel's: q (B, Hq, S, D), k/v (B, Hkv, Sk, D) -> (B, Hq, S, D) in q's
dtype.  Every operand is taken through its strides, so the model passes its
(B, S, H, D) activations as ``transpose(1, 2)`` views; the result is a
(B, Hq, S, D) view of a (B, S, Hq, D) tensor, which the model transposes
back without a copy.  Each call is exactly one launch, and the same inputs
give the same bits.

Where autograd records the call, the wrapper is :class:`FlashAttention`,
whose backward is ``csrc/flash_attention_bwd.cu`` (:func:`backward`: dq,
dk, dv from q, k, v and the output's gradient, each in the (B, S, H, D)
layout of the model's activations, read back as (B, H, S, D) views; one
call, two grids -- dq, then dk and dv; counted in
``LAUNCHES["flash_attention_bwd"]``).  The TPU kernel has no VJP: the
reference trains through jnp attention under ``jax.grad``.
``bwd_variant`` picks the backward's kernels:
  * ``"stats"``: bf16, D in ``WGMMA_HEAD_DIMS``, aligned, Sk >=
    ``STATS_MIN_SK`` (cross-attention over llama-3.2-vision's 6,404 image
    tokens): the wgmma forward under autograd keeps each row's
    log-sum-exp L and its f32 output (:class:`Stats`); a prologue of the
    backward's call takes Dd = rowsum(dO o) from them, so the dq grid walks
    the keys once, and both grids run in kv-head order
    (``bwd_block_order``, ``bwd_dkv_order``);
  * ``"wgmma"``: the other bf16 calls the wgmma forward takes; the dq
    grid's first pass recomputes each row's statistics, so the forward
    keeps nothing but q, k and v;
  * ``"tf32x3"``: f32 by the forward's rule: the wgmma pair's split and
    order (a dq grid whose first pass writes L and Dd, then a dkv grid) on
    ``mma.sync`` m16n8k8 TF32 products, each operand split into two TF32
    halves and each product taken as three (lo hi + hi lo + hi hi);
  * ``"simt"``: CUDA-core f32, by the forward's rule.
The bf16 tensor-core kernels run every product on the tensor cores, P and
dS as two bf16 halves; their dq grids walk ``tile_plan``'s key tiles,
their dkv grids ``bwd_q_plan``'s q tiles (tf32x3: in tiles of 32 and 16).

Which of the three forward kernels a call takes is ``variant(S, Sk, D,
dtype, aligned)``, a pure function of the shapes and the dtype:
  * ``"wgmma"``: bf16, D in ``WGMMA_HEAD_DIMS`` (64, 96, 128), Sk > 0,
    every operand 16-byte aligned: a 64-row q tile a block, TMA-fed 64-key
    K/V tiles, Q K^T and P V on the tensor cores (the serving path's
    prefills, llama3-8b's and phi3-mini's); a row of D = 96 is loaded as
    two 64-column boxes whose last 32 columns are zeros (``box_plan``);
  * ``"tf32x3"``: f32 on the same rule (D in ``WGMMA_HEAD_DIMS``, Sk > 0,
    aligned): Q K^T and P V by TF32 wgmma, each operand split into hi =
    TF32(x) and lo = x - hi (read as TF32) and each product taken as three
    (lo hi + hi lo + hi hi, ``csrc/flash_wgmma.cuh``), within
    ``ATTN_TOL[f32]`` where one TF32 product is ~60x past it; a prologue
    in the same call splits K and V once into the ring's stage images (K
    hi/lo, V^T hi/lo, ``tf32_work_elems``), and the kernel walks 32-key
    tiles;
  * ``"simt"``: everything else: f32 and bf16 at the head dims 16 and 32,
    unaligned views, Sk = 0.  CUDA-core FMAs, as the first port had them.
The wgmma kernel walks the key tiles ``tile_plan`` gives; the simt and
tf32x3 kernels take the same walk in 32-key tiles.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build, ref
from .autotune import tuned_config
from .launches import LAUNCHES, plain, wants_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128)
VARIANTS = {"simt": 0, "wgmma": 1, "tf32x3": 2}
BWD_VARIANTS = {"simt": 0, "wgmma": 1, "stats": 2, "tf32x3": 3}
#: the head dims the wgmma kernels take (each carves a row into 64-column
#: boxes of 128 bytes; D = 96 into two, the second zero-filled past column
#: 96: ``box_plan``), and their q rows a block and keys a tile (csrc
#: ``fw::BQ``, ``fw::BK``)
WGMMA_HEAD_DIMS = (64, 96, 128)
WGMMA_BQ, WGMMA_BK = 64, 64
#: each forward's block: wgmma's threads, ring stages and fixed shared
#: memory (csrc ``fw::THREADS``, ``fw::STAGES``; ``fw::Smem<D>``: Q's tile,
#: each stage's K and V tiles of 64-column boxes, the barriers and 1 KB of
#: alignment), simt's threads and tiles (``NT``, ``BQ``, ``BK``: Q, K, V
#: and P in f32, Q's, K's and P's rows padded by one)
WGMMA_THREADS, WGMMA_STAGES = 160, 2
SIMT_THREADS, SIMT_BQ, SIMT_BK = 128, 64, 32
#: the tf32x3 forward's block (csrc ``t3::``): a consumer warpgroup and a
#: producer warp, a 64-row q tile split into hi and lo in shared memory,
#: a ring of 2 stages of 32 keys (K hi, K lo, V^T hi, V^T lo)
TF32_THREADS, TF32_STAGES, TF32_BK = 160, 2, 32
#: the fewest keys at which ``bwd_variant`` takes ``stats``: on the card
#: (``testing/flash_ab.py``) it beats ``wgmma`` at llama-3.2-vision's 6,404
#: keys and at the training shapes' 1,024 and loses at seamless's 256;
#: 2,048 leaves the training shapes on ``wgmma``, whose forward keeps
#: nothing for them
STATS_MIN_SK = 2048
_FN = None
_BWD = None


def variant(S: int, Sk: int, D: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The kernel a call takes: ``"wgmma"`` (bf16), ``"tf32x3"`` (f32) or
    ``"simt"``."""
    if D not in WGMMA_HEAD_DIMS or Sk <= 0 or not aligned:
        return "simt"
    return {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}.get(dtype, "simt")


def legal_variants(S: int, Sk: int, D: int, dtype: torch.dtype) -> tuple[str, ...]:
    """The forward kernels that take a call: ``simt`` takes every one,
    ``wgmma`` and ``tf32x3`` those :func:`variant` gives them."""
    kind = variant(S, Sk, D, dtype)
    return ("simt",) if kind == "simt" else ("simt", kind)


def block_resources(kind: str, B: int, Hq: int, S: int, D: int) -> dict:
    """What one block of the forward ``kind`` holds: dynamic shared memory
    in bytes, threads, and the launch's blocks (one a 64-row q tile of each
    (sequence, head))."""
    blocks = B * Hq * math.ceil(S / WGMMA_BQ)
    if kind == "wgmma":
        tile = math.ceil(D / 64) * 64 * WGMMA_BK * 2
        return {"smem": tile + WGMMA_STAGES * 2 * tile + (2 * WGMMA_STAGES + 1) * 8 + 1024,
                "threads": WGMMA_THREADS, "static": False, "blocks": blocks}
    if kind == "tf32x3":
        # Q hi and lo, then each stage's K hi, K lo, V^T hi and V^T lo
        q_tile, k_tile = WGMMA_BQ * D * 4, TF32_BK * D * 4
        return {"smem": 2 * q_tile + TF32_STAGES * 4 * k_tile + 2 * TF32_STAGES * 8 + 1024,
                "threads": TF32_THREADS, "static": False, "blocks": blocks}
    smem = 4 * (SIMT_BQ * (D + 1) + SIMT_BK * (D + 1) + SIMT_BK * D + SIMT_BQ * (SIMT_BK + 1))
    return {"smem": smem, "threads": SIMT_THREADS, "static": False, "blocks": blocks}


def tf32_work_elems(B: int, Hkv: int, Sk: int, D: int) -> int:
    """f32 elements of the tf32x3 forward's workspace: one ring stage (K hi,
    K lo, V^T hi, V^T lo, 4 x 32 x D) a (b, kv head, 32-key tile)."""
    return B * Hkv * math.ceil(Sk / TF32_BK) * 4 * TF32_BK * D


def tuned_variant(B: int, Hq: int, Hkv: int, S: int, Sk: int, D: int,
                  dtype: torch.dtype) -> str:
    """The forward's kernel: the ambient autotune table's ``variant`` for
    ``(B, Hq, Hkv, S, Sk, D)`` where it has one (one of
    :func:`legal_variants`), else :func:`variant`'s (always outside
    ``autotune.tuned()``)."""
    cfg = tuned_config("flash_attention", (B, Hq, Hkv, S, Sk, D), dtype)
    return variant(S, Sk, D, dtype) if cfg is None else cfg["variant"]


def bwd_variant(S: int, Sk: int, D: int, dtype: torch.dtype,
                aligned: bool = True) -> str:
    """The backward's kernels for a call: ``"stats"`` (the wgmma
    forward's rule and Sk >= ``STATS_MIN_SK``), ``"wgmma"``, ``"tf32x3"``
    or ``"simt"`` (the forward's rule, :func:`variant`)."""
    kind = variant(S, Sk, D, dtype, aligned)
    return "stats" if kind == "wgmma" and Sk >= STATS_MIN_SK else kind


class BoxPlan(NamedTuple):
    """How the wgmma kernels hold a row of D columns (``box_plan``)."""
    boxes: tuple[tuple[int, int], ...]  # (first column, columns of data) a box
    cols: int                           # columns the boxes hold, N of a P V product
    qk_steps: int                       # k16 steps of a Q K^T-form product
    store_cols: int                     # columns of a row written back
    scale: float                        # the scores' scale, 1 / sqrt(D)


def box_plan(D: int) -> BoxPlan:
    """The wgmma kernels' row layout at head dim D, as
    ``csrc/flash_wgmma.cuh`` carves it (``ROW_BOXES<D>``, ``ROW_COLS<D>``):
    64-column boxes of 128 bytes, each loaded by TMA from its first column,
    which fills the columns past D with zeros (D = 96: two boxes, 32 zero
    columns); the K-side products run over the D / 16 steps that hold data,
    the N-side ones over every column the boxes hold; only D columns are
    stored; the scale is the real D's."""
    if D not in WGMMA_HEAD_DIMS:
        raise ValueError(f"the wgmma kernels take head dims {WGMMA_HEAD_DIMS}, "
                         f"got {D}")
    n = -(-D // 64)
    return BoxPlan(boxes=tuple((64 * x, min(64, D - 64 * x)) for x in range(n)),
                   cols=64 * n, qk_steps=D // 16, store_cols=D,
                   scale=1.0 / math.sqrt(D))


def tile_plan(q0: int, Sk: int, causal: bool, window: int | None,
              bq: int = WGMMA_BQ, bk: int = WGMMA_BK) -> list[tuple[int, bool]]:
    """The key tiles the block of q rows ``q0 .. q0 + bq - 1`` walks, as
    ``(k0, masked)``: from the lowest row's window edge, rounded down to a
    tile, to the highest row's causal limit (tiles that the masks hide
    entirely are never loaded); ``masked`` where a tile holds a key that
    some row of the block must not see (the diagonal, Sk's edge, the
    window's edge), the only tiles the kernel masks."""
    k_lo = max(0, q0 - window + 1) // bk * bk if window else 0
    k_hi = min(Sk, q0 + bq) if causal else Sk
    return [(k0, k0 + bk > Sk or (causal and k0 + bk - 1 > q0)
             or bool(window and k0 < q0 + bq - window))
            for k0 in range(k_lo, k_hi, bk)]


def bwd_q_plan(k0: int, S: int, causal: bool, window: int | None, *,
               Sk: int | None = None, bq: int = WGMMA_BQ, bk: int = WGMMA_BK
               ) -> list[tuple[int, bool]]:
    """The q tiles the backward's dkv block of keys ``k0 .. k0 + bk - 1``
    walks for each query head, as ``(q0, masked)``: from the diagonal
    (causal), or row 0, to the last row some key of the tile is in the
    window of; ``masked`` where the tile holds a (q row, key) pair the masks
    hide (the diagonal, S's or Sk's edge -- Sk defaults to S -- or the
    window's edge), the only tiles the kernel masks."""
    Sk = S if Sk is None else Sk
    q_lo = k0 // bq * bq if causal else 0
    q_hi = min(S, k0 + bk - 1 + window) if window else S
    return [(q0, q0 + bq > S or k0 + bk > Sk or (causal and k0 + bk - 1 > q0)
             or bool(window and k0 < q0 + bq - window))
            for q0 in range(q_lo, q_hi, bq)]


def bwd_block_order(B: int, Hq: int, Hkv: int, S: int) -> list[tuple[int, int, int]]:
    """The (b, q head, q0) of each ``stats`` dq block in launch order
    (csrc ``flash_bwd_dq_wgmma_kernel<true, D>``): the blocks of a (b, kv
    head) consecutive, its G q heads and 64-row q tiles fastest, the
    longest walks first within each head, so the K/V set they stream stays
    in L2."""
    G, T = Hq // Hkv, -(-S // WGMMA_BQ)
    out = []
    for x in range(B * Hq * T):
        bhk, inner = divmod(x, G * T)
        b, hk = divmod(bhk, Hkv)
        out.append((b, hk * G + inner // T, (T - 1 - inner % T) * WGMMA_BQ))
    return out


def bwd_dkv_order(B: int, Hkv: int, Sk: int, bk: int = WGMMA_BK
                  ) -> list[tuple[int, int, int]]:
    """The (b, kv head, k0) of each ``stats`` dkv block in launch order
    (csrc ``flash_bwd_dkv_wgmma_kernel<true, D>``): a kv head's key tiles
    consecutive, the first keys (causal: the heaviest) first, so the Q and
    dO of its G query heads stay in L2."""
    KT = -(-Sk // bk)
    return [(x // KT // Hkv, x // KT % Hkv, x % KT * bk) for x in range(B * Hkv * KT)]


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("flash_attention").repro_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_fn():
    global _BWD
    if _BWD is None:
        fn = _build.library("flash_attention_bwd").repro_flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _BWD = fn
    return _BWD


def _aligned(*ts: torch.Tensor) -> bool:
    """16-byte aligned rows with a contiguous last dim, as the kernels read
    them."""
    epc = 16 // ts[0].element_size()    # elements of one 16-byte load
    return not any(t.stride(3) != 1 or any(s % epc for s in t.stride()[:3])
                   or t.data_ptr() % 16 for t in ts)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    ts = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel needs q (B, Hq, S, D) and k/v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention kernel: shapes disagree: q "
                         f"{tuple(q.shape)}, k/v {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, "
                         f"got {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if not _aligned(*ts):
        raise ValueError("flash_attention kernel needs 16-byte aligned q, k, v "
                         "with a contiguous last dim and strides a multiple of "
                         "16 bytes")
    if max(B * Hq, S, Sk) >= 2 ** 31:
        raise ValueError("flash_attention kernel dims must fit int32")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on what it does not
    take.  Where autograd records the call, it goes through
    :class:`FlashAttention`."""
    _check(q, k, v, window)
    if wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


class Stats(NamedTuple):
    """What the wgmma forward keeps under autograd for the ``stats``
    backward: each row's L in log2 units (m sl2 + log2 l, +inf past S or
    with no visible key; f32 (B, Hq, Sp), rows padded to Sp = S rounded up
    to 64) and the output in f32 (B, Hq, S, D), from which the backward
    takes Dd = rowsum(dO o) exactly (from the bf16 output it misses
    ``ATTN_BWD_TOL``: ``tests/test_torch_flash_bwd.py``)."""
    lse: torch.Tensor
    o32: torch.Tensor


def stats_rows(S: int) -> int:
    """Sp: the rows of a ``Stats.lse`` row block, S rounded up to 64."""
    return -(-S // WGMMA_BQ) * WGMMA_BQ


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: int | None, stats: bool = False):
    """The forward, on inputs :func:`_check` has passed; with ``stats``
    (autograd's forward) ``(out, Stats or None)``: the statistics where the
    backward is ``stats`` (:func:`bwd_variant`), which reads them; the
    wgmma kernel writes them, whatever an autotune table says."""
    B, Hq, S, D = q.shape
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:                # nothing to write: no launch
        return (out, None) if stats else out
    st = None
    if stats and bwd_variant(S, k.shape[2], D, q.dtype) == "stats":
        st = Stats(torch.empty((B, Hq, stats_rows(S)), dtype=torch.float32, device=q.device),
                   torch.empty((B, Hq, S, D), dtype=torch.float32, device=q.device))
        _launch(q, k, v, out, causal, window, st, kind="wgmma")
    else:
        _launch(q, k, v, out, causal, window)
    return (out, st) if stats else out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            causal: bool, window: int | None, stats: Stats | None = None,
            kind: str | None = None) -> None:
    """The forward launch into ``out``, a (B, Hq, S, D) view with aligned
    rows (the tests' outputs with guard columns after each row too), by
    ``kind`` (default the autotune table's or the rule's); ``stats`` (a
    wgmma launch only) takes each row's L and the f32 output.  A tf32x3
    launch is the prologue and the kernel, one count in ``LAUNCHES``."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    if kind is None:
        kind = tuned_variant(B, Hq, Hkv, S, Sk, D, q.dtype)   # aligned: checked above
    # tf32x3: the prologue's split K and V, freed when the launch is queued
    # (the caching allocator keeps it for the stream's later work)
    work = (torch.empty(tf32_work_elems(B, Hkv, Sk, D), dtype=torch.float32, device=q.device)
            if kind == "tf32x3" else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, S, Sk, D, int(causal), window or 0, ctypes.addressof(strides),
            _DTYPES[q.dtype], VARIANTS[kind],
            stats.lse.data_ptr() if stats else None, stats.o32.data_ptr() if stats else None,
            work.data_ptr() if work is not None else None)
    # the device guard only where q is not on the current device, and the
    # raw handle of the current stream, without a Stream object: a prefill
    # makes 32 of these calls
    idx = q.device.index
    if idx == torch.cuda.current_device():
        err = _fn()(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = _fn()(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"flash_attention kernel ({kind}): CUDA error {err} "
                           f"at launch")
    LAUNCHES["flash_attention"] += 1


def backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor, *, causal: bool = True,
             window: int | None = None, stats: Stats | None = None):
    """dq, dk, dv of the forward on (q, k, v) for the output's gradient do
    (B, Hq, S, D), by one call of the backward kernels; q, k, v as
    :func:`flash_attention` takes them, do any strides.  A ``stats``
    backward reads ``stats``, the forward's (:class:`FlashAttention` passes
    them); a call without them runs that forward first, one more launch of
    ``flash_attention``."""
    _check(q, k, v, window)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention backward needs do like q, got "
                         f"{tuple(do.shape)} {do.dtype} for {tuple(q.shape)} "
                         f"{q.dtype}")
    if not _aligned(do):
        do = do.contiguous()
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    opts = dict(dtype=q.dtype, device=q.device)
    dq = torch.empty((B, S, Hq, D), **opts).transpose(1, 2)
    dk = torch.empty((B, Sk, Hkv, D), **opts).transpose(1, 2)
    dv = torch.empty((B, Sk, Hkv, D), **opts).transpose(1, 2)
    if S == 0 or Sk == 0 or B == 0:     # nothing seen: no launch
        return dq.zero_(), dk.zero_(), dv.zero_()
    _launch_bwd(q, k, v, do, dq, dk, dv, causal, window, stats)
    return dq, dk, dv


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, causal: bool,
                window: int | None, stats: Stats | None = None) -> None:
    """The backward's launch into dq, dk, dv, (B, H, S, D) views with
    aligned rows (the tests' outputs with guard columns after each row too),
    on inputs :func:`backward` has passed."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kind = bwd_variant(S, Sk, D, q.dtype)   # aligned: checked above
    if kind == "stats":
        if stats is None:
            _, stats = _forward(q, k, v, causal, window, stats=True)
        # the forward's L; Dd from its f32 output by the call's prologue
        lse, o32 = stats
        dd = torch.empty_like(lse)
    else:
        # each row's L and Dd, from the dq grid to the dkv grid; the wgmma
        # kernels' rows padded to whole 64-row tiles (one bulk copy a tile)
        rows = stats_rows(S) if kind == "wgmma" else S
        lse = torch.empty((B, Hq, rows), dtype=torch.float32, device=q.device)
        dd, o32 = torch.empty_like(lse), None
    ts = (q, k, v, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 21)(*[s for t in ts for s in t.stride()[:3]])
    args = (*[t.data_ptr() for t in ts], lse.data_ptr(), dd.data_ptr(), B, Hq,
            Hkv, S, Sk, D, int(causal), window or 0, ctypes.addressof(strides),
            _DTYPES[q.dtype], BWD_VARIANTS[kind], o32.data_ptr() if o32 is not None else None)
    # the forward's lean path: a device guard only off the current device
    idx = q.device.index
    if idx == torch.cuda.current_device():
        err = _bwd_fn()(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = _bwd_fn()(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:                        # the launch was refused; it never ran
        raise RuntimeError(f"flash_attention backward kernel ({kind}): CUDA "
                           f"error {err} at launch")
    LAUNCHES["flash_attention_bwd"] += 1


class FlashAttention(torch.autograd.Function):
    """Attention with its backward: the kernels for CUDA tensors (checked by
    :func:`flash_attention`), the plain versions ``ref.attention`` and
    ``ref.attention_bwd`` for CPU tensors (``ops.attention``'s CPU path).
    On the card, where the backward is ``stats`` (:func:`bwd_variant`), the
    forward is the wgmma kernel whatever an autotune table says and saves
    its :class:`Stats` beside q, k and v; the serving path (no autograd)
    writes none."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if plain(q):
            out, st = ref.attention(q, k, v, causal=causal, window=window), None
        else:
            out, st = _forward(q, k, v, causal, window, stats=True)
        ctx.save_for_backward(q, k, v, *(st if st is not None else (None, None)))
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse, o32 = ctx.saved_tensors
        if plain(q):
            dq, dk, dv = ref.attention_bwd(q, k, v, do, causal=ctx.causal, window=ctx.window)
        else:
            st = Stats(lse, o32) if lse is not None else None
            dq, dk, dv = backward(q, k, v, do, causal=ctx.causal, window=ctx.window, stats=st)
        return dq, dk, dv, None, None
