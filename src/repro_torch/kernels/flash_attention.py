"""The CUDA flash-attention kernel's wrapper: causal / sliding-window GQA
attention, forward only.

Counterpart of ``repro.kernels.flash_attention.flash_attention``; the kernel
and its design notes are in ``csrc/flash_attention.cu``.  Shapes are the JAX
kernel's: q (B, Hq, S, D), k/v (B, Hkv, Sk, D) -> (B, Hq, S, D) in q's
dtype.  Every operand is taken through its strides, so the model passes its
(B, S, H, D) activations as ``transpose(1, 2)`` views; the result is a
(B, Hq, S, D) view of a (B, S, Hq, D) tensor, which the model transposes
back without a copy.  There is no backward yet: a call that autograd would
have to differentiate raises, as the TPU kernel has no VJP either.  Each
call is exactly one launch, and the same inputs give the same bits.

Which of the two kernels a call takes is ``variant(S, Sk, D, dtype,
aligned)``, a pure function of the shapes and the dtype:
  * ``"wgmma"``: bf16, D in ``WGMMA_HEAD_DIMS`` (64, 128), Sk > 0, every
    operand 16-byte aligned: a 64-row q tile a block, TMA-fed 64-key K/V
    tiles, Q K^T and P V on the tensor cores (the serving path's prefills);
  * ``"simt"``: everything else: f32, the head dims 16 and 32, Sk = 0.
    CUDA-core FMAs, as the first port had them.
The wgmma kernel walks the key tiles ``tile_plan`` gives; the simt kernel
takes the same walk in 32-key tiles.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .launches import LAUNCHES, refuse_autograd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
VARIANTS = {"simt": 0, "wgmma": 1}
#: the head dims the wgmma kernel takes, and its q rows a block and keys a
#: tile (csrc ``fw::BQ``, ``fw::BK``)
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_BQ, WGMMA_BK = 64, 64
_FN = None


def variant(S: int, Sk: int, D: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The kernel a call takes: ``"wgmma"`` or ``"simt"``."""
    if dtype != torch.bfloat16 or D not in WGMMA_HEAD_DIMS or Sk <= 0 or not aligned:
        return "simt"
    return "wgmma"


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


def _fn():
    global _FN
    if _FN is None:
        fn = _build.library("flash_attention").repro_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """Launch the kernel on the current stream; raises on what it does not
    take."""
    ts = (q, k, v)
    refuse_autograd("flash_attention", *ts)
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
    epc = 16 // q.element_size()        # elements of one 16-byte load
    if any(t.stride(3) != 1 or any(s % epc for s in t.stride()[:3])
           or t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention kernel needs 16-byte aligned q, k, v "
                         "with a contiguous last dim and strides a multiple of "
                         "16 bytes")
    if max(B * Hq, S, Sk) >= 2 ** 31:
        raise ValueError("flash_attention kernel dims must fit int32")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:                # nothing to write: no launch
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    kind = variant(S, Sk, D, q.dtype)   # aligned: checked above
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, S, Sk, D, int(causal), window or 0, ctypes.addressof(strides),
            _DTYPES[q.dtype], VARIANTS[kind])
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
    return out
