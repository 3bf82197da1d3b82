"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``'s
``matmul``, ``rmsnorm``, ``attention``, ``paged_attention`` and the paper's
Table I kernels ``jacobi2d``, ``fconv2d``, ``dotprod``, ``expv`` and
``softmax_rows``).  The CPU path runs them; on the card they are what each
kernel is held against."""
from __future__ import annotations

import math

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def expand_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """Repeat the kv heads of k (B, Hkv, T, D) up to H: kv0,kv0,kv1,kv1,...
    (``jnp.repeat``), so query head h reads kv head h // (H / Hkv)."""
    Hkv = k.shape[1]
    return k if Hkv == H else torch.repeat_interleave(k, H // Hkv, dim=1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, Sk, D) with GQA head grouping ->
    (B, Hq, S, D); rows with no visible key give zeros."""
    B, Hq, S, D = q.shape
    Sk = k.shape[2]
    kq = expand_kv(k, Hq).float()
    vq = expand_kv(v, Hq).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kq) / math.sqrt(D)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, vq)
    out = torch.where(mask.any(-1)[:, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
                    tables: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """q (B, Hkv, G, D), pools (Hkv, NB, bt, D), tables (B, nblk), lens (B,)
    -> (B, Hkv, G, D).  Gathers each sequence's dense view through its
    block table and masks positions >= lens; rows with no visible key give
    zeros."""
    B, Hkv, G, D = q.shape
    t = tables.long()
    k = kpool[:, t].transpose(0, 1).reshape(B, Hkv, -1, D).float()
    v = vpool[:, t].transpose(0, 1).reshape(B, Hkv, -1, D).float()
    s = torch.einsum("bhgd,bhtd->bhgt", q.float(), k) / math.sqrt(D)
    T = k.shape[2]
    visible = torch.arange(T, device=q.device)[None, :] < lens.long()[:, None]
    s = torch.where(visible[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v)
    out = torch.where(visible.any(-1)[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


# -- the paper's Table I kernels ------------------------------------------------

def jacobi2d(x: torch.Tensor) -> torch.Tensor:
    """One Jacobi sweep of an unpadded (H, W) grid with a zero boundary:
    ``0.25 * (((N + S) + W) + E)`` in f32, in the TPU kernel's order, rounded
    once to x's dtype."""
    xp = torch.nn.functional.pad(x.float(), (1, 1, 1, 1))
    out = 0.25 * (((xp[:-2, 1:-1] + xp[2:, 1:-1]) + xp[1:-1, :-2])
                  + xp[1:-1, 2:])
    return out.to(x.dtype)


def fconv2d(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Valid 2-D cross-correlation (the filter is not flipped): x
    (H + fr - 1, W + fc - 1), filt (fr, fc) -> (H, W), the taps summed in
    f32 row by row (r outer, c inner) as the TPU kernel unrolls them."""
    fr, fc = filt.shape
    H, W = x.shape[0] - fr + 1, x.shape[1] - fc + 1
    xf, ff = x.float(), filt.float()
    acc = torch.zeros((H, W), dtype=torch.float32, device=x.device)
    for r in range(fr):
        for c in range(fc):
            acc = acc + ff[r, c] * xf[r:r + H, c:c + W]
    return acc.to(x.dtype)


def dotprod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) in f32, as a 0-d f32 tensor."""
    return (a.float() * b.float()).sum()


def lane_dots(a: torch.Tensor, b: torch.Tensor, seg_len: int, nseg: int
              ) -> torch.Tensor:
    """(nseg,) f32 partial dot products, segment s over
    [s*seg_len, (s+1)*seg_len) of a and b zero-padded to nseg*seg_len."""
    pad = nseg * seg_len - a.numel()
    prod = torch.nn.functional.pad(a.float() * b.float(), (0, pad))
    return prod.reshape(nseg, seg_len).sum(dim=1)


LN2_F32 = 0.693147182464599609375          # ln 2 rounded to f32
#: 1 / LN2_F32 rounded to f32 (0x1.715476p+0): XLA compiles the reference's
#: ``x / ln2`` as the product by this reciprocal
INV_LN2_F32 = 1.44269502162933349609375
#: degree-6 Taylor coefficients of e^r, highest first (the TPU kernel's
#: ``_EXP_COEFFS``), each rounded to f32 as the kernel uses them
EXP_COEFFS = tuple(float(torch.tensor(c, dtype=torch.float32))
                   for c in (1 / 720., 1 / 120., 1 / 24., 1 / 6., 0.5, 1.0, 1.0))


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the product
    of two f32 values is exact in f64, so only the sum rounds (to f64, then
    to f32; the second rounding can differ from one f32 rounding only when
    the f64 sum lands on an f32 midpoint)."""
    return (a.double() * b.double() + c).float()


def expv(x: torch.Tensor) -> torch.Tensor:
    """exp(x) as the TPU kernel computes it (``_exp_poly``): clip to
    [-80, 80], ``k = round_half_even(x / ln2)`` with the quotient as XLA
    forms it (``x * INV_LN2_F32``, rounded once), ``r = fma(-k, ln2, x)``,
    six Horner steps ``p = fma(p, r, c)``, ``2**k * p``; f32 math, the
    result rounded once to x's dtype.  Not ``torch.exp``: this is the
    polynomial."""
    xf = torch.clamp(x.float(), -80.0, 80.0)
    k = torch.round(xf * INV_LN2_F32)
    r = _fma(-k, torch.full_like(k, LN2_F32), xf.double())
    p = torch.full_like(r, EXP_COEFFS[0])
    for c in EXP_COEFFS[1:]:
        p = _fma(p, r, c)
    # 2**k built from its exponent bits: exact, for |k| <= 116 after the clip
    scale = ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    return (p * scale).to(x.dtype)


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Row softmax of (R, W) in f32, as the TPU kernel writes it: the row
    max, ``e = exp(x - m)``, the row sum ``d``, then ``e / d``; the result in
    x's dtype."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)
