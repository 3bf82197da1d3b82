"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``'s
``matmul``, ``rmsnorm``, ``attention``, ``paged_attention`` and the paper's
Table I kernels ``jacobi2d``, ``fconv2d``, ``dotprod``, ``expv`` and
``softmax_rows``), and of the three backward kernels (``matmul_grad_a``,
``matmul_grad_b``, ``rmsnorm_bwd``, ``attention_bwd``), written as the
formulas of the gradients, not as autograd of the forward.  The CPU path
runs them; on the card they are what each kernel is held against."""
from __future__ import annotations

import functools
import math

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def matmul_grad_a(dc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dA = dC B^T of ``c = a @ b``: dc (M, N), b (K, N) -> (M, K)."""
    return (dc.float() @ b.float().T).to(dc.dtype)


def matmul_grad_b(a: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """dB = A^T dC of ``c = a @ b``: a (M, K), dc (M, N) -> (K, N)."""
    return (a.float().T @ dc.float()).to(dc.dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def rmsnorm_bwd(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``y = x * r * gamma``, ``r = rsqrt(mean(x^2) + eps)``
    over the last dim, in f32: with ``xh = x r`` and ``gy = dy gamma``,
    ``dx = r (gy - xh mean(gy xh))`` (in x's dtype) and ``dgamma = sum over
    rows of dy xh`` (in gamma's dtype)."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xh = xf * r
    gy = dy.float() * gamma.float()
    dx = r * (gy - xh * torch.mean(gy * xh, dim=-1, keepdim=True))
    dgamma = (dy.float() * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


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


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, *, causal: bool = True,
                  window: int | None = None):
    """dq, dk, dv of :func:`attention` for the output's gradient ``do``, in
    f32: P the masked softmax of ``s = q k^T / sqrt(D)`` (rows with no
    visible key all zero), ``dv = P^T do``, ``dP = do v^T``, ``dS = P (dP -
    rowsum(P dP))``, ``dq = dS k / sqrt(D)``, ``dk = dS^T q / sqrt(D)``; dk
    and dv of a kv head summed over its query heads.  Each in its input's
    dtype."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kq = expand_kv(k, Hq).float()
    vq = expand_kv(v, Hq).float()
    qf, dof = q.float(), do.float()
    s = torch.einsum("bhsd,bhtd->bhst", qf, kq) / math.sqrt(D)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    p = torch.where(mask & mask.any(-1, keepdim=True), p, 0.0)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vq)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kq) / math.sqrt(D)
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) / math.sqrt(D)
    dv = torch.einsum("bhst,bhsd->bhtd", p, dof)
    G = Hq // Hkv
    dk = dk.reshape(B, Hkv, G, Sk, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, G, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


@functools.cache
def _cpu_exp_ready() -> None:
    """Complete MKL's one-time set-up of its exp on one thread.

    On the CPU ``torch.exp`` of f32 is MKL's ``vmsExp``, called once for
    each 2048-element chunk on torch's intra-op threads.  In a process's
    first call that splits over threads, MKL's set-up races between them,
    and a worker's chunk can come back from a shorter polynomial: up to
    ~2e-4 relative, every element of the chunk.  The next call is right.
    One call on a single element, which runs on the calling thread alone,
    completes the set-up first."""
    torch.exp(torch.zeros(1))


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Row softmax of (R, W) in f32, as the TPU kernel writes it: the row
    max, ``e = exp(x - m)``, the row sum ``d``, then ``e / d``; the result in
    x's dtype."""
    if x.device.type == "cpu":
        _cpu_exp_ready()
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)
