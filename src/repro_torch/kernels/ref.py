"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``'s
``matmul``, ``rmsnorm``, ``attention`` and ``paged_attention``).  The CPU
path runs them; on the card they are what each kernel is held against."""
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
