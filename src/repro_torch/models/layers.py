"""Model sublayers of the dense decoder: GQA/SWA attention and SwiGLU.

The port's counterpart of the attention and MLP parts of
``repro.models.layers``.  Pure functions over param dicts built from ``PV``
definitions; math in f32, storage in ``cfg.dtype``.  Every RMSNorm and
every projection goes through ``kernels.ops``; attention itself is plain
PyTorch, as the JAX model leaves it to XLA.  Decode updates the KV cache
in place (the JAX layer returns a new cache).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.params import PV


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return kops.rmsnorm(x, g, eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, Dh), positions (..., S) or (S,).  The f32 cos/sin
    promote a bf16 x to f32; the result is cast back."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs     # (..., S, half)
    ang = ang[..., :, None, :]                                  # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    # written out, not F.silu, so bf16 rounds where the JAX model rounds
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    dt = cfg.dtype
    return {
        "norm": PV((d,), torch.float32, ("",), "ones"),
        "wq": PV((d, cfg.n_heads * hd), dt, ("fsdp", "model")),
        "wk": PV((d, cfg.n_kv_heads * hd), dt, ("fsdp", "model")),
        "wv": PV((d, cfg.n_kv_heads * hd), dt, ("fsdp", "model")),
        "wo": PV((cfg.n_heads * hd, d), dt, ("model", "fsdp")),
    }


def _qkv(p, x, cfg: ModelConfig, positions, rotate: bool):
    B, S, _ = x.shape
    hd = cfg.head_dim
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = kops.dense(xn, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = kops.dense(xn, p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = kops.dense(xn, p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if rotate:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """Repeat kv heads up to H: kv0,kv0,kv1,kv1,... (``jnp.repeat``), so
    query head h reads kv head h // (H / Hkv)."""
    Hkv = k.shape[2]
    if Hkv != H:
        k = torch.repeat_interleave(k, H // Hkv, dim=2)
    return k


def _sdpa_chunked(q, k, v, cfg: ModelConfig, *, causal: bool,
                  q_chunk: int = 512) -> torch.Tensor:
    """Exact attention over q blocks of ``q_chunk`` rows against full K/V:
    f32 softmax, causal and sliding-window masks with -1e30.  Rows are
    independent, so the block size does not change the result.
    q (B,S,H,Dh), k/v (B,T,Hkv,Dh) -> (B,S,H,Dh)."""
    B, S, H, Dh = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    kf = _expand_kv(k, H).to(torch.float32)
    vf = _expand_kv(v, H).to(torch.float32)
    k_pos = torch.arange(T, device=q.device)
    outs = []
    for off in range(0, S, q_chunk):
        qc = q[:, off:off + q_chunk]
        cq = qc.shape[1]
        s = torch.einsum("bqhd,bthd->bhqt", qc.to(torch.float32), kf) * scale
        q_pos = off + torch.arange(cq, device=q.device)
        mask = torch.ones((cq, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if cfg.window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < cfg.window
        s = torch.where(mask[None, None], s, -1e30)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqt,bthd->bqhd", pr, vf)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)


def attn_layer(p, x, cfg: ModelConfig, positions, *, causal: bool = True
               ) -> torch.Tensor:
    """Training / prefill self-attention (residual included)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions, rotate=True)
    o = _sdpa_chunked(q, k, v, cfg, causal=causal)
    o = kops.dense(o.reshape(B, S, cfg.n_heads * cfg.head_dim), p["wo"])
    return x + o.to(x.dtype)


class AttnCache(NamedTuple):
    k: torch.Tensor       # (B, W, Hkv, Dh) — pre-rotated keys
    v: torch.Tensor


def attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window else seq_len


def attn_cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> AttnCache:
    W = attn_cache_len(cfg, seq_len)
    shp = (batch, W, cfg.n_kv_heads, cfg.head_dim)
    return AttnCache(
        PV(shp, cfg.dtype, ("batch", "cache_seq", "kv", ""), "zeros"),
        PV(shp, cfg.dtype, ("batch", "cache_seq", "kv", ""), "zeros"))


def attn_layer_decode(p, x, cache: AttnCache, pos, cfg: ModelConfig):
    """One-token step, writing the new K/V into ``cache`` in place.

    pos: a scalar (shared position) or a (B,) tensor (per-slot true
    positions — the serving engine's continuous batch).  Full-attention
    caches index directly; SWA caches are ring buffers of length ``window``
    (entry i holds the newest position ≡ i mod W).  This is the JAX layer's
    single-device branch; the port has no mesh, and the sharded-cache
    branch belongs to the distributed slice."""
    B, S1, _ = x.shape                      # S1 == 1
    W = cache.k.shape[1]
    hd = cfg.head_dim
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    per_slot = pos.ndim == 1
    if per_slot:
        positions = pos[:, None]            # (B, 1) — rope broadcasts
    else:
        positions = (torch.zeros(S1, dtype=torch.int64, device=x.device)
                     + pos)[None, :]
    q, k, v = _qkv(p, x, cfg, positions, rotate=True)
    slot = pos % W
    if per_slot:
        # each batch row at its own ring slot; dead slots carry a stale
        # position and write into their own retired rows, as in JAX
        rows = torch.arange(B, device=x.device)
        cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    else:
        cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v[:, 0].to(cache.v.dtype)

    idx = torch.arange(W, device=x.device)
    pos_c = pos[:, None] if per_slot else pos
    if cfg.window:
        k_pos = pos_c - torch.remainder(pos_c - idx, W)   # newest ≡ i (mod W)
        valid = k_pos >= 0
    else:
        k_pos = idx
        valid = k_pos <= pos_c
    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, S1, cfg.n_kv_heads, G, hd)          # head = kv·G + g
    s = torch.einsum("bqhgd,bthd->bhgqt", qg.to(torch.float32),
                     cache.k.to(torch.float32)) / math.sqrt(hd)
    mask = valid & (k_pos <= pos_c)
    if cfg.window:
        mask &= (pos_c - k_pos) < cfg.window
    if mask.ndim == 2:                      # (B, W) per-slot mask
        s = torch.where(mask[:, None, None, None, :], s, -1e30)
    else:
        s = torch.where(mask[None, None, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqt,bthd->bqhgd", pr, cache.v.to(torch.float32))
    o = kops.dense(o.reshape(B, S1, cfg.n_heads * hd).to(x.dtype), p["wo"])
    return x + o.to(x.dtype), cache


def attn_layer_prefill(p, x, cfg: ModelConfig, positions, cache_len: int):
    """Prefill: run attention AND return the populated cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions, rotate=True)
    o = _sdpa_chunked(q, k, v, cfg, causal=True)
    o = kops.dense(o.reshape(B, S, cfg.n_heads * cfg.head_dim), p["wo"])
    W = cache_len
    if W >= S:
        pad = (0, 0, 0, 0, 0, W - S)        # zero rows after the prompt
        ck = torch.nn.functional.pad(k, pad)
        cv = torch.nn.functional.pad(v, pad)
    else:                                   # SWA ring buffer: last W tokens,
        roll = (S - W) % W                  # placed at slot pos % W
        ck = torch.roll(k[:, S - W:], shifts=roll, dims=1)
        cv = torch.roll(v[:, S - W:], shifts=roll, dims=1)
    return x + o.to(x.dtype), AttnCache(ck, cv)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "norm": PV((d,), torch.float32, ("",), "ones"),
        "wi": PV((d, f), dt, ("fsdp", "model")),
        "wg": PV((d, f), dt, ("fsdp", "model")),
        "wo": PV((f, d), dt, ("model", "fsdp")),
    }


def mlp_layer(p, x, cfg: ModelConfig) -> torch.Tensor:
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    h = silu(kops.dense(xn, p["wg"])) * kops.dense(xn, p["wi"])
    o = kops.dense(h, p["wo"])
    return x + o.to(x.dtype)
