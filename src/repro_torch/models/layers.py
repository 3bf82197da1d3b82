"""Model sublayers of the dense decoder: GQA/SWA attention and SwiGLU.

The port's counterpart of the attention and MLP parts of
``repro.models.layers``.  Pure functions over param dicts built from ``PV``
definitions; math in f32, storage in ``cfg.dtype``.  Every RMSNorm, every
projection, whole-prompt attention (``ops.attention``, where the JAX model
leaves it to XLA) and paged attention (``ops.paged_attention``) go through
``kernels.ops``; dense-cache decode attention is plain PyTorch.  Decode and
the paged layer update the KV cache or pool in place (the JAX layers
return new ones).
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


def _attention(q, k, v, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """q (B,S,H,Dh), k/v (B,T,Hkv,Dh) -> (B,S,H*Dh) through the attention
    seam, which takes (B,H,S,Dh): transposed views in, a transposed view of
    the result out, no copies on the card."""
    B, S, H, Dh = q.shape
    o = kops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       causal=causal, window=cfg.window)
    return o.transpose(1, 2).reshape(B, S, H * Dh)


def attn_layer(p, x, cfg: ModelConfig, positions, *, causal: bool = True
               ) -> torch.Tensor:
    """Training / prefill self-attention (residual included)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions, rotate=True)
    o = kops.dense(_attention(q, k, v, cfg, causal), p["wo"])
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
    o = kops.dense(_attention(q, k, v, cfg, causal=True), p["wo"])
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
# paged attention (block-table KV pool)
# ---------------------------------------------------------------------------
#
# K/V live in a shared pool of fixed-size token blocks (NB, bt, Hkv, Dh) per
# layer; each request holds a table of block ids, and attention reads through
# the table.  Block 0 is a permanent zero block: unallocated table entries
# read zeros, which is what the dense cache's unwritten rows hold.  The JAX
# package has two layers, a decode step and a prefill chunk; both are one
# layer here over a ``PagedBatch`` that says which rows attend over which
# table, and which pool rows the step writes.  Full attention only (no SWA
# ring): the paged engine rejects windowed configs.

class PagedBatch(NamedTuple):
    """What one paged forward needs, on the device, built once per forward
    (not once per layer) by :func:`decode_batch` or :func:`chunk_batch`.
    Row r of the step's flattened (B*S) tokens attends as one sequence of
    ``lens[r]`` tokens through ``tables[r]``."""
    positions: torch.Tensor   # (B, S) int64 rope positions
    tables: torch.Tensor      # (B*S, nblk) int32 block table of each row
    lens: torch.Tensor        # (B*S,) int32 tokens each row attends over
    src: torch.Tensor         # (n,) int64 rows whose K/V the step writes
    blk: torch.Tensor         # (n,) int64 ... into these pool blocks
    off: torch.Tensor         # (n,) int64 ... at these offsets
    n_valid: int              # rows at or past this write zero K/V


def decode_batch(tables, pos, live, bt: int, device) -> PagedBatch:
    """One decode token per slot: slot b attends over positions <= pos[b]
    through tables[b] (JAX's ``idx <= pos`` mask), and only live slots write
    their new K/V.  The JAX layer writes the current value back for dead
    slots; here several dead slots would index block 0 at once, and the zero
    block must stay zero, so dead slots write nothing.  Inputs may be numpy
    arrays or CPU tensors: the live rows are found on the host."""
    tables = torch.as_tensor(tables).to("cpu", torch.int32)
    pos = torch.as_tensor(pos).to("cpu", torch.int64)
    rows = torch.nonzero(torch.as_tensor(live).cpu())[:, 0]
    p = pos[rows]
    blk = tables[rows, p // bt].long()
    return PagedBatch(pos[:, None].to(device), tables.to(device),
                      (pos + 1).to(device, torch.int32), rows.to(device),
                      blk.to(device), (p % bt).to(device), len(pos))


def chunk_batch(table_row, start: int, valid: int, c: int, bt: int,
                device) -> PagedBatch:
    """One prefill chunk of c tokens (B == 1) at positions start..start+c-1,
    of which the first ``valid`` are real: row t attends over positions
    <= start + t (JAX's causal mask over the gathered view, which is exactly
    the paged kernel's ``lens = start + t + 1``).  As in JAX, the chunk's
    K/V are written into every allocated block it covers, padding rows as
    zeros; entries still 0 (past the prompt) are not written."""
    row = torch.as_tensor(table_row).to("cpu", torch.int64)
    t = torch.arange(c)
    posn = start + t
    blk = row[posn // bt]
    keep = blk != 0
    return PagedBatch(posn[None].to(device),
                      row.to(torch.int32)[None].expand(c, -1).contiguous().to(device),
                      (posn + 1).to(device, torch.int32), t[keep].to(device),
                      blk[keep].to(device), (posn % bt)[keep].to(device), valid)


def attn_layer_paged(p, x, pk: torch.Tensor, pv: torch.Tensor, pb: PagedBatch,
                     cfg: ModelConfig) -> torch.Tensor:
    """Attention of a decode step (x (B, 1, d)) or of a prefill chunk
    (x (1, c, d)) against one layer's block pool pk/pv (NB, bt, Hkv, Dh).
    The step's K/V are written into the pool in place first, then every row
    attends through ``ops.paged_attention``, which reads the pool through a
    permuted view, never a copy."""
    B, S, _ = x.shape
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    G = cfg.n_heads // Hkv
    q, k, v = _qkv(p, x, cfg, pb.positions, rotate=True)
    k = k.reshape(B * S, Hkv, hd)
    v = v.reshape(B * S, Hkv, hd)
    if pb.n_valid < B * S:                  # chunk padding: zero K/V
        k[pb.n_valid:] = 0
        v[pb.n_valid:] = 0
    pk[pb.blk, pb.off] = k[pb.src].to(pk.dtype)
    pv[pb.blk, pb.off] = v[pb.src].to(pv.dtype)
    o = kops.paged_attention(q.reshape(B * S, Hkv, G, hd),
                             pk.permute(2, 0, 1, 3), pv.permute(2, 0, 1, 3),
                             pb.tables, pb.lens)
    o = kops.dense(o.reshape(B, S, cfg.n_heads * hd).to(x.dtype), p["wo"])
    return x + o.to(x.dtype)


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
