"""Model sublayers of the decoder families: GQA/SWA attention, SwiGLU and
the top-k MoE.

The port's counterpart of the attention, MLP and MoE parts of
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


# ---------------------------------------------------------------------------
# MoE: top-k routing, capacity dispatch (the reference's "local" mode)
# ---------------------------------------------------------------------------
#
# One device holds every expert, so this is the reference's ``moe_layer``
# without a mesh (``moe_mode`` gives "local"); its tp, ep and ep_a2a modes
# come with the distributed slice.  Capacity C counts every row of the call
# (a decode step's dead slots and a chunk's padding rows too), as in JAX.

def moe_defs(cfg: ModelConfig) -> dict:
    """The reference's ``moe_defs`` (``moe_defs_tp`` has the same shapes and
    keys; only its logical axes differ)."""
    d, dt = cfg.d_model, cfg.dtype
    E = cfg.n_experts
    ffe = cfg.d_ff_expert or cfg.d_ff
    return {
        "norm": PV((d,), torch.float32, ("",), "ones"),
        "router": PV((d, E), torch.float32, ("fsdp", "")),
        "wi": PV((E, d, ffe), dt, ("model", "fsdp", "")),
        "wg": PV((E, d, ffe), dt, ("model", "fsdp", "")),
        "wo": PV((E, ffe, d), dt, ("model", "", "fsdp")),
    }


class Routing(NamedTuple):
    """One MoE call's routing over its N = B*S rows, flattened in (B, S)
    order: the f32 router logits, each row's k experts (highest first) and
    their softmax-normalised gates, the capacity C of every expert, and
    each (expert, row) pair's slot in that expert's buffer (C where the
    row did not choose the expert or came past capacity: dropped)."""
    logits: torch.Tensor      # (N, E) f32
    idx: torch.Tensor         # (N, k) int64
    gate: torch.Tensor        # (N, k) f32
    slots: torch.Tensor       # (E, N) int64
    capacity: int


def moe_capacity(cfg: ModelConfig, n_rows: int) -> int:
    """Each expert's buffer rows, the reference's float expression."""
    k, E = cfg.experts_per_token, cfg.n_experts
    return max(1, int(math.ceil(n_rows * k / E * cfg.capacity_factor)))


def expert_slots(idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """(N, k) chosen experts -> (E, N) buffer slots: a row's slot in expert
    j is the count of earlier rows that chose j, or C (the discard row) for
    an unchosen pair or one past capacity.  A fixed-shape scatter, with no
    host sync; each expert's rows lie along the last dim, which the scan
    walks (a scan down N rows of E columns runs E threads)."""
    chosen = torch.zeros((E, idx.shape[0]), dtype=torch.int64, device=idx.device)
    chosen.scatter_(0, idx.T, 1)
    pos = torch.cumsum(chosen, dim=1) - 1
    return torch.where((chosen > 0) & (pos < C), pos, C)


def moe_route(p, xn: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The router over normed rows xn (B, S, d).  The logits stay a plain
    f32 ``torch.matmul``, as the reference's ``@`` leaves them to XLA."""
    N = xn.shape[0] * xn.shape[1]
    logits = torch.matmul(xn.to(torch.float32), p["router"]).reshape(N, -1)
    gate, idx = torch.topk(logits, cfg.experts_per_token, dim=-1)
    C = moe_capacity(cfg, N)
    return Routing(logits, idx, torch.softmax(gate, dim=-1),
                   expert_slots(idx, cfg.n_experts, C), C)


def expert_terms(xf: torch.Tensor, r: Routing, wi, wg, wo):
    """Each expert's part of the combine, in expert order: its gate (N,)
    and its output gathered back to the rows (N, d) f32, zero where the
    row was not dispatched to it.  The rows of xf (N, d) f32 go to each
    expert's C-row buffer in the weight dtype (dropped and unchosen rows
    land on the discard row C), and its SwiGLU goes through the matmul
    seam."""
    N, d = xf.shape
    C = r.capacity
    xw = xf.to(wi.dtype)
    zero = torch.zeros((1, d), dtype=torch.float32, device=xf.device)
    for j in range(wi.shape[0]):
        gate = torch.where(r.idx == j, r.gate, 0.0).sum(dim=-1)
        slot = r.slots[j]
        buf = torch.zeros((C + 1, d), dtype=wi.dtype, device=xf.device)
        buf[slot] = xw
        buf = buf[:C]
        h = silu(kops.dense(buf, wg[j])) * kops.dense(buf, wi[j])
        y = kops.dense(h, wo[j]).to(torch.float32)
        yield gate, torch.cat([y, zero])[slot]


def _dispatch_ffn(xf: torch.Tensor, r: Routing, wi, wg, wo) -> torch.Tensor:
    """Capacity-dispatch the N rows of xf (N, d) f32 to every expert and
    combine: (N, d) f32, each expert's output added with its gate in
    expert order (no atomic accumulate: the same bits every run)."""
    out = torch.zeros_like(xf)
    for gate, y in expert_terms(xf, r, wi, wg, wo):
        out = out + gate[:, None] * y
    return out


def moe_layer(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE over every row of x (B, S, d), residual included."""
    B, S, d = x.shape
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    r = moe_route(p, xn, cfg)
    y = _dispatch_ffn(xn.reshape(B * S, d).to(torch.float32), r,
                      p["wi"], p["wg"], p["wo"])
    return x + y.reshape(B, S, d).to(x.dtype)
