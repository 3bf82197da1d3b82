"""Model sublayers: GQA/SWA self-attention, cross-attention to a context,
SwiGLU, the top-k MoE and the Mamba2 (SSD) block.

The port's counterpart of ``repro.models.layers``.  Pure functions over
param dicts built from ``PV`` definitions; math in f32, storage in
``cfg.dtype``.  Every RMSNorm, every projection, whole-prompt attention
(``ops.attention``, where the JAX model leaves it to XLA; cross-attention's
too, non-causal over the context's keys) and paged attention
(``ops.paged_attention``) go through ``kernels.ops``; dense-cache decode
attention (self and cross), the MoE router and dispatch, and the SSD scan
and causal conv are plain PyTorch, as they are jnp in the reference.
Decode and the paged layer update the KV cache, the Mamba state or the pool
in place (the JAX layers return new ones).
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


# -- cross attention ----------------------------------------------------------

def xattn_defs(cfg: ModelConfig) -> dict:
    """``attn_defs``' leaves; ``wk`` and ``wv`` read the context."""
    return attn_defs(cfg)


class XAttnCache(NamedTuple):
    k: torch.Tensor       # (B, T, Hkv, Dh) — projected context, fixed
    v: torch.Tensor


def xattn_prefill_cache(p, ctx, cfg: ModelConfig) -> XAttnCache:
    """The context's keys and values, ctx (B, T, d) through ``wk`` and
    ``wv``: (B, T, Hkv, Dh) each, no rotation."""
    B, T, _ = ctx.shape
    hd = cfg.head_dim
    k = kops.dense(ctx, p["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = kops.dense(ctx, p["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    return XAttnCache(k, v)


def _xattn(p, x, ctx, cfg: ModelConfig):
    """The sublayer and the context's K/V it made: rmsnorm, ``wq`` on x,
    ``wk`` and ``wv`` on ctx, attention non-causal over all T keys (with
    ``cfg.window`` as the reference's mask takes it), ``wo``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = kops.dense(xn, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    kv = xattn_prefill_cache(p, ctx, cfg)
    o = kops.dense(_attention(q, *kv, cfg, causal=False), p["wo"])
    return x + o.to(x.dtype), kv


def xattn_layer(p, x, ctx, cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention to a context (encoder output / image embeddings),
    ctx (B, T, d), residual included (:func:`_xattn`).  No positional
    rotation."""
    return _xattn(p, x, ctx, cfg)[0]


def xattn_cache_defs(cfg: ModelConfig, batch: int) -> XAttnCache:
    """The reference's shape, (B, n_ctx_tokens, Hkv, Dh): 0 context tokens
    for the encdec family, whose context length comes from the prompt
    (``lm.context_len``), so only ``prefill``'s cache holds its context."""
    shp = (batch, cfg.n_ctx_tokens, cfg.n_kv_heads, cfg.head_dim)
    return XAttnCache(PV(shp, cfg.dtype, ("batch", "", "kv", ""), "zeros"),
                      PV(shp, cfg.dtype, ("batch", "", "kv", ""), "zeros"))


def xattn_layer_prefill(p, x, ctx, cfg: ModelConfig):
    """Prefill: the sublayer and its cache.  The reference projects the
    context's K/V twice, in ``xattn_layer`` and again in
    ``xattn_prefill_cache``; both are the same product on the same inputs,
    so here they are made once and kept as the cache (4 products, not 6)."""
    return _xattn(p, x, ctx, cfg)


def xattn_layer_decode(p, x, cache: XAttnCache, cfg: ModelConfig):
    """One-token step against the cached context K/V, as the reference's:
    ``wq`` and ``wo`` through the matmul seam, the scores, softmax and
    weighted sum plain f32 einsums over every cached key.  The cache is
    not written; it is returned."""
    B, S1, _ = x.shape
    hd = cfg.head_dim
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = kops.dense(xn, p["wq"]).reshape(B, S1, cfg.n_heads, hd)
    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, S1, cfg.n_kv_heads, G, hd)
    s = torch.einsum("bqhgd,bthd->bhgqt", qg.to(torch.float32),
                     cache.k.to(torch.float32)) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqt,bthd->bqhgd", pr, cache.v.to(torch.float32))
    o = kops.dense(o.reshape(B, S1, cfg.n_heads * hd).to(x.dtype), p["wo"])
    return x + o.to(x.dtype), cache


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
    # unbind, not wi[j]: the weights' gradient is one stack of the experts'
    # (an index's backward would scatter each into a zero (E, d, f) buffer)
    for j, (wi_j, wg_j, wo_j) in enumerate(zip(wi.unbind(0), wg.unbind(0),
                                               wo.unbind(0))):
        gate = torch.where(r.idx == j, r.gate, 0.0).sum(dim=-1)
        slot = r.slots[j]
        buf = torch.zeros((C + 1, d), dtype=wi.dtype, device=xf.device)
        buf[slot] = xw                  # its backward gathers the rows back
        buf = buf[:C]
        h = silu(kops.dense(buf, wg_j)) * kops.dense(buf, wi_j)
        y = kops.dense(h, wo_j).to(torch.float32)
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


# ---------------------------------------------------------------------------
# Mamba2 (SSD, chunked): arXiv:2405.21060
# ---------------------------------------------------------------------------
#
# The reference's jnp, in plain torch on either device: the projections and
# norms go through the kernels, the causal conv, the SSD scan and the
# one-token recurrence are element-wise ops and einsums around them.

def mamba_defs(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    di, N, H = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads
    kc = cfg.ssm_conv
    return {
        "norm": PV((d,), torch.float32, ("",), "ones"),
        "in_proj": PV((d, 2 * di + 2 * N + H), dt, ("fsdp", "model")),
        "conv_w": PV((kc, di + 2 * N), dt, ("", "model")),
        "conv_b": PV((di + 2 * N,), dt, ("model",), "zeros"),
        "A_log": PV((H,), torch.float32, ("model",), "zeros"),
        "D": PV((H,), torch.float32, ("model",), "ones"),
        "dt_bias": PV((H,), torch.float32, ("model",), "zeros"),
        "gnorm": PV((di,), torch.float32, ("model",), "ones"),
        "out_proj": PV((di, d), dt, ("model", "fsdp")),
    }


def ssd_chunk_len(chunk: int, S: int) -> int:
    """The reference's chunk rule: ``min(chunk, S)``, lowered until it
    divides S (a prime S is one chunk of S rows)."""
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


def segment_decay(dA_cs: torch.Tensor) -> torch.Tensor:
    """The intra-chunk decay ``L[q, k] = exp(dA_cs[q] - dA_cs[k])`` for
    q >= k, else 0: dA_cs (B, nc, Q, H) -> (B, nc, Q, Q, H).

    The one deliberate difference from the reference
    (``jnp.where(causal, jnp.exp(seg), 0.0)``): the mask goes in before
    the exponential.  Above the diagonal seg is positive (hundreds at chunk
    256), so exp overflows to inf; the forward picks 0 either way, and
    exp(-inf) is exactly that 0, but the reference's backward multiplies
    the zero cotangent by inf, which is NaN."""
    Q = dA_cs.shape[2]
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=dA_cs.device).tril()
    return torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                 float("-inf")))


def _ssd_chunked(xh, dtv, Bm, Cm, A, chunk: int, state_in=None):
    """Chunked state-space dual form: xh (B, S, H, P) f32, dtv (B, S, H),
    Bm/Cm (B, S, N), A (H,) negative -> y (B, S, H, P), the final state
    (B, H, P, N).  The reference's ``_ssd_chunked``: its einsums, and the
    inter-chunk recurrence a loop over the chunks (its ``lax.scan``)."""
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = ssd_chunk_len(chunk, S)
    nc = S // Q
    r = lambda t: t.reshape((Bsz, nc, Q) + t.shape[2:])
    xc, dtc, Bc, Cc = r(xh), r(dtv), r(Bm), r(Cm)

    dA = dtc * A[None, None, None, :]                 # (B,nc,Q,H) negative
    dA_cs = torch.cumsum(dA, dim=2)                   # within-chunk cumsum
    L = segment_decay(dA_cs)                          # (B,nc,Q,Q,H)
    xdt = xc * dtc[..., None]                         # (B,nc,Q,H,P)
    # intra-chunk (diagonal blocks)
    y_diag = torch.einsum("bcqn,bckn,bcqkh,bckhp->bcqhp", Cc, Bc, L, xdt)
    # chunk-final states
    decay_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)
    S_c = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, decay_end, xdt)
    # inter-chunk recurrence: each chunk's incoming state
    chunk_decay = torch.exp(torch.sum(dA, dim=2))     # (B,nc,H)
    s = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
         if state_in is None else state_in)
    s_ins = []
    for c in range(nc):
        s_ins.append(s)
        s = S_c[:, c] + chunk_decay[:, c, :, None, None] * s
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, torch.stack(s_ins, 1),
                         torch.exp(dA_cs))
    return (y_diag + y_off).reshape(Bsz, S, H, Pd), s


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` (not
    ``F.softplus``, which returns x itself past its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _mamba_project(p, x, cfg: ModelConfig):
    """The normed input through ``in_proj``: z (B, S, di), the conv's
    channels x|B|C (B, S, di + 2N) and dt (B, S, H), views of one product."""
    di, N, H = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    proj = kops.dense(xn, p["in_proj"])               # (B,S,2di+2N+H)
    z, xbc, dtv = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    return z, xbc, dtv


def _mamba_out(p, x, y, z, cfg: ModelConfig) -> torch.Tensor:
    """The gated norm of y (B, S, di) and ``out_proj``, residual added."""
    y = rmsnorm(y.to(x.dtype) * silu(z), p["gnorm"], cfg.norm_eps)
    return x + kops.dense(y, p["out_proj"]).to(x.dtype)


class MambaMix(NamedTuple):
    """A Mamba block's tensors ahead of the SSD: the gate z (B, S, di), the
    conv's input after the carried window (B, kc-1+S, di+2N), and the SSD's
    f32 inputs xh (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, N), A (H,)."""
    z: torch.Tensor
    xbc_p: torch.Tensor
    xh: torch.Tensor
    dt: torch.Tensor
    Bm: torch.Tensor
    Cm: torch.Tensor
    A: torch.Tensor


def mamba_mix(p, x, cfg: ModelConfig, conv_state=None) -> MambaMix:
    """``in_proj``, the depthwise causal conv over (x, B, C) (the
    reference's sum of kc shifted products, after ``conv_state`` or
    zeros), its silu, and dt's softplus."""
    B, S, _ = x.shape
    di, N, H = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads
    kc = cfg.ssm_conv
    z, xbc, dtv = _mamba_project(p, x, cfg)
    pad = (torch.zeros((B, kc - 1, xbc.shape[-1]), dtype=xbc.dtype,
                       device=x.device) if conv_state is None else conv_state)
    xbc_p = torch.cat([pad, xbc], dim=1)
    conv = sum(xbc_p[:, i:i + S] * p["conv_w"][i][None, None]
               for i in range(kc)) + p["conv_b"][None, None]
    xc, Bm, Cm = torch.split(silu(conv), [di, N, N], dim=-1)
    return MambaMix(z, xbc_p,
                    xc.reshape(B, S, H, cfg.ssm_head_dim).to(torch.float32),
                    softplus(dtv.to(torch.float32) + p["dt_bias"][None, None]),
                    Bm.to(torch.float32), Cm.to(torch.float32),
                    -torch.exp(p["A_log"]))


def mamba_layer(p, x, cfg: ModelConfig, conv_state=None, ssm_state=None,
                return_state: bool = False):
    """Train/prefill Mamba2 block over the whole sequence (chunked SSD),
    residual included.  ``conv_state`` (B, kc-1, di+2N) and ``ssm_state``
    (B, H, P, N) f32 continue a sequence; ``return_state`` also returns
    the (conv, ssm) states after it."""
    B, S, _ = x.shape
    kc = cfg.ssm_conv
    m = mamba_mix(p, x, cfg, conv_state)
    y, s_final = _ssd_chunked(m.xh, m.dt, m.Bm, m.Cm, m.A, cfg.ssm_chunk,
                              ssm_state)
    y = y + p["D"][None, None, :, None] * m.xh        # skip
    res = _mamba_out(p, x, y.reshape(B, S, cfg.d_inner_ssm), m.z, cfg)
    if return_state:
        new_conv = m.xbc_p[:, S:S + kc - 1] if kc > 1 else m.xbc_p[:, :0]
        return res, (new_conv, s_final.to(torch.float32))
    return res


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, kc-1, di+2N) in the model dtype
    state: torch.Tensor   # (B, H, P, N) f32


def mamba_cache_defs(cfg: ModelConfig, batch: int) -> MambaCache:
    di, N, H = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads
    return MambaCache(
        PV((batch, cfg.ssm_conv - 1, di + 2 * N), cfg.dtype,
           ("batch", "", "model"), "zeros"),
        PV((batch, H, cfg.ssm_head_dim, N), torch.float32,
           ("batch", "model", "", ""), "zeros"))


def mamba_layer_decode(p, x, cache: MambaCache, cfg: ModelConfig):
    """One-token recurrent step, x (B, 1, d): state <- exp(dt A) state +
    dt B x, y = C . state.  Writes the new conv window and state into
    ``cache`` in place and returns (x out, cache)."""
    B = x.shape[0]
    di, N, H = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads
    kc = cfg.ssm_conv
    z, xbc, dtv = _mamba_project(p, x, cfg)
    window = torch.cat([cache.conv, xbc], dim=1)              # (B, kc, ch)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xc, Bm, Cm = torch.split(silu(conv)[:, None, :], [di, N, N], dim=-1)
    xh = xc.reshape(B, H, cfg.ssm_head_dim).to(torch.float32)
    dtb = softplus(dtv.to(torch.float32)[:, 0] + p["dt_bias"][None])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dtb * A[None])                             # (B,H)
    Bv = Bm[:, 0].to(torch.float32)                           # (B,N)
    Cv = Cm[:, 0].to(torch.float32)
    upd = torch.einsum("bh,bhp,bn->bhpn", dtb, xh, Bv)
    state = cache.state * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cv) + p["D"][None, :, None] * xh
    out = _mamba_out(p, x, y.reshape(B, 1, di), z, cfg)
    if kc > 1:
        cache.conv.copy_(window[:, 1:])
    cache.state.copy_(state)
    return out, cache
