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

**Under a mesh** (``rules``, a ``parallel.sharding.ShardingRules`` with a
process mesh; every layer takes it as a keyword that defaults to no mesh)
each rank runs the layer on its blocks of the weights, as the reference's
logical axes cut them, and issues the collectives the cut implies
(``parallel.comm``): attention and the MLP are tensor-parallel over the
`model` dimensions (a rank's heads and d_ff columns; one psum after each
``wo``, ``copy_to_group`` where the replicated normed input enters), the
MoE sublayer runs in the reference's ``tp``, ``ep`` or ``ep_a2a`` mode
(``moe_mode``), and decode attention over a cache whose slots are cut over
`model` (``cache_seq="model"``) writes the new token into the slice that
owns its slot and merges the slices' softmax with a pmax and two psums.
Cross-attention cuts its q heads and the context's kv heads over `model`
as self-attention does; paged attention runs on a rank's kv heads of the
pool.  The Mamba2 sublayer runs a rank's SSD heads: ``in_proj``'s output
and the conv's weights are gathered over `model` (their columns are cut
contiguously, not by head), the rank takes its heads' z, x and dt and the
B and C that every head shares, the gated norm sums its squares over
`model`, and ``out_proj``'s rows are followed by a psum.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import ShardingRules, rule_axes
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


# -- the mesh ------------------------------------------------------------------

def _mesh(rules: ShardingRules | None):
    return None if rules is None else rules.mesh


def _model_axes(rules: ShardingRules | None) -> tuple:
    """Mesh dimensions the logical `model` (TP/EP) axis maps to, flattened
    outer-major: ("model",) on a plain mesh, every level's dimension on a
    topology mesh whose `model` rule names them all."""
    return () if rules is None else rule_axes(rules, "model")


def _model_size(rules: ShardingRules | None) -> int:
    axes = _model_axes(rules)
    return rules.mesh.axis_size(axes) if axes else 1


def _psum_model(o: torch.Tensor, rules) -> torch.Tensor:
    """The sum over the `model` dimensions of a rank's partial output (a
    row-cut ``wo``'s), identity off-mesh."""
    axes = _model_axes(rules)
    return comm.psum(o, axes, rules.mesh) if axes else o


def _into_model(xn: torch.Tensor, rules) -> torch.Tensor:
    """Where a replicated input enters compute cut over `model`."""
    axes = _model_axes(rules)
    return comm.copy_to_group(xn, axes, rules.mesh) if axes else xn


def _local_heads(cfg: ModelConfig, rules) -> tuple[int, int]:
    """(this rank's first q head, its number of q heads)."""
    m = _model_size(rules)
    if cfg.n_heads % m:
        raise ValueError(f"{cfg.n_heads} heads do not split over {m} ranks")
    h = cfg.n_heads // m
    return (comm.axis_index(_model_axes(rules), rules.mesh) * h if m > 1 else 0), h


def _select_kv(k: torch.Tensor, cfg: ModelConfig, rules) -> torch.Tensor:
    """Every kv head k (B, T, Hkv, Dh) -> the kv heads this rank's q heads
    read: the contiguous block of Hkv/|model| heads where Hkv divides over
    `model` (GQA kept), else one kv head a q head (the reference's
    ``_expand_kv``, sliced to the rank's heads)."""
    m = _model_size(rules)
    if m == 1:
        return k
    h0, hl = _local_heads(cfg, rules)
    Hkv, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    if Hkv % m == 0:
        n = Hkv // m
        return k[:, :, h0 // G:h0 // G + n]
    idx = torch.arange(h0, h0 + hl, device=k.device) // G
    return k.index_select(2, idx)


def _qkv(p, x, cfg: ModelConfig, positions, rotate: bool, rules=None,
         whole_kv: bool = False):
    """Normed x through ``wq``, ``wk``, ``wv``: q (B, S, H, Dh), k and v
    (B, S, Hkv, Dh).  Under a mesh q holds this rank's heads, and k and v
    this rank's kv heads where Hkv divides over `model` and not
    ``whole_kv``, else every kv head (the rank's columns gathered over
    `model`: ``wk`` and ``wv`` are cut on their flat Hkv*Dh dimension, so
    a rank's columns may cut through a head)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    xn = _into_model(rmsnorm(x, p["norm"], cfg.norm_eps), rules)
    m = _model_size(rules)
    q = kops.dense(xn, p["wq"]).reshape(B, S, cfg.n_heads // m, hd)
    k = kops.dense(xn, p["wk"])
    v = kops.dense(xn, p["wv"])
    if m > 1 and (whole_kv or cfg.n_kv_heads % m):
        axes, mesh = _model_axes(rules), rules.mesh
        k = comm.all_gather(k, axes, mesh, dim=-1)
        v = comm.all_gather(v, axes, mesh, dim=-1)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if rotate:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention(q, k, v, cfg: ModelConfig, causal: bool, rules=None) -> torch.Tensor:
    """q (B,S,H,Dh), k/v (B,T,Hkv,Dh) -> (B,S,H*Dh) through the attention
    seam, which takes (B,H,S,Dh): transposed views in, a transposed view of
    the result out, no copies on the card.  Under a mesh q holds the rank's
    heads; k and v holding every kv head are cut to the ones they read."""
    B, S, H, Dh = q.shape
    if k.shape[2] == cfg.n_kv_heads and H != cfg.n_heads:
        k, v = _select_kv(k, cfg, rules), _select_kv(v, cfg, rules)
    o = kops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       causal=causal, window=cfg.window)
    return o.transpose(1, 2).reshape(B, S, H * Dh)


def attn_layer(p, x, cfg: ModelConfig, positions, *, causal: bool = True,
               rules: ShardingRules | None = None) -> torch.Tensor:
    """Training / prefill self-attention (residual included)."""
    q, k, v = _qkv(p, x, cfg, positions, rotate=True, rules=rules)
    o = kops.dense(_attention(q, k, v, cfg, causal, rules), p["wo"])
    return x + _psum_model(o, rules).to(x.dtype)


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


def _decode_mask(idx, pos_c, W: int, cfg: ModelConfig):
    """The reference's decode mask over cache entries ``idx``: entry i
    holds position i (full attention) or the newest position ≡ i mod W
    (a window's ring), visible if written and within the window."""
    if cfg.window:
        k_pos = pos_c - torch.remainder(pos_c - idx, W)   # newest ≡ i (mod W)
        valid = k_pos >= 0
    else:
        k_pos = idx
        valid = k_pos <= pos_c
    mask = valid & (k_pos <= pos_c)
    if cfg.window:
        mask &= (pos_c - k_pos) < cfg.window
    return mask


def _masked_scores(qg, ck, mask, hd: int):
    """f32 scores (B, Hkv, G, 1, T) of qg (B, 1, Hkv, G, Dh) against ck
    (B, T, Hkv, Dh), -1e30 where ``mask`` ((T,) or (B, T)) is False."""
    s = torch.einsum("bqhgd,bthd->bhgqt", qg.to(torch.float32),
                     ck.to(torch.float32)) / math.sqrt(hd)
    if mask.ndim == 2:                      # (B, W) per-slot mask
        return torch.where(mask[:, None, None, None, :], s, -1e30)
    return torch.where(mask[None, None, None, None, :], s, -1e30)


def attn_layer_decode(p, x, cache: AttnCache, pos, cfg: ModelConfig,
                      rules: ShardingRules | None = None):
    """One-token step, writing the new K/V into ``cache`` in place.

    pos: a scalar (shared position) or a (B,) tensor (per-slot true
    positions — the serving engine's continuous batch).  Full-attention
    caches index directly; SWA caches are ring buffers of length ``window``
    (entry i holds the newest position ≡ i mod W).

    Under a mesh the cache is this rank's block (``attn_cache_defs``'
    logical axes under ``rules``).  With ``cache_seq="model"`` each rank
    holds W/|model| slots of every kv head: the token's q, k and v are
    gathered over `model`, the rank that owns the slot writes it, each rank
    scores its slots, and the softmax is merged with a pmax and psums over
    `model` (the reference's ``dist_cache`` branch; per-slot positions
    raise, as there).  Otherwise the cache holds the rank's kv heads (the
    ``kv`` rule) or every kv head, and each rank attends with its q heads."""
    B, S1, _ = x.shape                      # S1 == 1
    W = cache.k.shape[1]
    hd = cfg.head_dim
    host_pos = pos if isinstance(pos, int) else None
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    per_slot = pos.ndim == 1
    if per_slot:
        positions = pos[:, None]            # (B, 1) — rope broadcasts
    else:
        positions = (torch.zeros(S1, dtype=torch.int64, device=x.device)
                     + pos)[None, :]
    if _dist_cache(rules):
        if per_slot:
            raise NotImplementedError(
                "per-slot decode positions are not supported with the "
                "model-sharded (cache_seq) distributed cache path")
        return _decode_dist_cache(p, x, cache, pos, positions, cfg, rules,
                                  host_pos)
    whole_kv = _model_size(rules) > 1 and not _kv_cut(rules)
    q, k, v = _qkv(p, x, cfg, positions, rotate=True, rules=rules,
                   whole_kv=whole_kv)
    slot = pos % W if host_pos is None else host_pos % W
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
    mask = _decode_mask(idx, pos[:, None] if per_slot else pos, W, cfg)
    ck, cv = cache.k, cache.v
    if whole_kv:                            # every kv head: the rank's q heads' ones
        ck, cv = _select_kv(ck, cfg, rules), _select_kv(cv, cfg, rules)
    H = q.shape[2]
    Hk = ck.shape[2]
    qg = q.reshape(B, S1, Hk, H // Hk, hd)                # head = kv·G + g
    pr = torch.softmax(_masked_scores(qg, ck, mask, hd), dim=-1)
    o = torch.einsum("bhgqt,bthd->bqhgd", pr, cv.to(torch.float32))
    o = kops.dense(o.reshape(B, S1, H * hd).to(x.dtype), p["wo"])
    return x + _psum_model(o, rules).to(x.dtype), cache


def _kv_cut(rules) -> bool:
    """Whether a cache's kv-head dimension is cut over `model` (the ``kv``
    rule, which holds only where the kv heads divide)."""
    spec = rules.spec(("batch", "cache_seq", "kv", ""))
    return bool(spec[2])


def _dist_cache(rules) -> bool:
    """Whether a decode cache's slots are cut over `model`."""
    return _mesh(rules) is not None and rules.axis("cache_seq") == "model"


def _decode_dist_cache(p, x, cache: AttnCache, pos, positions,
                       cfg: ModelConfig, rules: ShardingRules,
                       host_pos: int | None = None):
    """``attn_layer_decode`` over a cache whose W slots are cut over
    `model`: this rank holds slots [r W_loc, (r+1) W_loc) of every kv head.
    The cache is never gathered: only the token's q, k, v (gathered) and
    the (m, l, o) partials of the softmax cross the ranks.  ``host_pos``:
    the position where the caller gave it as an int (no read of ``pos``
    back from its device)."""
    B, S1, _ = x.shape
    hd, Hkv, H = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads
    mesh, axes = rules.mesh, _model_axes(rules)
    q, k, v = _qkv(p, x, cfg, positions, rotate=True, rules=rules, whole_kv=True)
    h0, hl = _local_heads(cfg, rules)
    if hl != H:                             # every head's query
        q = comm.gather(q, axes, mesh, dim=2)
    W_loc = cache.k.shape[1]
    W = W_loc * (mesh.axis_size(axes) if axes else 1)
    base = (comm.axis_index(axes, mesh) if axes else 0) * W_loc
    sl = (int(pos) if host_pos is None else host_pos) % W
    if base <= sl < base + W_loc:           # this rank owns the slot
        cache.k[:, sl - base] = k[:, 0].to(cache.k.dtype)
        cache.v[:, sl - base] = v[:, 0].to(cache.v.dtype)
    idx = base + torch.arange(W_loc, device=x.device)
    s = _masked_scores(q.reshape(B, S1, Hkv, H // Hkv, hd), cache.k,
                       _decode_mask(idx, pos, W, cfg), hd)
    m = comm.pmax(torch.amax(s, dim=-1, keepdim=True), axes, mesh)
    pr = torch.exp(s - m)
    l = comm.psum(torch.sum(pr, dim=-1, keepdim=True), axes, mesh)
    o = comm.psum(torch.einsum("bhgqt,bthd->bqhgd", pr,
                               cache.v.to(torch.float32)), axes, mesh)
    ln = torch.clamp(l, min=1e-20).squeeze(-1).permute(0, 3, 1, 2)
    o = (o / ln[..., None]).reshape(B, S1, H * hd)[..., h0 * hd:(h0 + hl) * hd]
    o = kops.dense(o.to(x.dtype), p["wo"])
    return x + _psum_model(o, rules).to(x.dtype), cache


def attn_layer_prefill(p, x, cfg: ModelConfig, positions, cache_len: int,
                       rules: ShardingRules | None = None):
    """Prefill: run attention AND return the populated cache (under a mesh
    this rank's block of it: its kv heads or every one, and with
    ``cache_seq="model"`` its W/|model| slots)."""
    dist_cache = _dist_cache(rules)
    whole_kv = _model_size(rules) > 1 and (dist_cache or not _kv_cut(rules))
    q, k, v = _qkv(p, x, cfg, positions, rotate=True, rules=rules,
                   whole_kv=whole_kv)
    o = kops.dense(_attention(q, k, v, cfg, True, rules), p["wo"])
    S = x.shape[1]
    W = cache_len
    if W >= S:
        pad = (0, 0, 0, 0, 0, W - S)        # zero rows after the prompt
        ck = torch.nn.functional.pad(k, pad)
        cv = torch.nn.functional.pad(v, pad)
    else:                                   # SWA ring buffer: last W tokens,
        roll = (S - W) % W                  # placed at slot pos % W
        ck = torch.roll(k[:, S - W:], shifts=roll, dims=1)
        cv = torch.roll(v[:, S - W:], shifts=roll, dims=1)
    if dist_cache:                          # this rank's slots
        axes, mesh = _model_axes(rules), rules.mesh
        ck = comm.split(ck, axes, mesh, dim=1)
        cv = comm.split(cv, axes, mesh, dim=1)
    return x + _psum_model(o, rules).to(x.dtype), AttnCache(ck, cv)


# -- cross attention ----------------------------------------------------------

def xattn_defs(cfg: ModelConfig) -> dict:
    """``attn_defs``' leaves; ``wk`` and ``wv`` read the context."""
    return attn_defs(cfg)


class XAttnCache(NamedTuple):
    k: torch.Tensor       # (B, T, Hkv, Dh) — projected context, fixed
    v: torch.Tensor


def _xkv_cut(rules) -> bool:
    """Whether a cross-attention cache's kv heads are cut over `model`."""
    return _mesh(rules) is not None and bool(rules.spec(("batch", "", "kv", ""))[2])


def xattn_prefill_cache(p, ctx, cfg: ModelConfig,
                        rules: ShardingRules | None = None) -> XAttnCache:
    """The context's keys and values, ctx (B, T, d) through ``wk`` and
    ``wv``: (B, T, Hkv, Dh) each, no rotation.  Under a mesh the rank's kv
    heads where the cache's ``kv`` rule cuts them, else every kv head (the
    rank's columns gathered over `model`)."""
    B, T, _ = ctx.shape
    hd = cfg.head_dim
    ctx = _into_model(ctx, rules)
    k = kops.dense(ctx, p["wk"])
    v = kops.dense(ctx, p["wv"])
    if _model_size(rules) > 1 and not _xkv_cut(rules):
        axes, mesh = _model_axes(rules), rules.mesh
        k = comm.all_gather(k, axes, mesh, dim=-1)
        v = comm.all_gather(v, axes, mesh, dim=-1)
    return XAttnCache(k.reshape(B, T, -1, hd), v.reshape(B, T, -1, hd))


def _xattn(p, x, ctx, cfg: ModelConfig, rules=None):
    """The sublayer and the context's K/V it made: rmsnorm, ``wq`` on x,
    ``wk`` and ``wv`` on ctx, attention non-causal over all T keys (with
    ``cfg.window`` as the reference's mask takes it), ``wo``; under a mesh
    on the rank's heads, a psum over `model` after ``wo``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    xn = _into_model(rmsnorm(x, p["norm"], cfg.norm_eps), rules)
    q = kops.dense(xn, p["wq"]).reshape(B, S, -1, hd)
    kv = xattn_prefill_cache(p, ctx, cfg, rules)
    o = kops.dense(_attention(q, *kv, cfg, causal=False, rules=rules), p["wo"])
    return x + _psum_model(o, rules).to(x.dtype), kv


def xattn_layer(p, x, ctx, cfg: ModelConfig,
                rules: ShardingRules | None = None) -> torch.Tensor:
    """Cross-attention to a context (encoder output / image embeddings),
    ctx (B, T, d), residual included (:func:`_xattn`).  No positional
    rotation."""
    return _xattn(p, x, ctx, cfg, rules)[0]


def xattn_cache_defs(cfg: ModelConfig, batch: int) -> XAttnCache:
    """The reference's shape, (B, n_ctx_tokens, Hkv, Dh): 0 context tokens
    for the encdec family, whose context length comes from the prompt
    (``lm.context_len``), so only ``prefill``'s cache holds its context."""
    shp = (batch, cfg.n_ctx_tokens, cfg.n_kv_heads, cfg.head_dim)
    return XAttnCache(PV(shp, cfg.dtype, ("batch", "", "kv", ""), "zeros"),
                      PV(shp, cfg.dtype, ("batch", "", "kv", ""), "zeros"))


def xattn_layer_prefill(p, x, ctx, cfg: ModelConfig,
                        rules: ShardingRules | None = None):
    """Prefill: the sublayer and its cache (under a mesh the rank's block
    of it).  The reference projects the context's K/V twice, in
    ``xattn_layer`` and again in ``xattn_prefill_cache``; both are the same
    product on the same inputs, so here they are made once and kept as the
    cache (4 products, not 6)."""
    return _xattn(p, x, ctx, cfg, rules)


def xattn_layer_decode(p, x, cache: XAttnCache, cfg: ModelConfig,
                       rules: ShardingRules | None = None):
    """One-token step against the cached context K/V, as the reference's:
    ``wq`` and ``wo`` through the matmul seam, the scores, softmax and
    weighted sum plain f32 einsums over every cached key.  The cache is
    not written; it is returned.  Under a mesh the rank's q heads read the
    kv heads they need of the cache (its block, or every kv head), and a
    psum over `model` follows ``wo``."""
    B, S1, _ = x.shape
    hd = cfg.head_dim
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = kops.dense(xn, p["wq"]).reshape(B, S1, -1, hd)
    H = q.shape[2]
    ck, cv = cache.k, cache.v
    if H != cfg.n_heads and ck.shape[2] == cfg.n_kv_heads:
        ck, cv = _select_kv(ck, cfg, rules), _select_kv(cv, cfg, rules)
    Hk = ck.shape[2]
    qg = q.reshape(B, S1, Hk, H // Hk, hd)
    s = torch.einsum("bqhgd,bthd->bhgqt", qg.to(torch.float32),
                     ck.to(torch.float32)) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqt,bthd->bqhgd", pr, cv.to(torch.float32))
    o = kops.dense(o.reshape(B, S1, H * hd).to(x.dtype), p["wo"])
    return x + _psum_model(o, rules).to(x.dtype), cache


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
                     cfg: ModelConfig, rules: ShardingRules | None = None
                     ) -> torch.Tensor:
    """Attention of a decode step (x (B, 1, d)) or of a prefill chunk
    (x (1, c, d)) against one layer's block pool pk/pv (NB, bt, Hkv, Dh).
    The step's K/V are written into the pool in place first, then every row
    attends through ``ops.paged_attention``, which reads the pool through a
    permuted view, never a copy.  Under a mesh the pool holds the rank's
    kv heads (``pool_defs``' ``kv`` cut) and its q heads attend to them; a
    psum over `model` follows ``wo``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    if _model_size(rules) > 1 and pk.shape[2] == cfg.n_kv_heads:
        raise NotImplementedError(
            "paged attention under a mesh runs on a pool whose kv heads are "
            "cut over `model`: give default_rules the kv heads (kv_heads=) "
            f"and a `model` size that divides {cfg.n_kv_heads}")
    Hkv = pk.shape[2]
    q, k, v = _qkv(p, x, cfg, pb.positions, rotate=True, rules=rules)
    G = q.shape[2] // Hkv
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
    o = kops.dense(o.reshape(B, S, Hkv * G * hd).to(x.dtype), p["wo"])
    return x + _psum_model(o, rules).to(x.dtype)


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


def mlp_layer(p, x, cfg: ModelConfig, rules: ShardingRules | None = None
              ) -> torch.Tensor:
    """SwiGLU, residual included; under a mesh on this rank's d_ff columns,
    one psum over `model` after ``wo``."""
    xn = _into_model(rmsnorm(x, p["norm"], cfg.norm_eps), rules)
    h = silu(kops.dense(xn, p["wg"])) * kops.dense(xn, p["wi"])
    o = kops.dense(h, p["wo"])
    return x + _psum_model(o, rules).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE: top-k routing, capacity dispatch, expert parallelism over `model`
# ---------------------------------------------------------------------------
#
# Off-mesh one device holds every expert: the reference's "local" mode.
# Under a mesh, ``moe_mode`` picks the reference's mode: "tp" (every expert
# on every rank, d_ff cut over `model`: ``moe_defs_tp``), "ep" (the experts
# cut over `model`, tokens replicated, the combine a psum) or "ep_a2a" (each
# rank dispatches its own sequence slice and the capacity buffers cross by
# all-to-all, one stage a topology level).  Capacity C counts every row of
# the call that a rank dispatches (a decode step's dead slots and a chunk's
# padding rows too), as in JAX.

def moe_defs(cfg: ModelConfig) -> dict:
    """The experts cut over `model` (EP)."""
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


def moe_defs_tp(cfg: ModelConfig) -> dict:
    """``moe_defs``' shapes with each expert's d_ff cut over `model`
    (``cfg.moe_tp``: fewer experts than ranks)."""
    d, dt = cfg.d_model, cfg.dtype
    E = cfg.n_experts
    ffe = cfg.d_ff_expert or cfg.d_ff
    return {
        "norm": PV((d,), torch.float32, ("",), "ones"),
        "router": PV((d, E), torch.float32, ("fsdp", "")),
        "wi": PV((E, d, ffe), dt, ("", "fsdp", "model")),
        "wg": PV((E, d, ffe), dt, ("", "fsdp", "model")),
        "wo": PV((E, ffe, d), dt, ("", "model", "fsdp")),
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


def expert_terms(xf: torch.Tensor, r: Routing, wi, wg, wo, e_base: int = 0):
    """Each expert's part of the combine, in expert order: its gate (N,)
    and its output gathered back to the rows (N, d) f32, zero where the
    row was not dispatched to it.  The rows of xf (N, d) f32 go to each
    expert's C-row buffer in the weight dtype (dropped and unchosen rows
    land on the discard row C), and its SwiGLU goes through the matmul
    seam.  The stacks wi, wg, wo hold experts ``e_base``, ``e_base`` + 1,
    ... (a rank's block under EP)."""
    N, d = xf.shape
    C = r.capacity
    xw = xf.to(wi.dtype)
    zero = torch.zeros((1, d), dtype=torch.float32, device=xf.device)
    # unbind, not wi[j]: the weights' gradient is one stack of the experts'
    # (an index's backward would scatter each into a zero (E, d, f) buffer)
    for j, (wi_j, wg_j, wo_j) in enumerate(zip(wi.unbind(0), wg.unbind(0),
                                               wo.unbind(0)), start=e_base):
        gate = torch.where(r.idx == j, r.gate, 0.0).sum(dim=-1)
        slot = r.slots[j]
        buf = torch.zeros((C + 1, d), dtype=wi.dtype, device=xf.device)
        buf[slot] = xw                  # its backward gathers the rows back
        buf = buf[:C]
        h = silu(kops.dense(buf, wg_j)) * kops.dense(buf, wi_j)
        y = kops.dense(h, wo_j).to(torch.float32)
        yield gate, torch.cat([y, zero])[slot]


def _dispatch_ffn(xf: torch.Tensor, r: Routing, wi, wg, wo,
                  e_base: int = 0) -> torch.Tensor:
    """Capacity-dispatch the N rows of xf (N, d) f32 to every expert of the
    stacks and combine: (N, d) f32, each expert's output added with its
    gate in expert order (no atomic accumulate: the same bits every run)."""
    out = torch.zeros_like(xf)
    for gate, y in expert_terms(xf, r, wi, wg, wo, e_base):
        out = out + gate[:, None] * y
    return out


def moe_mode(cfg: ModelConfig, rules: ShardingRules | None) -> str:
    """The reference's mode: "local" off-mesh (or without a `model`
    dimension), "tp" for ``cfg.moe_tp``, "ep_a2a" for ``moe_impl="a2a"``
    with the ``act_seq`` rule, else "ep"."""
    if not _model_axes(rules):
        return "local"
    if cfg.moe_tp:
        return "tp"
    msize = _model_size(rules)
    assert cfg.n_experts % msize == 0, \
        f"{cfg.name}: E={cfg.n_experts} not divisible by model={msize}; " \
        "set moe_tp=True"
    if cfg.moe_impl == "a2a" and rules.axis("act_seq"):
        return "ep_a2a"
    return "ep"


def moe_layer(p, x, cfg: ModelConfig, rules: ShardingRules | None = None,
              topology=None) -> torch.Tensor:
    """Top-k MoE over every row of x (B, S, d), residual included.  Under a
    mesh in :func:`moe_mode`'s mode; ``topology`` (a ``Topology`` whose
    level dimensions are the `model` dimensions) makes the ep_a2a exchange
    hierarchical (:func:`_a2a_stages`)."""
    B, S, d = x.shape
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    r = moe_route(p, xn, cfg)
    mode = moe_mode(cfg, rules)
    if mode == "local":
        y = _dispatch_ffn(xn.reshape(B * S, d).to(torch.float32), r,
                          p["wi"], p["wg"], p["wo"])
        return x + y.reshape(B, S, d).to(x.dtype)
    mesh, maxes, msize = rules.mesh, _model_axes(rules), _model_size(rules)
    if mode == "ep_a2a" and S % msize == 0:
        return x + _moe_ep_a2a(p, xn, r, cfg, rules, topology).to(x.dtype)
    # tp: every expert on every rank over its d_ff columns; ep: the rank's
    # E/|model| experts (tokens replicated, ids shifted by the rank's base)
    e_base = 0 if mode == "tp" else comm.axis_index(maxes, mesh) * (
        cfg.n_experts // msize)
    r = r._replace(gate=comm.copy_to_group(r.gate, maxes, mesh))
    xf = comm.copy_to_group(xn, maxes, mesh).reshape(B * S, d).to(torch.float32)
    y = _dispatch_ffn(xf, r, p["wi"], p["wg"], p["wo"], e_base)
    return x + comm.psum(y, maxes, mesh).reshape(B, S, d).to(x.dtype)


def _a2a_stages(rules: ShardingRules, topology) -> list:
    """The expert-dispatch exchange as (dimensions, size) stages, innermost
    first: one all-to-all over every `model` dimension at once (flat), or
    with a Topology whose level dimensions are the `model` dimensions one
    stage a level, the intra-level exchange first, so that each outer
    stage moves blocks already gathered within the level below.  Each
    schedule inverts itself stage by stage."""
    maxes = _model_axes(rules)
    if topology is None:
        return [(maxes, _model_size(rules))]
    from repro_torch.topology import mesh_levels
    levels = mesh_levels(topology, rules.mesh.shape)
    flat = tuple(a for axes, _ in levels for a in axes)
    if flat != maxes:
        raise ValueError(f"topology level axes {flat} must flatten to the "
                         f"model axes {maxes}")
    return list(reversed(levels))


def _a2a_dispatch(buf, stages, E_loc: int, mesh):
    """(E, C, d) expert-major capacity buffers -> (E_loc, C*|model|, d):
    every stage peels off the expert index's innermost remaining level
    digit and exchanges along that level's ring."""
    for axes, s in stages:
        ED, Ccur, d = buf.shape
        buf = buf.reshape(ED // (s * E_loc), s, E_loc, Ccur, d)
        buf = comm.all_to_all(buf, axes, mesh, split_axis=1, concat_axis=3)
        buf = buf.reshape(ED // s, Ccur * s, d)
    return buf


def _a2a_combine(y, stages, E_loc: int, mesh):
    """The exact inverse of :func:`_a2a_dispatch` (stages unwound outermost
    first), restoring (E, C, d) placement."""
    for axes, s in reversed(stages):
        ED, Ccur, d = y.shape
        y = y.reshape(ED // E_loc, 1, E_loc, Ccur, d)
        y = comm.all_to_all(y, axes, mesh, split_axis=3, concat_axis=1)
        y = y.reshape(ED * s, Ccur // s, d)
    return y


def _moe_ep_a2a(p, xn, r: Routing, cfg: ModelConfig, rules: ShardingRules,
                topology=None) -> torch.Tensor:
    """All-to-all expert parallelism: each rank dispatches its own sequence
    slice (the ``act_seq`` cut) into capacity buffers for all E experts,
    the buffers cross so that each rank holds its experts' rows from every
    source, its experts' SwiGLUs run through the matmul seam, the outputs
    cross back and each rank combines its rows; the slices are gathered
    back into the replicated residual.  Hierarchical (``topology``) and
    flat exchanges give the same rows in the same order, so the same bits."""
    mesh, maxes, msize = rules.mesh, _model_axes(rules), _model_size(rules)
    stages = _a2a_stages(rules, topology)
    B, S, d = xn.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    E_loc = E // msize
    wdt = p["wi"].dtype
    xs = comm.split(xn, maxes, mesh, dim=1)                   # (B, S/m, d)
    ti = comm.split(r.idx.reshape(B, S, k), maxes, mesh, dim=1).reshape(-1)
    tg = comm.split(r.gate.reshape(B, S, k), maxes, mesh, dim=1).reshape(-1)
    S_loc = xs.shape[1]
    N = B * S_loc
    C = moe_capacity(cfg, N)
    xf = xs.reshape(N, d).to(wdt)
    tok = torch.arange(N, device=xn.device).repeat_interleave(k)
    # rank of each (token, choice) within its expert (stable by token)
    order = torch.argsort(ti, stable=True)
    sorted_e = ti[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=xn.device))
    ranks = torch.empty_like(ti)
    ranks[order] = torch.arange(N * k, device=xn.device) - start[sorted_e]
    keep = ranks < C
    slot = torch.where(keep, ti * C + ranks, E * C)            # E*C: dropped
    buf = torch.zeros((E * C + 1, d), dtype=wdt, device=xn.device)
    buf[slot] = xf[tok]
    recv = _a2a_dispatch(buf[:-1].reshape(E, C, d), stages, E_loc, mesh)
    # this rank's experts, each a SwiGLU over its rows from every source
    y = torch.stack([
        kops.dense(silu(kops.dense(rj, wg_j)) * kops.dense(rj, wi_j), wo_j)
        for rj, wi_j, wg_j, wo_j in zip(recv.unbind(0), p["wi"].unbind(0),
                                        p["wg"].unbind(0), p["wo"].unbind(0))])
    back = _a2a_combine(y, stages, E_loc, mesh)                # (E, C, d)
    zero = torch.zeros((1, d), dtype=y.dtype, device=xn.device)
    flat = torch.cat([back.reshape(E * C, d), zero])
    w = torch.where(keep, tg.to(torch.float32), 0.0)[:, None]
    terms = (w * flat[slot].to(torch.float32)).reshape(N, k, d)
    out = torch.zeros((N, d), dtype=torch.float32, device=xn.device)
    for j in range(k):                      # the reference's scatter-add order
        out = out + terms[:, j]
    return comm.gather(out.reshape(B, S_loc, d), maxes, mesh, dim=1)


# ---------------------------------------------------------------------------
# Mamba2 (SSD, chunked): arXiv:2405.21060
# ---------------------------------------------------------------------------
#
# The reference's jnp, in plain torch on either device: the projections and
# norms go through the kernels, the causal conv, the SSD scan and the
# one-token recurrence are element-wise ops and einsums around them.
#
# Under a mesh the reference's table cuts ``in_proj``'s 2 di + 2N + H
# columns, ``conv_*``'s di + 2N channels and the conv cache's channels
# over `model` in contiguous blocks, which do not fall on head
# boundaries; ``A_log``, ``D``, ``dt_bias``, ``gnorm``, ``out_proj``'s rows
# and the SSM state are cut by head.  So a rank gathers ``in_proj``'s
# product and the conv's weights (and in decode its conv window) whole
# over `model`, runs the conv and the SSD on its heads' channels with the
# B and C that every head shares, and keeps its block of the conv window.

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


def _whole_over_model(t: torch.Tensor, n: int, dim: int, rules) -> torch.Tensor:
    """t, whose dimension ``dim`` of n is cut over `model` (or whole),
    whole on every rank (an ``all_gather``: its backward sums the ranks'
    gradients of each block)."""
    if t.shape[dim] == n:
        return t
    return comm.all_gather(t, _model_axes(rules), rules.mesh, dim=dim)


def _own_block(t: torch.Tensor, dim: int, rules) -> torch.Tensor:
    """This rank's block, over `model`, of a dimension t holds whole."""
    m = _model_size(rules)
    if m == 1:
        return t
    return t.chunk(m, dim=dim)[comm.axis_index(_model_axes(rules), rules.mesh)]


class MambaHeads(NamedTuple):
    """The SSD heads a rank runs: its first head, their number, and the
    conv channels they read (their x channels, then B and C), None where
    the rank runs every head."""
    h0: int
    n: int
    channels: torch.Tensor | None


def mamba_heads(p, cfg: ModelConfig, rules, device) -> MambaHeads:
    """The rank's heads, from the block of ``A_log`` it holds: every head
    where it holds them all (off-mesh, or a `model` of one rank), else the
    block at its place over `model`."""
    H, P, di, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.d_inner_ssm, cfg.ssm_state
    n = p["A_log"].shape[-1]
    if n == H:
        return MambaHeads(0, H, None)
    h0 = comm.axis_index(_model_axes(rules), rules.mesh) * n
    ch = torch.cat([torch.arange(h0 * P, (h0 + n) * P, device=device),
                    torch.arange(di, di + 2 * N, device=device)])
    return MambaHeads(h0, n, ch)


def _mamba_project(p, x, cfg: ModelConfig, hs: MambaHeads, rules=None):
    """The normed input through ``in_proj``: z (B, S, di) of the rank's
    heads, the conv's channels x|B|C (B, S, di + 2N) whole and dt (B, S,
    H) of the rank's heads, views of one product (gathered over `model`
    where ``in_proj``'s columns are cut)."""
    di, N, H, P = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    xn = _into_model(rmsnorm(x, p["norm"], cfg.norm_eps), rules)
    proj = _whole_over_model(kops.dense(xn, p["in_proj"]), 2 * di + 2 * N + H,
                             -1, rules)               # (B,S,2di+2N+H)
    z, xbc, dtv = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    if hs.channels is not None:
        z = z[..., hs.h0 * P:(hs.h0 + hs.n) * P]
        dtv = dtv[..., hs.h0:hs.h0 + hs.n]
    return z, xbc, dtv


def _conv_weights(p, cfg: ModelConfig, hs: MambaHeads, rules=None):
    """``conv_w`` (kc, ch) and ``conv_b`` (ch,) over the channels the
    rank's heads read (gathered whole over `model` first)."""
    c = cfg.d_inner_ssm + 2 * cfg.ssm_state
    w = _whole_over_model(p["conv_w"], c, -1, rules)
    b = _whole_over_model(p["conv_b"], c, 0, rules)
    if hs.channels is None:
        return w, b
    return w[:, hs.channels], b[hs.channels]


def _gated_norm(y: torch.Tensor, g: torch.Tensor, cfg: ModelConfig, rules
                ) -> torch.Tensor:
    """The rmsnorm over d_inner of a rank's block y (B, S, di/|model|) of
    channels: the sum of squares summed over `model` (forward and
    backward: each rank's result depends on every rank's block), the
    reference's formula around it."""
    axes, mesh = _model_axes(rules), rules.mesh
    yf = y.float()
    ss = torch.sum(yf * yf, dim=-1, keepdim=True)
    ss = comm.copy_to_group(comm.psum(ss, axes, mesh), axes, mesh)
    ms = ss / cfg.d_inner_ssm
    return (yf * torch.rsqrt(ms + cfg.norm_eps) * g.float()).to(y.dtype)


def _mamba_out(p, x, y, z, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """The gated norm of y (B, S, di of the rank's heads) and
    ``out_proj``, residual added (a psum over `model` where the heads are
    cut)."""
    g = y.to(x.dtype) * silu(z)
    if p["gnorm"].shape[0] == cfg.d_inner_ssm:
        return x + kops.dense(rmsnorm(g, p["gnorm"], cfg.norm_eps),
                              p["out_proj"]).to(x.dtype)
    o = kops.dense(_gated_norm(g, p["gnorm"], cfg, rules), p["out_proj"])
    return x + _psum_model(o, rules).to(x.dtype)


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


def mamba_mix(p, x, cfg: ModelConfig, conv_state=None, rules=None) -> MambaMix:
    """``in_proj``, the depthwise causal conv over (x, B, C) (the
    reference's sum of kc shifted products, after ``conv_state`` (B, kc-1,
    di+2N, every channel) or zeros), its silu, and dt's softplus; under a
    mesh on the rank's heads (``xbc_p`` keeps every channel)."""
    B, S, _ = x.shape
    N, kc = cfg.ssm_state, cfg.ssm_conv
    hs = mamba_heads(p, cfg, rules, x.device)
    z, xbc, dtv = _mamba_project(p, x, cfg, hs, rules)
    pad = (torch.zeros((B, kc - 1, xbc.shape[-1]), dtype=xbc.dtype,
                       device=x.device) if conv_state is None else conv_state)
    xbc_p = torch.cat([pad, xbc], dim=1)
    mine = xbc_p if hs.channels is None else xbc_p[..., hs.channels]
    w, b = _conv_weights(p, cfg, hs, rules)
    conv = sum(mine[:, i:i + S] * w[i][None, None] for i in range(kc)) + b[None, None]
    xc, Bm, Cm = torch.split(silu(conv), [hs.n * cfg.ssm_head_dim, N, N], dim=-1)
    return MambaMix(z, xbc_p,
                    xc.reshape(B, S, hs.n, cfg.ssm_head_dim).to(torch.float32),
                    softplus(dtv.to(torch.float32) + p["dt_bias"][None, None]),
                    Bm.to(torch.float32), Cm.to(torch.float32),
                    -torch.exp(p["A_log"]))


def mamba_layer(p, x, cfg: ModelConfig, conv_state=None, ssm_state=None,
                return_state: bool = False, rules: ShardingRules | None = None):
    """Train/prefill Mamba2 block over the whole sequence (chunked SSD),
    residual included.  ``conv_state`` (B, kc-1, di+2N) and ``ssm_state``
    (B, H, P, N) f32 continue a sequence; ``return_state`` also returns
    the (conv, ssm) states after it.  Under a mesh ``conv_state`` holds
    every channel and ``ssm_state`` the rank's heads, and the states
    returned are the rank's blocks of the cache (``mamba_cache_defs``)."""
    B, S, _ = x.shape
    kc = cfg.ssm_conv
    m = mamba_mix(p, x, cfg, conv_state, rules)
    y, s_final = _ssd_chunked(m.xh, m.dt, m.Bm, m.Cm, m.A, cfg.ssm_chunk,
                              ssm_state)
    y = y + p["D"][None, None, :, None] * m.xh        # skip
    res = _mamba_out(p, x, y.reshape(B, S, -1), m.z, cfg, rules)
    if return_state:
        new_conv = m.xbc_p[:, S:S + kc - 1] if kc > 1 else m.xbc_p[:, :0]
        if m.xh.shape[2] != cfg.n_ssm_heads:
            new_conv = _own_block(new_conv, -1, rules)
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


def mamba_layer_decode(p, x, cache: MambaCache, cfg: ModelConfig,
                       rules: ShardingRules | None = None):
    """One-token recurrent step, x (B, 1, d): state <- exp(dt A) state +
    dt B x, y = C . state.  Writes the new conv window and state into
    ``cache`` in place and returns (x out, cache).  Under a mesh the cache
    is the rank's block: its conv window is gathered whole over `model`,
    the step runs the rank's heads, and the rank keeps its block of the
    new window."""
    B = x.shape[0]
    N, kc = cfg.ssm_state, cfg.ssm_conv
    hs = mamba_heads(p, cfg, rules, x.device)
    z, xbc, dtv = _mamba_project(p, x, cfg, hs, rules)
    conv_state = _whole_over_model(cache.conv, cfg.d_inner_ssm + 2 * N, -1, rules)
    window = torch.cat([conv_state, xbc], dim=1)              # (B, kc, ch)
    w, b = _conv_weights(p, cfg, hs, rules)
    mine = window if hs.channels is None else window[..., hs.channels]
    conv = torch.einsum("bkc,kc->bc", mine, w) + b
    xc, Bm, Cm = torch.split(silu(conv)[:, None, :],
                             [hs.n * cfg.ssm_head_dim, N, N], dim=-1)
    xh = xc.reshape(B, hs.n, cfg.ssm_head_dim).to(torch.float32)
    dtb = softplus(dtv.to(torch.float32)[:, 0] + p["dt_bias"][None])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dtb * A[None])                             # (B,H)
    Bv = Bm[:, 0].to(torch.float32)                           # (B,N)
    Cv = Cm[:, 0].to(torch.float32)
    upd = torch.einsum("bh,bhp,bn->bhpn", dtb, xh, Bv)
    state = cache.state * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cv) + p["D"][None, :, None] * xh
    out = _mamba_out(p, x, y.reshape(B, 1, -1), z, cfg, rules)
    if kc > 1:
        new = window[:, 1:]
        cache.conv.copy_(new if cache.conv.shape == new.shape
                         else _own_block(new, -1, rules))
    cache.state.copy_(state)
    return out, cache
